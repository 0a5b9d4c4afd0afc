"""bench/work/lm.py against hand counts and torch's FLOP counter over
the plain reference's step at a small size."""
import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.gen import causal_band
from bench.models import mellum2 as fam
from bench.reference import mellum2 as ref
from bench.work import lm as work

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "sliding_window": 8}


def _config():
    return dict(json.loads((ROOT / "bench" / "configs" / "mellum2-12b.json").read_text()), **TINY)


def test_band_nnz_by_hand_and_against_the_generator():
    assert work.band_nnz(5, 3) == 1 + 2 + 3 + 3 + 3
    assert work.band_nnz(2, 8) == 3
    assert work.band_nnz(8192, 1024) == 7_864_832
    assert causal_band.band(40, 6, 2, CPU).nnz == 2 * work.band_nnz(40, 6)


def test_dense_step_flops_match_the_counted_matrix_products():
    """Every product with a weight matrix is a 2-D mm in the reference
    (projections, router, experts, unembedding); attention's are bmm.
    Forward and backward: the counter's mm FLOPs are the work's dense
    FLOPs exactly."""
    config = _config()
    seq = 24
    batch = fam.next_batch(config, {"seq_len": seq, "batch": 1}, fam.token_generator(5, CPU))
    leaves = {n: t.requires_grad_(True) for n, t in fam.weights(config, 5, CPU).items()}
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss_of(leaves, batch, config)
        torch.autograd.grad(loss, list(leaves.values()))
    counts = counter.get_flop_counts()["Global"]
    mm = sum(v for op, v in counts.items() if "aten.mm" in str(op))
    assert mm == work.dense_step_flops(config, seq)


def test_attention_flops_count_the_pattern_not_the_padding():
    config = _config()
    kinds = work.layer_kinds(config)
    assert kinds == ["sliding_attention"] * 3 + ["full_attention"]
    entries = 3 * work.band_nnz(64, 8) + 64 * 65 // 2
    assert work.attention_step_flops(config, 64, 2) == 3 * 4.0 * entries * 16 * 4 * 2
    assert work.step_flops(config, 64, 2) == (work.dense_step_flops(config, 128)
                                              + work.attention_step_flops(config, 64, 2))
