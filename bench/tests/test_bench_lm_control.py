"""The LM cell's correctness check at a small size on the CPU: the
program passes; the reference in TF32 (every product), the reference in
TF32 in the window layers' q·k and P·V alone, and whole runs with a
fault planted under the timed path (half of the tokens left out of the
loss; a step that leaves the state unchanged; a router that takes the
wrong experts) come out not correct.

The cell's own limits were read on the card at its size (8,192 tokens,
the published widths). At this size (32 tokens, d 64) the program reads
at most 8e-8 / 5.5e-7 / 4.2e-6 on the CPU and each control at least
1.7e-5 / 3.7e-4 / 2.7e-4 (loss / grad / update, three seeds), so the
runs here are judged by `TINY_LIMITS`, read at this size; each control
fails them and fails the cell's own limits."""
import time
from pathlib import Path

import pytest
import torch

from bench import check, harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "mellum2-12b.train"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "sliding_window": 8}
TINY_LIMITS = {"loss_gap": 2e-6, "grad_gap": 1e-5, "update_gap": 5e-5, "routing_gap": 1e-5}


def _cell():
    cell = harness.load_cell(ROOT, CELL)
    cell.config = dict(cell.config, **TINY)
    cell.mix = dict(cell.mix, seq_len=32)
    return cell


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1, 77])
def test_tf32_controls_fail_and_program_passes(seed, tmp_path):
    cell = _cell()
    gen = harness.load_by_path(harness.BENCH / "traffic" / f"{cell.mix['generator']}.py")
    prog = gen.build(cell.config, seed, CPU, tmp_path)
    rec = gen.first_steps(prog, cell.mix)
    gen.free(prog)
    want = gen.reference_steps(cell.config, cell.mix, prog.inputs)
    assert check.judge(gen.numbers(prog.inputs, rec, want), TINY_LIMITS)
    for precision in ("tf32", "tf32_sparse"):
        control = gen.reference_steps(cell.config, cell.mix, prog.inputs, precision)
        numbers = gen.numbers(prog.inputs, control, want)
        assert not check.judge(numbers, cell.limits), (precision, numbers)
        assert not check.judge(numbers, TINY_LIMITS), (precision, numbers)
    half = gen.reference_steps(cell.config, cell.mix, prog.inputs, half_batch=True)
    assert not check.judge(gen.numbers(prog.inputs, half, want), cell.limits)


def _no_update(monkeypatch):
    from repro_torch.train import step

    def frozen(cfg, grads, params, state, reduce_sq=None):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(step, "adamw_update", frozen)


def _half_tokens(monkeypatch):
    from repro_torch.train import step

    real = step._labels

    def half(batch, dev):
        lab = real(batch, dev).clone()
        lab[:, lab.shape[1] // 2:] = -1
        return lab

    monkeypatch.setattr(step, "_labels", half)


def _wrong_experts(monkeypatch):
    """The router takes the k experts of least probability."""
    from repro_torch.models import moe

    real = moe._route

    def route(t, router, top_k):
        gates, _ = real(t, router, top_k)
        ids = torch.topk(-(t.float() @ router), top_k, dim=-1).indices
        return gates, ids

    monkeypatch.setattr(moe, "_route", route)


@pytest.mark.parametrize("fault", [None, _no_update, _half_tokens, _wrong_experts],
                         ids=["clean", "no_update", "half_tokens", "wrong_experts"])
def test_fault_turns_correct_false(fault, tmp_path, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    cell = _cell()
    cell.limits = TINY_LIMITS
    result = harness.run_cell(cell, 2 ** 33 + 9, 0.3, False, CPU, time.perf_counter(), tmp_path)
    assert result["correct"] is (fault is None), result["checks"]
    if fault is _wrong_experts:
        assert result["checks"]["routing_gap"]["value"] > 0.1
    assert all(c["value"] is not None for c in result["checks"].values())
