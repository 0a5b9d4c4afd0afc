"""The port's split of the layer stack (`models/transformer.py`
`_stack_plan`) against the JAX package's, for every full-size decoder
config: the twin of test_perf_variants.py's
``test_hybrid_period_scan_structure``. The port runs the layers as one
flat list, but its remat units, cache order and carry-over of JAX's
`head_blocks` / `tail_blocks` all read this plan, so it must be JAX's."""
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.models.transformer import _stack_plan as jx_stack_plan
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.transformer import _stack_plan, layer_kinds

torch.set_num_threads(1)  # see test_torch_spmm.py

DECODERS = [a for a in ARCH_IDS if a not in ("gnn_sage", "whisper_small")]


@pytest.mark.parametrize("arch", DECODERS)
def test_stack_plan_equals_jax(arch):
    cfg = get_config(arch)
    head, unit, reps = _stack_plan(cfg)
    assert (list(head), tuple(unit), reps) == tuple(jx_stack_plan(jx_get_config(arch)))
    assert list(head) + list(unit) * reps == layer_kinds(cfg)


def test_hybrid_period_scan_structure():
    """26-layer pattern (rglru, rglru, attn): the head keeps the
    remainder, the unit is one whole period (as in JAX's test)."""
    head, unit, reps = _stack_plan(get_config("recurrentgemma_2b"))
    assert len(head) == 26 % 3 == 2
    assert head == ["rglru", "rglru"]
    assert unit == ("attn", "rglru", "rglru")
    assert reps == 8
    head_d, unit_d, reps_d = _stack_plan(get_config("qwen3_14b"))
    assert head_d == [] and unit_d == ("attn_mlp",) and reps_d == 40
