"""repro_torch.configs against repro.configs: the port keeps its own copy
of the architecture configs, equal to JAX's field for field."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro_torch.configs import base as tbase

LM_ARCHS = [a for a in jbase.ARCH_IDS if a != "gnn_sage"]


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_arch_ids_and_shapes_equal():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_config_equal_field_for_field(arch):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert _fields(t) == _fields(j)
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.attention_free == j.attention_free
    assert t.n_params() == j.n_params()
    assert t.active_params() == j.active_params()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_equal_field_for_field(arch):
    j, t = jbase.reduced(jbase.get_config(arch)), tbase.reduced(tbase.get_config(arch))
    assert _fields(t) == _fields(j)
    assert t.n_params() == j.n_params()
    assert t.active_params() == j.active_params()


def test_get_config_normalises_names_as_jax():
    for name in ("qwen3-14b", "qwen2.5_32b", "mamba2-2.7b"):
        assert _fields(tbase.get_config(name)) == _fields(jbase.get_config(name))
    with pytest.raises(ModuleNotFoundError):
        tbase.get_config("no_such_arch")


def test_gnn_model_reads_gnn_sage():
    from repro_torch.models.gnn import SAGE, SAGE_CONFIG

    assert SAGE_CONFIG is tbase.get_config("gnn_sage")
    model = SAGE(8, 3, device="cpu")
    assert len(model.w_agg) == SAGE_CONFIG.n_layers == 3
    assert model.w_agg[0].shape[1] == SAGE_CONFIG.d_model == 256
