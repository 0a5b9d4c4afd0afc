"""The port's sharding rules (repro_torch.distributed.sharding,
launch/mesh.py, models/moe.py moe_param_specs) against the JAX package's,
on stand-in meshes: every LM config at full width and at reduced(), on
the production meshes (16, 16) and (2, 16, 16) and on (1, 2, 2) and
(2, 2, 2). JAX's specs come from jax.eval_shape pytrees; the port's
full-width shapes from its initialisers on the meta device (nothing is
allocated). A port layer's spec is JAX's stacked spec without its
leading layer entry. Specs are compared exactly. No process starts."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api, moe, transformer

torch.set_num_threads(1)

LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x2x2": {"pod": 1, "data": 2, "model": 2},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
}
CACHE_LEN = 512  # divides every mesh's ('data', 'model') product


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _cfgs(arch, full):
    if full:
        return jax_get_config(arch), get_config(arch)
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch, full):
    jcfg, _ = _cfgs(arch, full)
    return jax.eval_shape(lambda: japi.init_model(jcfg, jax.random.PRNGKey(0), jnp.float32))


@functools.lru_cache(maxsize=None)
def _port_model(arch, full):
    _, cfg = _cfgs(arch, full)
    return api.init_model(cfg, 0, torch.float32, device="meta")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch_sizes(mesh):
    return (1, 3, 8, 512)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_jax(arch, full, mesh_id):
    """Every parameter's spec equals JAX's for its pytree leaf (stacked
    leaves without the layer entry), shapes included."""
    mesh = FakeMesh(MESHES[mesh_id])
    jcfg, cfg = _cfgs(arch, full)
    jshapes = _jax_param_shapes(arch, full)
    jspecs = jsh.param_specs(jshapes, jcfg, mesh)
    model = _port_model(arch, full)
    got = tsh.param_specs(model, cfg, mesh)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path, idx = api.jax_path(cfg, name)
        want = tuple(_at(jspecs, path))
        shape = tuple(_at(jshapes, path).shape)
        if idx is not None:
            want, shape = want[1:], shape[1:]
        assert shape == tuple(model.get_parameter(name).shape), name
        assert spec == want, (name, spec, want)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, full, mesh_id):
    """batch_specs for several batch sizes (rows over the batch axes, or
    context parallel when they do not divide) and cache_specs on the
    port's flat cache layout equal JAX's."""
    mesh = FakeMesh(MESHES[mesh_id])
    jcfg, cfg = _cfgs(arch, full)
    for b in _batch_sizes(mesh):
        s = 64
        batch = {"tokens": np.zeros((b, s), np.int32), "labels": np.zeros((b, s), np.int32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = np.zeros((b, cfg.vlm_patches, cfg.d_model), np.float32)
        if cfg.family == "audio":
            batch["frames"] = np.zeros((b, cfg.enc_dec.enc_seq, cfg.d_model), np.float32)
        want = {k: tuple(v) for k, v in jsh.batch_specs(batch, jcfg, mesh).items()}
        assert tsh.batch_specs(batch, cfg, mesh) == want
        assert tsh.batch_axes_for(b, mesh) == jsh.batch_axes_for(b, mesh)

        jcache = jax.eval_shape(lambda: japi.init_cache(jcfg, b, CACHE_LEN, jnp.float32))
        jspecs = jsh.cache_specs(jcache, jcfg, mesh, b)
        cache = api.init_cache(cfg, b, CACHE_LEN, torch.float32, device="meta")
        got = tsh.cache_specs(cache, cfg, mesh, b)
        if cfg.family == "audio":
            assert got == {k: tuple(v) for k, v in jspecs.items()}
            continue
        head, unit, n_tail = transformer._stack_plan(cfg)
        want_layers = [{k: tuple(v) for k, v in h.items()} for h in jspecs["head"]]
        for _ in range(n_tail):
            units = [jspecs["tail"]] if len(unit) == 1 else [
                jspecs["tail"][f"sub_{i}"] for i in range(len(unit))]
            want_layers += [{k: tuple(v)[1:] for k, v in u.items()} for u in units]
        assert got == {"layers": want_layers}


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model"), (51865, 768), (None, "model")),  # whisper's vocab
    (("data", "model"), (8192, 1024), ("data", "model")),
    ((("pod", "data"), None), (1, 5), (None, None)),  # a tuple axis that does not divide
    ((("pod", "data"), None), (64, 5), (("pod", "data"), None)),
    (("model",), (32, 4, 4), ("model", None, None)),  # padded to the rank
    ((None, ("data", "model")), (2, 48), (None, None)),  # 48 % 256
])
def test_sanitize_matches_jax_single_device_twin(spec, shape, want):
    """The cases of test_distributed.py::test_sharding_sanitize_single_device
    and more, on the (2, 16, 16) stand-in mesh."""
    mesh = FakeMesh(MESHES["2x16x16"])
    assert tsh.sanitize(spec, shape, mesh) == want
    assert tuple(jsh.sanitize(P(*spec), shape, mesh)) == want


def _names(placements):
    return [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "") for p in placements]


@pytest.mark.parametrize("spec,want", [
    ((None, None), ["Replicate", "Replicate", "Replicate"]),
    (("data", "model"), ["Replicate", "Shard(0)", "Shard(1)"]),
    (("model", "data"), ["Replicate", "Shard(1)", "Shard(0)"]),
    ((None, ("data", "model"), None, None), ["Replicate", "Shard(1)", "Shard(1)"]),
    ((("pod", "data"), None), ["Shard(0)", "Shard(0)", "Replicate"]),
    (("data", None, "model"), ["Replicate", "Shard(0)", "Shard(2)"]),
])
def test_to_placements(spec, want):
    """One placement per mesh dimension, in mesh order; axes sharing a
    dimension (the context-parallel cache) shard it on each of them."""
    mesh = FakeMesh(MESHES["2x2x2"])
    assert _names(tsh.to_placements(spec, mesh)) == want


def test_to_placements_rejects_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh order"):
        tsh.to_placements((("model", "data"), None), FakeMesh(MESHES["2x2x2"]))


def test_local_block_nests_the_first_axis_major():
    """('data', 'model') on one dimension: the block at (d, m) is block
    d * n_model + m, as JAX lays out a dimension sharded over two axes."""
    mesh = FakeMesh(MESHES["1x2x2"])
    t = torch.arange(8 * 3).reshape(8, 3)
    for d in range(2):
        for m in range(2):
            blk = tsh.local_block(t, (("data", "model"), None), mesh, {"pod": 0, "data": d,
                                                                       "model": m})
            i = d * 2 + m
            assert torch.equal(blk, t[2 * i:2 * i + 2])


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "deepseek_v2_lite_16b", "qwen3_14b"])
def test_moe_param_specs_equal_jax(arch):
    jcfg, cfg = _cfgs(arch, True)
    want = jax.tree.map(tuple, jmoe.moe_param_specs(jcfg, "data", "model"),
                        is_leaf=lambda x: isinstance(x, P))
    assert moe.moe_param_specs(cfg) == want


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_storage_specs_slice_only_the_experts(mesh_id):
    """What the step factories keep per rank: the experts by
    moe_param_specs where the EP path runs, everything else whole."""
    mesh = FakeMesh(MESHES[mesh_id])
    cfg = reduced(get_config("deepseek_v2_lite_16b"))
    model = api.init_model(cfg, 0, torch.float32, device="meta")
    specs = tsh.storage_specs(model, cfg, mesh)
    ep = moe.ep_active(cfg, mesh)
    assert ep == (mesh.shape["data"] > 1 and cfg.moe.n_experts % mesh.shape["data"] == 0)
    for name, spec in specs.items():
        leaf = name.rsplit(".", 1)[-1]
        expert = ".ffn." in name and ".shared." not in name and spec and len(spec) == 3
        if ep and expert:
            assert spec == moe.moe_param_specs(cfg)[leaf], name
        else:
            assert all(e is None for e in spec), name
    assert bool(tsh.sharded_names(specs)) == ep


def test_mesh_shapes_equal_jax():
    assert tmesh.production_shape() == {"data": 16, "model": 16}
    assert tmesh.production_shape(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.host_shape(4) == {"pod": 1, "data": 4, "model": 1}


def test_mesh_shape_reads_a_device_mesh_and_a_dict():
    class DM:
        mesh_dim_names = ("pod", "data", "model")
        shape = (1, 2, 2)

    assert tsh.mesh_shape(DM()) == {"pod": 1, "data": 2, "model": 2}
    assert tsh.mesh_shape(FakeMesh({"data": 16})) == {"data": 16}
