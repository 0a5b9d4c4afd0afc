"""repro_torch's dry run (`launch/{specs,dryrun_lib,dryrun,report}.py`) on
the CPU, held against the JAX package's.

- The meta specs: every LM config x shape, leaf for leaf, the same
  shapes and dtypes as JAX's `ShapeDtypeStruct`s (weights and moments
  through `models.api.jax_path`, caches layer by layer); token ids are
  int64 where JAX's are int32 (a recorded departure).
- The meta-only MoE group sizes: real tensors take the bincount path
  unchanged (bit-equal outputs), meta tensors a static even split; the
  EP dispatch's one path (overflow count, send buffers) equals the old
  bincount and boolean-mask copies on real tensors, gradients too.
- `run_cell` in a subprocess (a fake process group is process-global)
  on a 256-rank and a 512-rank cell: ``ok``, the device count, and
  ``model_flops_total`` equal to JAX's formula.
- Both packages' `report.main` on one synthetic results file print the
  same table rows, but for the advice column and the heading, which
  name the hardware.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JX_SHAPES
from repro.configs.base import get_config as jx_get_config
from repro.launch import report as jx_report
from repro.launch import roofline as jx_roofline
from repro.launch import specs as jx_specs
from repro.models import transformer as jx_transformer
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import report, roofline, specs
from repro_torch.launch.dryrun_lib import LM_ARCHS, cell_key
from repro_torch.models import api, moe
from repro_torch.models.modules import make_generator

torch.set_num_threads(1)  # see test_torch_spmm.py

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
TIMEOUT_S = 300
CELLS = (("qwen3_14b", "decode_32k", False), ("qwen3_moe_235b_a22b", "train_4k", True))


# ---------------------------------------------------------------- specs
def _key(p):
    return getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))


def _sd(leaf):
    return tuple(leaf.shape), str(jnp.dtype(leaf.dtype))


def _jax_leaves(tree):
    return {tuple(_key(p) for p in path): _sd(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_dtype(t):
    name = str(t.dtype).replace("torch.", "")
    return "int32" if name == "int64" else name  # the recorded token-id departure


def _port_tree(cfg, tensors):
    """JAX path -> (shape, dtype) of tensors keyed by parameter name, the
    layers of a stacked leaf counted along a leading axis."""
    groups = {}
    for name, t in tensors.items():
        path, idx = api.jax_path(cfg, name)
        groups.setdefault(path, {})[idx] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    out = {}
    for path, by in groups.items():
        if None in by:
            out[path] = by[None]
        else:
            shape, dt = by[0]
            assert all(by[i] == (shape, dt) for i in range(len(by)))
            out[path] = ((len(by),) + shape, dt)
    return out


def _jax_cache_layers(cfg, jc):
    """JAX's cache (head list, stacked tail) as one {name: (shape, dtype)}
    per layer, in the port's order."""
    if cfg.family == "audio":
        return {k: _sd(v) for k, v in jc.items() if k != "pos"}
    _, unit, reps = jx_transformer._stack_plan(cfg)
    out = [{k: _sd(v) for k, v in c.items() if k != "pos"} for c in jc["head"]]
    for _ in range(reps):
        for i in range(len(unit)):
            src = jc["tail"] if len(unit) == 1 else jc["tail"][f"sub_{i}"]
            out.append({k: (tuple(v.shape[1:]), str(jnp.dtype(v.dtype)))
                        for k, v in src.items() if k != "pos"})
    return out


def _port_cache_layers(cfg, pc):
    def one(c):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in c.items() if k != "pos"}

    return one(pc) if cfg.family == "audio" else [one(c) for c in pc["layers"]]


@pytest.fixture(scope="module")
def jax_state():
    """JAX's state specs of every LM config (built once)."""
    return {a: jx_specs.state_specs(jx_get_config(a)) for a in LM_ARCHS}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_equal_jax_leaf_for_leaf(jax_state, arch, shape_name):
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    shape, jshape = SHAPES[shape_name], JX_SHAPES[shape_name]
    js = jax_state[arch]
    st = specs.state_specs(cfg)
    assert all(t.is_meta for t in st.params.parameters())
    assert _port_tree(cfg, dict(st.params.named_parameters())) == _jax_leaves(js.params)
    assert _port_tree(cfg, st.opt.m) == _jax_leaves(js.opt.m)
    assert _port_tree(cfg, st.opt.v) == _jax_leaves(js.opt.v)
    assert (tuple(st.step.shape), str(st.step.dtype)) == ((), "torch.int32") == \
        (js.step.shape, "torch." + str(js.step.dtype))
    assert (tuple(st.opt.count.shape), _port_dtype(st.opt.count)) == _sd(js.opt.count)
    params = specs.params_specs(cfg)
    assert _port_tree(cfg, dict(params.named_parameters())) == \
        _jax_leaves(jx_specs.params_specs(jcfg))
    if shape.kind == "train":
        ours, theirs = specs.train_batch_specs(cfg, shape), jx_specs.train_batch_specs(jcfg, jshape)
    elif shape.kind == "prefill":
        ours, theirs = specs.prefill_batch_specs(cfg, shape), \
            jx_specs.prefill_batch_specs(jcfg, jshape)
    else:
        ours = {"tokens": specs.decode_token_specs(shape.global_batch)}
        theirs = {"tokens": jx_specs.decode_token_specs(jshape.global_batch)}
    assert {k: (tuple(v.shape), _port_dtype(v)) for k, v in ours.items()} == \
        {k: _sd(v) for k, v in theirs.items()}
    assert all(v.dtype == torch.int64 for k, v in ours.items() if k in ("tokens", "labels"))
    if shape.kind != "train":
        pc = specs.cache_specs_abstract(cfg, shape.global_batch, shape.seq_len)
        jc = jx_specs.cache_specs_abstract(jcfg, jshape.global_batch, jshape.seq_len)
        assert _port_cache_layers(cfg, pc) == _jax_cache_layers(jcfg, jc)


# ------------------------------------------------------- MoE on meta
def _moe_inputs(arch, device):
    from repro_torch.configs import reduced

    cfg = reduced(get_config(arch))
    gen = make_generator(0, device)
    params = moe.init_moe(gen, cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(device)
    return cfg, params, x


def _bincount_ffn(params, x, cfg):
    """moe_ffn_ref's sorted_ragged branch as it was before the meta
    stand-in: the group sizes a bincount tensor, read with .tolist()
    where the bounds are built."""
    mo = cfg.moe
    t = x.reshape(-1, x.shape[-1])
    gates, ids = moe._route(t, params.router, mo.top_k)
    eflat = ids.reshape(-1)
    order = torch.argsort(eflat, stable=True)
    tok = order // mo.top_k
    xs = t[tok]
    gs = torch.bincount(eflat, minlength=mo.n_experts)
    bounds = [0]
    for n in gs.tolist():
        bounds.append(bounds[-1] + n)
    h = torch.nn.functional.silu(moe._ragged_dot(xs, params.w_gate, bounds).float())
    u = moe._ragged_dot(xs, params.w_up, bounds).float()
    y = moe._ragged_dot((h * u).to(xs.dtype), params.w_down, bounds)
    contrib = y.float() * gates.reshape(-1)[order][:, None]
    out = torch.zeros(t.shape, dtype=torch.float32).index_add_(0, tok, contrib)
    out = out.reshape(x.shape).to(x.dtype)
    if mo.n_shared:
        out = out + moe.swiglu(params.shared, x)
    return out


@pytest.mark.parametrize("arch", ("qwen3_moe_235b_a22b", "deepseek_v2_lite_16b"))
def test_moe_meta_path_leaves_real_outputs_bit_equal(arch):
    cfg, params, x = _moe_inputs(arch, "cpu")
    with torch.no_grad():
        got = moe.moe_ffn_ref(params, x, cfg, variant="sorted_ragged")
        want = _bincount_ffn(params, x, cfg)
    assert torch.equal(got, want)
    ids = torch.tensor([3, 0, 3, 5, 5, 5, 1])  # 5 is a pad id past the groups
    assert moe._group_sizes(ids, 5, 99) == [1, 1, 0, 2, 0]


@pytest.mark.parametrize("cap", (3, 5, 40))  # destinations overflow at 3 and 5
def test_ep_dispatch_buffers_equal_the_bincount_and_masked_copies(cap):
    """The EP dispatch on real tensors, bit for bit and with its gradient,
    against what it was before it ran on meta: a bincount for the
    overflow and a copy of only the written rows."""
    rng = np.random.default_rng(cap)
    n_data, e_loc, k, d = 4, 2, 2, 6
    eflat = torch.from_numpy(rng.integers(0, n_data * e_loc, 16 * k))
    order, e_sorted, dest, slot, keep, written = moe.dispatch_plan(eflat, e_loc, n_data, cap)
    overflow = torch.bincount(dest, minlength=n_data) > cap
    assert torch.equal(written, keep & ~(overflow[dest] & (slot == cap - 1)))
    assert bool(overflow.any()) == (cap < 40)
    tok_sorted, cell = order // k, dest * cap + slot
    x, grads = rng.standard_normal((16, d)).astype(np.float32), []
    for new in (True, False):
        t = torch.from_numpy(x.copy()).requires_grad_()
        if new:
            sx, se = moe.send_buffers(t, tok_sorted, e_sorted % e_loc, cell, written,
                                      n_data * cap, e_loc)
        else:
            sx = t.new_zeros((n_data * cap, d)).index_copy(0, cell[written],
                                                           t[tok_sorted[written]])
            se = torch.full((n_data * cap,), e_loc, dtype=torch.int32).index_copy(
                0, cell[written], (e_sorted[written] % e_loc).to(torch.int32))
        (sx * torch.arange(sx.numel()).reshape(sx.shape)).sum().backward()
        grads.append((sx.detach(), se, t.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_moe_meta_group_sizes_split_the_routed_rows_evenly():
    ids = torch.empty(10, dtype=torch.long, device="meta")
    assert moe._group_sizes(ids, 4, 10) == [3, 3, 2, 2]
    assert sum(moe._group_sizes(ids, 8, 10)) == 10
    cfg, params, x = _moe_inputs("qwen3_moe_235b_a22b", "meta")
    out = moe.moe_ffn_ref(params, x, cfg, variant="sorted_ragged")
    assert out.is_meta and out.shape == x.shape


def test_meta_is_an_explicit_request_and_none_still_means_the_card(monkeypatch):
    from repro_torch.core.features import resolve_device
    from repro_torch.distributed import collectives

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert collectives.rank_device("meta") == torch.device("meta")
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.rank_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)


# ----------------------------------------------------------- run_cell
@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun_lib as d\n"
            f"cells = {CELLS!r}\n"
            "res = {d.cell_key(a, s, m): d.run_cell(a, s, m) for a, s, m in cells}\n"
            "d.finish()\n"
            "json.dump(res, open(sys.argv[1], 'w'))\n")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(["nice", "-n", "10", sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch, shape_name, multi", CELLS)
def test_run_cell_in_a_fake_world(cells, arch, shape_name, multi):
    r = cells[cell_key(arch, shape_name, multi)]
    assert r["ok"], r.get("traceback")
    assert r["n_devices"] == (512 if multi else 256)
    assert r["mesh"] == ("2x16x16" if multi else "16x16")
    shape = JX_SHAPES[shape_name]
    jcfg = jx_get_config(arch)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    kind = "train" if shape.kind == "train" else "serve"
    assert r["model_flops_total"] == jx_roofline.model_flops(jcfg.active_params(), tokens, kind)
    roof = r["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["compute_s"] == roof["flops"] / roofline.PEAK_FLOPS
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    if arch.startswith("qwen3_moe"):  # EP dispatch and the gradients' reductions
        assert roof["coll_bytes"]["all-to-all"] > 0 and roof["coll_bytes"]["all-reduce"] > 0


# ------------------------------------------------------------- report
def _synthetic_results():
    res = {}
    for i, (arch, shape) in enumerate([("qwen3_14b", "train_4k"), ("qwen3_14b", "decode_32k"),
                                       ("mamba2_2_7b", "prefill_32k"), ("whisper_small",
                                                                        "long_500k")]):
        for mesh in ("single", "multi"):
            terms = [0.5 + i, 0.25 * (i + 1), 0.1 * (3 - i)]
            res[f"{arch}|{shape}|{mesh}"] = {
                "arch": arch, "shape": shape, "kind": SHAPES[shape].kind, "ok": True,
                "roofline": {"compute_s": terms[0], "memory_s": terms[1],
                             "collective_s": terms[2],
                             "bottleneck": ("compute", "memory", "collective")[i % 3]},
                "useful_flops_ratio": None if i == 3 else 0.5 + 0.1 * i,
            }
    res["qwen3_14b|prefill_32k|single"] = {"arch": "qwen3_14b", "shape": "prefill_32k",
                                           "ok": False, "error": "Boom: synthetic"}
    return res


def _printed(main, argv, patch_argv):
    buf = io.StringIO()
    old = sys.argv
    if patch_argv:
        sys.argv = ["report", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            rc = main() if patch_argv else main(argv)
    finally:
        sys.argv = old
    assert rc == 0
    return buf.getvalue().splitlines()


def test_report_rows_equal_jax(tmp_path):
    path = tmp_path / "res.json"
    path.write_text(json.dumps(_synthetic_results()))
    argv = ["--results", str(path), "--mesh", "both"]
    ours = _printed(report.main, argv, False)
    theirs = _printed(jx_report.main, argv, True)
    assert len(ours) == len(theirs)
    rows = 0
    for a, b in zip(ours, theirs):
        if a.startswith("| ") and not a.startswith("| arch"):
            assert a.split("|")[1:-2] == b.split("|")[1:-2]  # all but the advice
            rows += 1
        elif a.startswith("### ") or a.startswith("| arch"):
            assert "H100" in a or "counted" in a
        else:
            assert a == b
    assert rows == 8
    assert any("Boom: synthetic" in a for a in ours)
    assert not any("MXU" in a for a in ours)
