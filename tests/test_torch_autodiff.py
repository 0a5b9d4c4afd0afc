"""Twins of tests/test_autodiff.py for the port: gradients through
repro_torch.api with an AutoSage (every forward and backward op a
scheduled decision, the CUDA families in the pool through their plain
versions) against jax.grad through repro.api with a JAX AutoSage on the
same numpy inputs; backward decisions under their own cache keys,
bit-identical backward replay, one transpose across steps, and each
SDDMM and runtime-valued kernel family pinned inside a backward.

Tolerance rtol 1e-3, atol 1e-3 (tests/test_autodiff.py's): the two
sides sum fp32 products in other orders along chains of several ops."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jx_api
from repro.core import AutoSage as JxSage
from repro.core import ScheduleCache as JxCache
from repro.kernels import ref as jref
from repro.sparse import hub_skew as jx_hub_skew
from repro.sparse import power_law as jx_power_law
from repro_torch import api
from repro_torch.core import AutoSage, InputFeatures, ReplayMiss, ScheduleCache, registry
from repro_torch.kernels import sddmm as ksd
from repro_torch.kernels import spmm as ks
from repro_torch.sparse import csr_from_dense, hub_skew, power_law
from repro_torch.sparse.csr import TRANSPOSE_STATS, reset_transpose_stats

torch.set_num_threads(1)  # see test_torch_spmm.py

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def probe_kernels(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")


def _sage(path=None, **kw):
    return AutoSage(cache=ScheduleCache(path=path, **kw), device="cpu", probe_iters=2,
                    probe_cap_ms=200, probe_frac=0.05)


def _jx_sage():
    return JxSage(cache=JxCache(path=None), probe_iters=2, probe_cap_ms=200, probe_frac=0.05)


@pytest.fixture(scope="module")
def sage():
    # module-scoped: decisions and prepared runners amortize across
    # tests, as in a training process
    return _sage()


def _jx_grad(fn, args, monkeypatch):
    """jax.grad of fn at numpy args, with the JAX pool XLA-only (its Pallas
    variants would run in interpret mode)."""
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS")
    try:
        out = jax.grad(fn, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    finally:
        monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    return [np.asarray(g) for g in out]


def _grads(fn, args):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in args]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------- spmm
def test_spmm_grad_matches_jax(sage, monkeypatch):
    g = power_law(300, 1.7, avg_deg=6.0, n_cols=200, seed=1)
    jg = jx_power_law(300, 1.7, avg_deg=6.0, n_cols=200, seed=1)
    b = np.random.default_rng(0).standard_normal((g.n_cols, 32)).astype(np.float32)
    got = _grads(lambda b: (api.spmm(g, b, sage=sage) ** 2).sum(), [b])
    want = _jx_grad(lambda b: (jx_api.spmm(jg, b, sage=_jx_sage()) ** 2).sum(), [b],
                    monkeypatch)
    _close(got, want)
    # the reference route (sage=None: the explicit backward oracles) too
    _close(_grads(lambda b: (api.spmm(g, b) ** 2).sum(), [b]), want)


def test_spmm_vals_grad_includes_explicit_zero_edges(sage, monkeypatch):
    g = power_law(200, 1.6, avg_deg=5.0, n_cols=150, seed=2)
    jg = jx_power_law(200, 1.6, avg_deg=5.0, n_cols=150, seed=2)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(g.nnz).astype(np.float32)
    vals[:: max(g.nnz // 7, 1)] = 0.0
    b = rng.standard_normal((g.n_cols, 16)).astype(np.float32)
    got = _grads(lambda v, b: (api.spmm(g, b, sage=sage, vals=v) ** 2).sum(), [vals, b])
    want = _jx_grad(lambda v, b: (jx_api.spmm(jg, b, sage=_jx_sage(), vals=v) ** 2).sum(),
                    [vals, b], monkeypatch)
    _close(got, want)
    _close(_grads(lambda v, b: (api.spmm(g, b, vals=v) ** 2).sum(), [vals, b]), want)
    zero = np.flatnonzero(vals == 0.0)
    assert np.abs(got[0][zero]).max() > 0


@pytest.mark.parametrize("alpha,seed", [(1.3, 0), (1.6, 1), (1.9, 2), (2.2, 3), (2.4, 1)])
def test_spmm_grad_property_power_law(sage, alpha, seed):
    """Scheduled grad == reference grad across power-law skew."""
    g = power_law(150, alpha, avg_deg=4.0, n_cols=120, seed=seed)
    jg = jx_power_law(150, alpha, avg_deg=4.0, n_cols=120, seed=seed)
    b = np.random.default_rng(seed).standard_normal((g.n_cols, 16)).astype(np.float32)
    got = _grads(lambda b: api.spmm(g, b, sage=sage).sum(), [b])
    rp, ci = jnp.asarray(jg.rowptr), jnp.asarray(jg.colind)
    want = jax.grad(lambda b: jref.spmm_ref(rp, ci, None, b).sum())(jnp.asarray(b))
    _close(got, [np.asarray(want)])


def test_spmm_grad_empty_rows_and_all_hub(sage):
    dense = np.zeros((12, 10), np.float32)
    dense[0, :] = 1.0
    dense[3, 2] = 2.0
    g = csr_from_dense(dense)
    b = np.random.default_rng(0).standard_normal((10, 8)).astype(np.float32)
    want = jax.grad(lambda b: ((jnp.asarray(dense) @ b) ** 2).sum())(jnp.asarray(b))
    _close(_grads(lambda b: (api.spmm(g, b, sage=sage) ** 2).sum(), [b]), [np.asarray(want)])
    hub = hub_skew(600, 3, 0.05, 24, seed=4).dedup_edges()
    jhub = jx_hub_skew(600, 3, 0.05, 24, seed=4).dedup_edges()
    bh = np.random.default_rng(1).standard_normal((hub.n_cols, 16)).astype(np.float32)
    rp, ci = jnp.asarray(jhub.rowptr), jnp.asarray(jhub.colind)
    want = jax.grad(lambda b: jref.spmm_ref(rp, ci, None, b).sum())(jnp.asarray(bh))
    _close(_grads(lambda b: api.spmm(hub, b, sage=sage).sum(), [bh]), [np.asarray(want)])


# ------------------------------------------------------- sddmm/attention
def test_sddmm_grad_matches_jax(sage, monkeypatch):
    g = power_law(250, 1.8, avg_deg=5.0, n_cols=180, seed=3)
    jg = jx_power_law(250, 1.8, avg_deg=5.0, n_cols=180, seed=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((g.n_rows, 16)).astype(np.float32)
    y = rng.standard_normal((g.n_cols, 16)).astype(np.float32)
    want = _jx_grad(lambda x, y: (jx_api.sddmm(jg, x, y, sage=_jx_sage()) ** 2).sum(),
                    [x, y], monkeypatch)
    _close(_grads(lambda x, y: (api.sddmm(g, x, y, sage=sage) ** 2).sum(), [x, y]), want)
    _close(_grads(lambda x, y: (api.sddmm(g, x, y) ** 2).sum(), [x, y]), want)


def test_attention_grad_matches_jax(sage, monkeypatch):
    g = power_law(150, 1.6, avg_deg=5.0, seed=6)
    jg = jx_power_law(150, 1.6, avg_deg=5.0, seed=6)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((150, 16)).astype(np.float32) for _ in range(3))
    want = _jx_grad(
        lambda q, k, v: (jx_api.attention(jg, q, k, v, sage=_jx_sage()) ** 2).sum(),
        [q, k, v], monkeypatch)
    got = _grads(lambda q, k, v: (api.attention(g, q, k, v, sage=sage) ** 2).sum(), [q, k, v])
    _close(got, want)
    _close(_grads(lambda q, k, v: (api.attention(g, q, k, v) ** 2).sum(), [q, k, v]), want)
    # and the closed-form JAX oracle
    rp, ci = jnp.asarray(jg.rowptr), jnp.asarray(jg.colind)
    out = jref.csr_attention_ref(rp, ci, *map(jnp.asarray, (q, k, v)))
    _close(got, jref.csr_attention_bwd_ref(rp, ci, *map(jnp.asarray, (q, k, v)), 2.0 * out))


# ------------------------------------------ cache / replay / transposes
BWD_OPS = ("spmm_bwd_b", "spmm_bwd_vals", "spmm_bwd_b_dyn", "sddmm_bwd_x", "sddmm_bwd_y",
           "attention_bwd_e", "attention_bwd_p", "attention_bwd_q", "attention_bwd_k",
           "attention_bwd_v")


def test_bwd_ops_get_own_cache_keys(sage):
    """Every backward op decided above landed under its own op string,
    with the grad-side F in the key."""
    for op in BWD_OPS:
        keys = sage.cache.keys_for_op(op)
        assert keys, f"no cache entry for backward op {op}"
        assert all(f"|{op}|" in k for k in keys)


def test_bwd_replay_bit_identical(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    g = power_law(200, 1.7, avg_deg=5.0, n_cols=160, seed=7)
    b = np.random.default_rng(4).standard_normal((g.n_cols, 16)).astype(np.float32)

    def loss(s, graph):
        return lambda b: (api.spmm(graph, b, sage=s) ** 2).sum()

    s1 = _sage(path)
    g1 = _grads(loss(s1, g), [b])[0]
    assert s1.cache.keys_for_op("spmm_bwd_b")
    monkeypatch.setenv("AUTOSAGE_REPLAY_ONLY", "1")
    s2 = AutoSage(cache=ScheduleCache(path=path), device="cpu")
    assert s2.cache.replay_only
    np.testing.assert_array_equal(_grads(loss(s2, g), [b])[0], g1)
    other = power_law(201, 1.7, avg_deg=5.0, n_cols=160, seed=8)
    with pytest.raises(ReplayMiss):
        _grads(loss(s2, other),
               [np.zeros((other.n_cols, 16), np.float32)])


def test_transpose_built_once_across_steps():
    reset_transpose_stats()
    g = power_law(200, 1.6, avg_deg=5.0, n_cols=150, seed=9)
    sage = _sage()
    b = np.random.default_rng(5).standard_normal((g.n_cols, 16)).astype(np.float32)

    def loss(b):
        return (api.spmm(g, b, sage=sage) ** 2).sum()

    _grads(loss, [b])
    built_first = TRANSPOSE_STATS["built"]
    assert built_first >= 1
    for _ in range(3):
        _grads(loss, [b])
    assert TRANSPOSE_STATS["built"] == built_first
    assert TRANSPOSE_STATS["hits"] >= 3


# ------------------------------------------------ kernel families pinned
def _pin(path, sage, op, family, graph, f):
    """Rewrite every cached ``op`` entry of ``sage`` to the ``family``
    variant at 8x8 (tile_slots 8); returns its full name."""
    feat = InputFeatures.from_csr(graph, f, op)
    names = [v.full_name() for v in registry.candidates(feat, sage.hw, CPU)
             if v.name == family and v.knobs.get("rb") == 8
             and v.knobs.get("tile_slots", 8) == 8]
    assert len(names) == 1, names
    entries = json.loads(open(path).read())
    for key, entry in entries.items():
        if key.split("|")[3] == op:
            sage.cache.put(key, {**entry, "choice": names[0]})
    return names[0]


@pytest.mark.parametrize("family", ["block_ell_cuda", "ragged_ell_cuda", "merge_path_cuda"])
def test_attention_backward_with_each_sddmm_family_pinned(tmp_path, family):
    """attention_bwd_e/_p pinned to each SDDMM family and the runtime-
    valued ops to the ragged and merge families: the kernels' plain
    versions launch inside the backward and the gradient matches the
    reference route's."""
    g = hub_skew(300, 3, 0.1, 40, seed=2).dedup_edges()
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((g.n_rows, 32)).astype(np.float32) for _ in range(3))
    path = str(tmp_path / "c.json")
    _grads(lambda q, k, v: api.attention(g, q, k, v, sage=_sage(path)).sum(), [q, k, v])
    cache = ScheduleCache(path=path)
    pin = AutoSage(cache=cache, device="cpu")
    for op in ("attention_bwd_e", "attention_bwd_p"):
        _pin(path, pin, op, family, g.structural(), 32)
    dyn = "merge_path_cuda" if family == "merge_path_cuda" else "ragged_ell_cuda"
    _pin(path, pin, "attention_bwd_q", dyn, g.structural(), 32)
    _pin(path, pin, "attention_bwd_k", dyn, g.structural().transpose(), 32)
    replay = AutoSage(cache=ScheduleCache(path=path, replay_only=True), device="cpu")
    calls = {"sddmm": 0, "spmm": 0}
    kernel = {"block_ell_cuda": "sddmm_block_ell", "ragged_ell_cuda": "sddmm_ragged_ell",
              "merge_path_cuda": "sddmm_merge_path"}[family]
    real_sd = getattr(ksd, kernel)
    real_sp = getattr(ks, "spmm_merge_path" if dyn == "merge_path_cuda" else "spmm_ragged_ell")

    def count(name, real):
        def wrapped(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as m:
        m.setattr(ksd, kernel, count("sddmm", real_sd))
        m.setattr(ks, real_sp.__name__, count("spmm", real_sp))
        got = _grads(lambda q, k, v: (api.attention(g, q, k, v, sage=replay) ** 2).sum(),
                     [q, k, v])
    assert calls["sddmm"] == 2 and calls["spmm"] >= 2
    _close(got, _grads(lambda q, k, v: (api.attention(g, q, k, v) ** 2).sum(), [q, k, v]))
