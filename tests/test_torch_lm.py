"""The LLM serving stack of repro_torch (configs, models, train.step,
`demo-lm`) against the JAX package on the CPU.

The same seeded numpy inputs and the same weights (drawn by the JAX
package, every zero-initialised leaf replaced by seeded noise so that
biases, norms and qk-norm matter, then carried over) go through each
JAX function and its port. Tolerance: fp32 products summed in another
order, max |port - jax| <= RTOL * max |jax| with RTOL = 1e-4 (observed
~1e-6); the bf16-cache test uses 2e-2. Greedy tokens must be equal.
"""
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config, reduced
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import modules as jmod
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtrans
from repro_torch.configs import base as tconfigs
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import modules as tmod
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttrans

torch.set_num_threads(1)
RTOL = 1e-4
CPU = "cpu"
LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]
# archs whose decode runs GQA layers, so long_ctx routes through the band
ATTN_ARCHS = [a for a in LM_ARCHS
              if get_config(a).family in ("dense", "vlm", "hybrid")
              or (get_config(a).family == "moe" and get_config(a).mla is None)]
B, S = 2, 24


def _cfgs(arch):
    return reduced(get_config(arch)), tconfigs.reduced(tconfigs.get_config(arch))


def _close(name, got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-30), f"{name}: max err {err:.3e}, max |ref| {scale:.3e}"


def _noisy(tree, seed):
    """JAX params as numpy, every all-zero leaf (bias, norm) replaced by
    0.1 * N(0, 1), so the port's use of each leaf is checked."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, tree)


_JITS = {}


def _J(f, static, **dyn):
    """The JAX function ``f(**dyn, **static)`` under jax.jit (one trace
    per shape, not one compile per eager op), ``static`` (config, flags)
    static. Keyed on the environment knobs read at trace time too."""
    key = (f, tuple(sorted(static.items())), os.environ.get("REPRO_ATTN"),
           os.environ.get("REPRO_MLA_ABSORB"))
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda d: f(**d, **static))
    return _JITS[key](dyn)


def _pair(init_j, init_t, cfg, tcfg, seed=0):
    """(JAX params, port module) holding the same weights."""
    pnp = _noisy(_J(init_j, dict(cfg=cfg), key=jax.random.PRNGKey(seed)), seed)
    mod = init_t(tmod.make_generator(0, CPU), tcfg)
    tmod.load_tree(mod, pnp)
    return jax.tree.map(jnp.asarray, pnp), mod


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------- modules
def test_rmsnorm_layernorm_linear_and_ffns():
    x = _x((3, 5, 16))
    w = _x((16,), 2)
    b = _x((16,), 3)
    _close("rmsnorm", tmod.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jmod.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close("layernorm", tmod.layernorm(*map(torch.from_numpy, (x, w, b))),
           jmod.layernorm(*map(jnp.asarray, (x, w, b))))
    xb = torch.from_numpy(x).bfloat16()
    got = tmod.rmsnorm(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _close("rmsnorm bf16", got, jmod.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)),
           rtol=1e-2)
    for init_j, f_j, init_t, f_t in ((jmod.init_swiglu, jmod.swiglu, tmod.init_swiglu, tmod.swiglu),
                                     (jmod.init_gelu_mlp, jmod.gelu_mlp, tmod.init_gelu_mlp,
                                      tmod.gelu_mlp)):
        pj = _noisy(init_j(jax.random.PRNGKey(0), 16, 40), 0)
        pt = init_t(tmod.make_generator(0, CPU), 16, 40)
        tmod.load_tree(pt, pj)
        _close(f_j.__name__, f_t(pt, torch.from_numpy(x)), f_j(jax.tree.map(jnp.asarray, pj),
                                                              jnp.asarray(x)))


def test_apply_rope_rotates_halves_as_jax():
    x = _x((2, 7, 3, 16))
    pos = np.stack([np.arange(7), 5000 + 3 * np.arange(7)]).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(f"rope {theta}",
               tmod.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jmod.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), rtol=1e-5)
    # halves, not interleaved pairs: position 1 mixes column i with i + Dh/2
    e = np.zeros((1, 1, 1, 16), np.float32)
    e[..., 0] = 1.0
    out = tmod.apply_rope(torch.from_numpy(e), torch.ones(1, 1, dtype=torch.long), 1e4)
    assert abs(float(out[..., 8]) - np.sin(1.0)) < 1e-6 and float(out[..., 1]) == 0.0


@pytest.mark.parametrize("arch", ["qwen3_14b", "qwen2_5_32b"])
def test_gqa_attention_no_cache_cache_and_window(arch):
    cfg, tcfg = _cfgs(arch)  # qk-norm, qkv-bias
    pj, pt = _pair(jattn.init_gqa, tattn.init_gqa, cfg, tcfg)
    x = _x((B, 12, cfg.d_model))
    pos = np.broadcast_to(np.arange(12), (B, 12)).astype(np.int32)
    for window in (None, 5):
        yj, _ = _J(jattn.gqa_attention, dict(cfg=cfg, window=window), params=pj, x=x, positions=pos)
        yt, c = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                    window=window)
        assert c is None
        _close(f"gqa window={window}", yt, yj)
    # with a cache: prefill 8, then 3 tokens at pos 8, into a cache of 16
    for window in (None, 5):
        cj = jattn.init_kv_cache(cfg, B, 16, jnp.float32)
        ct = tattn.init_kv_cache(tcfg, B, 16, torch.float32, CPU)
        for lo, hi in ((0, 8), (8, 11)):
            xs, ps = x[:, lo:hi], pos[:, lo:hi]
            yj, cj = _J(jattn.gqa_attention, dict(cfg=cfg, window=window), params=pj, x=xs,
                        positions=ps, cache=cj)
            yt, ct = tattn.gqa_attention(pt, torch.from_numpy(xs), tcfg, torch.from_numpy(ps),
                                         ct, window)
            _close(f"gqa cache [{lo}:{hi}] window={window}", yt, yj)
        assert ct["pos"] == int(cj["pos"]) == 11
        _close("k cache", ct["k"], cj["k"])
        _close("v cache", ct["v"], cj["v"])


def test_gqa_cache_write_clamps_as_dynamic_update_slice():
    """A write past the cache end lands at L - s, as XLA clamps it."""
    cfg, tcfg = _cfgs("qwen3_14b")
    pj, pt = _pair(jattn.init_gqa, tattn.init_gqa, cfg, tcfg)
    x = _x((B, 3, cfg.d_model))
    pos = np.broadcast_to(np.arange(3), (B, 3)).astype(np.int32)
    cj = dict(jattn.init_kv_cache(cfg, B, 8, jnp.float32), pos=jnp.int32(7))
    ct = dict(tattn.init_kv_cache(tcfg, B, 8, torch.float32, CPU), pos=7)
    yj, cj = _J(jattn.gqa_attention, dict(cfg=cfg), params=pj, x=x, positions=pos, cache=cj)
    yt, ct = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos), ct)
    _close("clamped k", ct["k"], cj["k"])
    assert not ct["k"][:, :5].any() and ct["k"][:, 5:].any()
    _close("clamped out", yt, yj)


@pytest.mark.parametrize("window", [None, 40])
def test_chunked_attention_equals_jax(window):
    cfg, tcfg = _cfgs("qwen3_14b")
    pj, pt = _pair(jattn.init_gqa, tattn.init_gqa, cfg, tcfg)
    s = 96
    x = _x((B, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s), (B, s)).astype(np.int32)
    qj, kj, vj = _J(jattn._qkv, dict(cfg=cfg), params=pj, x=x, positions=pos)
    qt, kt, vt = tattn._qkv(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    for qc in (32, 40, 1024):  # three chunks, a ragged last chunk, one chunk
        _close(f"chunked q_chunk={qc}",
               tattn._sdpa_causal_chunked(qt, kt, vt, 0.25, window, qc),
               _J(jattn._sdpa_causal_chunked, dict(scale=0.25, window=window, q_chunk=qc),
                  q=qj, k=kj, v=vj))
    with _env(REPRO_ATTN="chunked"):
        yj, _ = _J(jattn.gqa_attention, dict(cfg=cfg, window=window), params=pj, x=x, positions=pos)
        yt, _ = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                    window=window)
        cj = jattn.init_kv_cache(cfg, B, s, jnp.float32)
        ct = tattn.init_kv_cache(tcfg, B, s, torch.float32, CPU)
        yjc, _ = _J(jattn.gqa_attention, dict(cfg=cfg, window=window), params=pj, x=x,
                     positions=pos, cache=cj)
        ytc, _ = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos), ct,
                                     window)
    _close("gqa chunked", yt, yj)
    _close("gqa chunked prefill (l == s)", ytc, yjc)
    naive, _ = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                   window=window)
    _close("chunked vs naive", yt, naive.detach().numpy())


@pytest.mark.parametrize("pos,length", [(3, 128), (70, 128), (127, 128), (5, 40)],
                         ids=["pos_below_sinks", "mid_cache", "cache_end", "window_over_cache"])
def test_csr_window_attention(pos, length):
    """Sinks [0, 8) + a window of 64 (reduced), over a cache full of
    random rows. Below the sinks, sink rows past ``pos`` are attended
    (the JAX naive path never masks sinks), so the result differs from
    causal attention over rows <= pos."""
    cfg, tcfg = _cfgs("qwen3_14b")
    pj, pt = _pair(jattn.init_gqa, tattn.init_gqa, cfg, tcfg)
    kv = _x((2, B, length, cfg.n_kv_heads, cfg.resolved_head_dim), 5, 1.0)
    x = _x((B, 1, cfg.d_model), 6)
    p = np.full((B, 1), pos, np.int32)
    cj = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "pos": jnp.int32(pos)}
    ct = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()), "pos": pos}
    yj, cj = _J(jattn.csr_window_attention, dict(cfg=cfg), params=pj, x=x, positions=p, cache=cj)
    yt, ct = tattn.csr_window_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(p), ct)
    _close("csr window", yt, yj)
    _close("csr k cache", ct["k"], cj["k"])
    assert ct["pos"] == pos + 1
    g, w, start = tattn.band(tcfg, pos, length)
    assert (g, w) == (min(8, length), min(64, length))
    assert start == min(max(pos - (w - 1), 0), length - w)
    causal = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
              "pos": pos}
    yc, _ = tattn.gqa_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(p), causal,
                                window=w)
    if pos < g:  # the quirk: future sink rows take part
        assert float((yt - yc).abs().max()) > 1e-3
    elif pos - w + 1 >= g:  # a sliding window clear of the sinks
        assert float((yt - yc).abs().max()) > 1e-3  # sinks add rows a plain window lacks


@pytest.mark.parametrize("absorb", ["0", "1"])
def test_mla_naive_and_absorbed(absorb):
    cfg, tcfg = _cfgs("deepseek_v2_lite_16b")
    pj, pt = _pair(jattn.init_mla, tattn.init_mla, cfg, tcfg)
    x = _x((B, 10, cfg.d_model))
    pos = np.broadcast_to(np.arange(10), (B, 10)).astype(np.int32)
    with _env(REPRO_MLA_ABSORB=absorb):
        yj, _ = _J(jattn.mla_attention, dict(cfg=cfg), params=pj, x=x, positions=pos)
        yt, _ = tattn.mla_attention(pt, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
        _close("mla no cache", yt, yj)
        cj = jattn.init_kv_cache(cfg, B, 16, jnp.float32)
        ct = tattn.init_kv_cache(tcfg, B, 16, torch.float32, CPU)
        for lo, hi in ((0, 7), (7, 8), (8, 10)):
            yj, cj = _J(jattn.mla_attention, dict(cfg=cfg), params=pj, x=x[:, lo:hi],
                        positions=pos[:, lo:hi], cache=cj)
            yt, ct = tattn.mla_attention(pt, torch.from_numpy(x[:, lo:hi]), tcfg,
                                         torch.from_numpy(pos[:, lo:hi]), ct)
            _close(f"mla cache [{lo}:{hi}] absorb={absorb}", yt, yj)
    _close("c_kv", ct["c_kv"], cj["c_kv"])
    _close("k_rope", ct["k_rope"], cj["k_rope"])


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("variant", ["dense_onehot", "sorted_ragged", "auto"])
def test_moe_both_dispatch_branches(arch, variant):
    cfg, tcfg = _cfgs(arch)  # without and with shared experts
    pj, pt = _pair(jmoe.init_moe, tmoe.init_moe, cfg, tcfg)
    for s in (1, 9):  # a decode step and a prompt
        x = _x((B, s, cfg.d_model), s)
        _close(f"moe {variant} s={s}", tmoe.moe_ffn_ref(pt, torch.from_numpy(x), tcfg, variant),
               _J(jmoe.moe_ffn_ref, dict(cfg=cfg, variant=variant), params=pj, x=x))
        assert tmoe.dispatch_variant(tcfg, B * s) == jmoe.dispatch_variant(cfg, B * s)
    gj, ij = _J(jmoe._route, dict(top_k=cfg.moe.top_k), t=x.reshape(-1, cfg.d_model),
                router=pj["router"])
    gt, it = tmoe._route(torch.from_numpy(x.reshape(-1, cfg.d_model)), pt.router, cfg.moe.top_k)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    _close("gates", gt, gj)


def test_mamba2_forward_prefill_step():
    cfg, tcfg = _cfgs("mamba2_2_7b")
    pj, pt = _pair(jssm.init_mamba2, tssm.init_mamba2, cfg, tcfg)
    x = _x((B, 64, cfg.d_model))  # two chunks of 32
    _close("mamba2 forward", tssm.mamba2_forward(pt, torch.from_numpy(x), tcfg),
           _J(jssm.mamba2_forward, dict(cfg=cfg), params=pj, x=x))
    cj = jssm.init_ssm_cache(cfg, B)
    ct = tssm.init_ssm_cache(tcfg, B, device=CPU)
    yj, cj = _J(jssm.mamba2_prefill, dict(cfg=cfg), params=pj, x=x, cache=cj)
    yt, ct = tssm.mamba2_prefill(pt, torch.from_numpy(x), tcfg, ct)
    _close("mamba2 prefill", yt, yj)
    for t in range(3):
        xs = _x((B, 1, cfg.d_model), 10 + t)
        yj, cj = _J(jssm.mamba2_step, dict(cfg=cfg), params=pj, x=xs, cache=cj)
        yt, ct = tssm.mamba2_step(pt, torch.from_numpy(xs), tcfg, ct)
        _close(f"mamba2 step {t}", yt, yj)
    _close("ssm state", ct["h"], cj["h"])
    _close("conv state", ct["conv"], cj["conv"])
    assert ct["pos"] == int(cj["pos"]) == 67


def test_rglru_forward_prefill_step():
    cfg, tcfg = _cfgs("recurrentgemma_2b")
    pj, pt = _pair(jrglru.init_rglru, trglru.init_rglru, cfg, tcfg)
    x = _x((B, 21, cfg.d_model))
    _close("rglru forward", trglru.rglru_forward(pt, torch.from_numpy(x), tcfg),
           _J(jrglru.rglru_forward, dict(cfg=cfg), params=pj, x=x))
    cj = jrglru.init_rglru_cache(cfg, B)
    ct = trglru.init_rglru_cache(tcfg, B, device=CPU)
    yj, cj = _J(jrglru.rglru_prefill, dict(cfg=cfg), params=pj, x=x, cache=cj)
    yt, ct = trglru.rglru_prefill(pt, torch.from_numpy(x), tcfg, ct)
    _close("rglru prefill", yt, yj)
    for t in range(3):
        xs = _x((B, 1, cfg.d_model), 10 + t)
        yj, cj = _J(jrglru.rglru_step, dict(cfg=cfg), params=pj, x=xs, cache=cj)
        yt, ct = trglru.rglru_step(pt, torch.from_numpy(xs), tcfg, ct)
        _close(f"rglru step {t}", yt, yj)
    _close("lru state", ct["h"], cj["h"])
    _close("conv state", ct["conv"], cj["conv"])


def test_linear_scan_equals_the_recurrence():
    a = torch.rand(2, 37, 5)
    b = torch.randn(2, 37, 5)
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close("scan", trglru.linear_scan(a, b), torch.stack(want, 1).numpy(), rtol=1e-6)


# ------------------------------------------------------- every decoder
def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _batch(cfg, toks, seed=7):
    batch = {"tokens": toks}
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (toks.shape[0], cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (toks.shape[0], cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


_RUNS = {}


def _run(arch):
    """JAX and the port on one arch, same weights and inputs: forward,
    prefill, three greedy decode steps (each package feeding back its
    own argmax), and for GQA archs two long_ctx steps after them.
    Computed once per arch (the tests below read it)."""
    if arch in _RUNS:
        return _RUNS[arch]
    cfg, tcfg = _cfgs(arch)
    pnp = _noisy(_J(japi.init_model, dict(cfg=cfg, dtype=jnp.float32),
                    key=jax.random.PRNGKey(0)), 0)
    pj = jax.tree.map(jnp.asarray, pnp)
    model = tapi.params_from_jax(tcfg, pnp, device=CPU)
    batch = _batch(cfg, _tokens(cfg, B, S, 3))
    jbatch = jax.tree.map(jnp.asarray, batch)
    r = {"cfg": cfg, "tcfg": tcfg, "model": model, "batch": batch}
    r["fwd"] = (tapi.forward(model, batch, tcfg, device=CPU),
                _J(japi.forward, dict(cfg=cfg), params=pj, batch=jbatch))
    length = S + cfg.vlm_patches + 8
    cj = japi.init_cache(cfg, B, length, jnp.float32)
    ct = tapi.init_cache(tcfg, B, length, torch.float32, device=CPU)
    lj, cj = _J(japi.prefill, dict(cfg=cfg), params=pj, batch=jbatch, cache=cj)
    lt, ct = tapi.prefill(model, batch, tcfg, ct, device=CPU)
    r["prefill"] = (lt, lj, tapi.cache_to_numpy(tcfg, ct), jax.tree.map(np.asarray, cj))
    r["jax_cache_after_prefill"] = r["prefill"][3]
    steps = []
    tok_j = jnp.argmax(lj[:, -1], -1)[:, None]
    tok_t = torch.argmax(lt[:, -1], -1)[:, None]
    for i in range(5 if arch in ATTN_ARCHS else 3):
        long_ctx = i >= 3
        steps.append((np.asarray(tok_t), np.asarray(tok_j), long_ctx))
        lj, cj = _J(japi.decode_step, dict(cfg=cfg, long_ctx=long_ctx), params=pj, tokens=tok_j,
                    cache=cj)
        lt, ct = tapi.decode_step(model, tok_t, tcfg, ct, long_ctx=long_ctx, device=CPU)
        steps[-1] += (lt, lj)
        tok_j = jnp.argmax(lj[:, -1], -1)[:, None]
        tok_t = torch.argmax(lt[:, -1], -1)[:, None]
    r["steps"] = steps
    r["final_tokens"] = (np.asarray(tok_t), np.asarray(tok_j))
    r["final_cache"] = (tapi.cache_to_numpy(tcfg, ct), jax.tree.map(np.asarray, cj))
    _RUNS[arch] = r
    return r


def _tree_close(name, got, want):
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert gd == wd, f"{name}: cache layout {gd} != {wd}"
    for i, (g, w) in enumerate(zip(gl, wl)):
        if np.asarray(w).dtype.kind == "i":
            assert np.array_equal(np.asarray(g), np.asarray(w)), f"{name} leaf {i}: {g} != {w}"
        else:
            _close(f"{name} leaf {i}", np.asarray(g), w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_logits_match_jax(arch):
    got, want = _run(arch)["fwd"]
    _close(f"{arch} forward", got, want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    lt, lj, ct, cj = _run(arch)["prefill"]
    assert lt.shape == (B, 1, _run(arch)["cfg"].vocab)
    _close(f"{arch} prefill logits", lt, lj)
    _tree_close(f"{arch} prefill cache", ct, cj)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_and_greedy_tokens_match_jax(arch):
    r = _run(arch)
    for i, (tok_t, tok_j, long_ctx, lt, lj) in enumerate(r["steps"]):
        assert np.array_equal(tok_t, tok_j), f"step {i}: greedy tokens differ"
        _close(f"{arch} decode {i} long_ctx={long_ctx}", lt, lj)
    assert np.array_equal(*r["final_tokens"])
    _tree_close(f"{arch} cache after decode", *r["final_cache"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_jax_prefill_then_port_decode(arch):
    """The JAX package prefills; the port decodes from its cache."""
    r = _run(arch)
    tcfg = r["tcfg"]
    ct = tapi.cache_from_jax(tcfg, r["jax_cache_after_prefill"], device=CPU)
    tok = r["steps"][0][1]
    lt, ct = tapi.decode_step(r["model"], tok, tcfg, ct, device=CPU)
    _close(f"{arch} port decode from a JAX cache", lt, r["steps"][0][4])
    back = tapi.cache_to_numpy(tcfg, tapi.cache_from_jax(tcfg, r["jax_cache_after_prefill"],
                                                          device=CPU))
    _tree_close(f"{arch} cache round trip", back, r["jax_cache_after_prefill"])


def test_long_ctx_archs_are_the_gqa_archs():
    assert set(ATTN_ARCHS) == {"internlm2_20b", "qwen2_5_32b", "qwen1_5_110b", "qwen3_14b",
                               "internvl2_1b", "recurrentgemma_2b", "qwen3_moe_235b_a22b"}


def test_first_pos_reads_the_first_layer():
    cfg, tcfg = _cfgs("recurrentgemma_2b")
    cache = tapi.init_cache(tcfg, 1, 8, torch.float32, device=CPU)
    cache["layers"][0]["pos"] = 5
    assert ttrans._first_pos(cache) == 5
    jc = jax.tree.map(np.asarray, japi.init_cache(cfg, 1, 8, jnp.float32))
    jc["tail"]["sub_0"]["pos"] = np.full_like(jc["tail"]["sub_0"]["pos"], 4)
    assert int(jtrans._first_pos(jax.tree.map(jnp.asarray, jc))) == 4
    assert ttrans._first_pos(tapi.cache_from_jax(tcfg, jc, device=CPU)) == 4


def test_bf16_cache_decode_matches_jax():
    """The default cache dtype is bf16: k and v are cast on write."""
    cfg, tcfg = _cfgs("qwen3_14b")
    pnp = _noisy(_J(japi.init_model, dict(cfg=cfg, dtype=jnp.float32),
                    key=jax.random.PRNGKey(0)), 0)
    pj = jax.tree.map(jnp.asarray, pnp)
    model = tapi.params_from_jax(tcfg, pnp, device=CPU)
    toks = _tokens(cfg, B, 12, 9)
    cj = japi.init_cache(cfg, B, 16, jnp.bfloat16)
    ct = tapi.init_cache(tcfg, B, 16, torch.bfloat16, device=CPU)
    assert ct["layers"][0]["k"].dtype == torch.bfloat16
    assert tattn.init_kv_cache(tcfg, 1, 4)["k"].dtype == torch.bfloat16
    lj, cj = _J(japi.prefill, dict(cfg=cfg), params=pj, batch={"tokens": toks}, cache=cj)
    lt, ct = tapi.prefill(model, {"tokens": toks}, tcfg, ct, device=CPU)
    _close("bf16 prefill", lt, lj, rtol=2e-2)
    lj, cj = _J(japi.decode_step, dict(cfg=cfg), params=pj, tokens=toks[:, :1], cache=cj)
    lt, ct = tapi.decode_step(model, toks[:, :1], tcfg, ct, device=CPU)
    _close("bf16 decode", lt, lj, rtol=2e-2)
    # the port imports no ml_dtypes: bf16 leaves come back as float32
    assert tapi.cache_to_numpy(tcfg, ct)["tail"]["k"].dtype == np.float32


def test_decode_writes_the_cache_in_place_and_keeps_the_callers_pos():
    """A departure (ROADMAP Queue 3): JAX returns new cache arrays; the
    port writes the caller's tensors in place and returns new dicts, so
    the caller's dicts keep their ``pos`` and a step repeated on them
    rewrites the same slot."""
    r = _run("qwen3_14b")
    tcfg, model = r["tcfg"], r["model"]
    cache = tapi.init_cache(tcfg, B, S + 8, torch.float32, device=CPU)
    _, cache = tapi.prefill(model, r["batch"], tcfg, cache, device=CPU)
    k0 = cache["layers"][0]["k"]
    before = k0.clone()
    tok = r["steps"][0][0]
    l1, new = tapi.decode_step(model, tok, tcfg, cache, device=CPU)
    assert new["layers"][0]["k"] is k0 and cache["layers"][0]["pos"] == S
    assert new["layers"][0]["pos"] == S + 1
    assert not torch.equal(k0[:, S], before[:, S]) and torch.equal(k0[:, :S], before[:, :S])
    l2, _ = tapi.decode_step(model, tok, tcfg, cache, device=CPU)
    assert torch.equal(l1, l2)


def test_params_from_jax_rejects_a_mismatch():
    cfg, tcfg = _cfgs("qwen3_14b")
    pnp = jax.tree.map(np.asarray, _J(japi.init_model, dict(cfg=cfg, dtype=jnp.float32),
                                      key=jax.random.PRNGKey(0)))
    pnp["final_norm"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        tapi.params_from_jax(tcfg, pnp, device=CPU)
    del pnp["unembed"]
    with pytest.raises(ValueError, match="names differ"):
        tapi.params_from_jax(tcfg, pnp, device=CPU)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device=, every entry point asks for CUDA and raises where
    there is none: no fallback to the CPU."""
    _, tcfg = _cfgs("qwen3_14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.init_model(tcfg, 0)
    model = tapi.init_model(tcfg, 0, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.forward(model, {"tokens": np.zeros((1, 4), np.int32)}, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.init_cache(tcfg, 1, 8, torch.float32)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["demo-lm", "--arch", "qwen3_14b", "--reduced"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_model_has_jax_names_and_shapes(arch):
    """Every JAX parameter has a port parameter of its name and shape
    (the carry-over checks both); a seed gives the same weights twice."""
    cfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: japi.init_model(cfg, jax.random.PRNGKey(0), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = tapi.params_from_jax(tcfg, zeros, device=CPU)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in
                                                             jax.tree.leaves(zeros))
    a, b = (tapi.init_model(tcfg, 0, device=CPU) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("long_ctx", [False, True])
def test_demo_lm_cli_on_the_cpu(long_ctx):
    from repro_torch.launch import serve

    argv = ["demo-lm", "--arch", "qwen3_14b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "5"] + (["--long-ctx"] if long_ctx else [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(argv) == 0
    lines = out.getvalue().splitlines()
    assert [ln.split()[1] for ln in lines] == ["arch=qwen3-14b_reduced", "prefill", "decode",
                                               "sample"]
    assert "decode 4 steps" in lines[2]
    gens = eval(lines[3].split(":", 1)[1])
    assert len(gens) == 2 and all(len(g) == 5 for g in gens)


def test_step_factories_call_the_api():
    from repro_torch.train.step import make_decode_step, make_prefill_step

    r = _run("qwen3_14b")
    tcfg, model = r["tcfg"], r["model"]
    ct = tapi.init_cache(tcfg, B, S + 8, torch.float32, device=CPU)
    lt, ct = make_prefill_step(tcfg, device=CPU)(model, r["batch"], ct)
    _close("prefill step", lt, r["prefill"][1])
    lt, ct = make_decode_step(tcfg, device=CPU)(model, r["steps"][0][0], ct)
    _close("decode step", lt, r["steps"][0][4])
