"""Attention variants: GQA (optional qk-norm / qkv-bias / local window),
MLA (DeepSeek-V2), and the sliding-window + sink "CSR attention" of
long-context decode.

Port of repro/models/attention.py, with
``csr_window_attention_sharded``, the long-context decode over a cache
whose sequence is split over the ranks of a mesh. Every product is a
plain torch op, as JAX evaluates it with plain XLA ops: no Pallas
kernel is on this path. Logits and softmax are fp32; the additive mask
is NEG_INF = -1e30.

KV cache layout: {"k": (B, L, Hkv, Dh), "v": (B, L, Hkv, Dh), "pos": int}.
A step writes the cache's tensors in place (JAX's `dynamic_update_slice`,
start clamped alike) and returns a dict that shares them with
``pos`` advanced; the caller's dict keeps its old ``pos``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.models.modules import (
    NEG_INF,
    Params,
    additive_mask,
    apply_rope,
    dense_init,
    linear,
    rmsnorm,
    write_along_seq,
    zeros,
)


# ------------------------------------------------------------ GQA params
def init_gqa(gen, cfg: ArchConfig, dtype=torch.float32) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, h * dh, dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype),
        "wo": dense_init(gen, h * dh, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(gen, (h * dh,), dtype)
        p["bk"] = zeros(gen, (hkv * dh,), dtype)
        p["bv"] = zeros(gen, (hkv * dh,), dtype)
    if cfg.qk_norm:
        p["q_norm"] = zeros(gen, (dh,), dtype)
        p["k_norm"] = zeros(gen, (dh,), dtype)
    return Params(**p)


def _qkv(params, x, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, params.wq, getattr(params, "bq", None)).reshape(b, s, h, dh)
    k = linear(x, params.wk, getattr(params, "bk", None)).reshape(b, s, hkv, dh)
    v = linear(x, params.wv, getattr(params, "bv", None)).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, params.q_norm, cfg.norm_eps)
        k = rmsnorm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, scale) -> torch.Tensor:
    """q: (B,S,H,Dh); k/v: (B,L,Hkv,Dh); mask: (B,1,S,L) or (1,1,S,L).
    Query head h reads kv head h // (H // Hkv)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh)
    logits = torch.einsum("bshgd,blhd->bhgsl", qg.float(), k.float())
    logits = logits * scale + mask[:, :, None]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgsl,blhd->bshgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h * dh)


def _sdpa_causal_chunked(q, k, v, scale, window=None, q_chunk=1024) -> torch.Tensor:
    """Blockwise-causal attention (JAX's `REPRO_ATTN=chunked` path): query
    chunks of ``q_chunk`` attend to the keys up to their causal horizon
    only, with probabilities in the query dtype and an fp32 denominator."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qc = min(q_chunk, s)
    n_chunks = -(-s // qc)
    qg = q.reshape(b, s, hkv, g, dh)
    outs = []
    for i in range(n_chunks):
        q_i = qg[:, i * qc:(i + 1) * qc]
        sc = q_i.shape[1]
        hi = min((i + 1) * qc, s)  # causal horizon for this chunk
        lo = 0 if window is None else max(0, hi - sc - window)
        k_i = k[:, lo:hi]
        v_i = v[:, lo:hi]
        logits = torch.einsum("bshgd,blhd->bhgsl", q_i.float(), k_i.float()) * scale
        qpos = (i * qc + torch.arange(sc, device=q.device))[:, None]
        kpos = (lo + torch.arange(hi - lo, device=q.device))[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        logits = logits.masked_fill(~ok, NEG_INF)
        m = torch.amax(logits, dim=-1, keepdim=True).detach()  # JAX's stop_gradient
        p = torch.exp((logits - m).to(q.dtype))  # probs in [0, 1]
        denom = torch.sum(p.float(), dim=-1, keepdim=True)
        o = torch.einsum("bhgsl,blhd->bshgd", p, v_i.to(p.dtype))
        d_bshg = torch.clamp_min(denom[..., 0], 1e-30).permute(0, 3, 1, 2)
        o = o / d_bshg.to(o.dtype)[..., None]
        outs.append(o.reshape(b, sc, h * dh))
    return torch.cat(outs, dim=1)


def _use_chunked() -> bool:
    return os.environ.get("REPRO_ATTN", "naive") == "chunked"


def _causal_ok(qpos, l: int, window: Optional[int], device) -> torch.Tensor:
    kpos = torch.arange(l, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def causal_mask(s: int, l: int, window: Optional[int] = None, device=None) -> torch.Tensor:
    """(1, 1, S, L) additive mask; queries occupy the last s of l positions."""
    qpos = torch.arange(s, device=device)[:, None] + (l - s)
    return additive_mask(_causal_ok(qpos, l, window, device))[None, None]


def gqa_attention(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full (or banded) causal attention; writes the cache when given."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg, positions)
    scale = 1.0 / dh ** 0.5
    if cache is not None:
        pos = cache["pos"]
        k_all = write_along_seq(cache["k"], k, pos)
        v_all = write_along_seq(cache["v"], v, pos)
        l = k_all.shape[1]
        if _use_chunked() and s > 1 and l == s:
            # prefill that fills the whole cache: queries end at the
            # cache end, so the blockwise-causal path applies exactly
            out = _sdpa_causal_chunked(q, k_all, v_all, scale, window)
        else:
            qpos = pos + torch.arange(s, device=x.device)[:, None]
            mask = additive_mask(_causal_ok(qpos, l, window, x.device))[None, None]
            out = _sdpa(q, k_all, v_all, mask, scale)
        new_cache = {"k": k_all, "v": v_all, "pos": pos + s}
    else:
        if _use_chunked() and s > 1:
            out = _sdpa_causal_chunked(q, k, v, scale, window)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, window, x.device), scale)
        new_cache = None
    return linear(out, params.wo), new_cache


# ------------------------------------------ CSR (window+sink) attention
def band(cfg: ArchConfig, pos: int, length: int) -> Tuple[int, int, int]:
    """(sinks g, window w, window start) of the decode step at ``pos`` over
    a cache of ``length``: the sinks are rows [0, g), the window rows
    [start, start + w), start = clip(pos - (w - 1), 0, length - w)."""
    w = min(cfg.long_window, length)
    g = min(cfg.long_sinks, length)
    return g, w, min(max(pos - (w - 1), 0), length - w)


def csr_window_attention(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Dict,
) -> Tuple[torch.Tensor, Dict]:
    """Long-context decode through the paper's CSR-attention pattern: the
    query attends to `long_sinks` global sink rows plus a `long_window`
    sliding window, evaluated as dense tiles over the gathered band:
    O(window + sinks) per token instead of O(L). Window rows beyond
    ``pos`` or among the sinks are masked; the sinks never are, even
    while ``pos`` < sinks (they then hold zeros or later slots), as in
    the JAX package's naive path."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("csr_window_attention is a decode step")
    dh = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg, positions)
    pos = cache["pos"]
    k_all = write_along_seq(cache["k"], k, pos)
    v_all = write_along_seq(cache["v"], v, pos)
    g, w, start = band(cfg, pos, k_all.shape[1])
    k_band = torch.cat([k_all[:, :g], k_all[:, start:start + w]], dim=1)  # (B, g+w, Hkv, Dh)
    v_band = torch.cat([v_all[:, :g], v_all[:, start:start + w]], dim=1)
    kpos_win = start + torch.arange(w, device=x.device)
    ok_win = (kpos_win <= pos) & (kpos_win >= g)
    ok = torch.cat([torch.ones(g, dtype=torch.bool, device=x.device), ok_win])
    mask = additive_mask(ok)[None, None, None, :]
    out = _sdpa(q, k_band, v_band, mask, 1.0 / dh ** 0.5)
    return linear(out, params.wo), {"k": k_all, "v": v_all, "pos": pos + 1}


def csr_window_attention_sharded(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Dict,
    mesh,
) -> Tuple[torch.Tensor, Dict]:
    """Distribution-aware CSR window + sink attention (JAX's
    ``REPRO_LONG_ATTN=sharded``): the cache's sequence is split over the
    mesh's ('data', 'model') ranks, the first axis major, and this rank's
    ``cache`` holds its slice. The new token's k/v is written only by the
    rank whose slice holds ``pos``. Each rank takes the logits of its own
    positions masked to the band (``kpos <= pos`` and in the window or
    among the sinks: unlike the naive path, a sink beyond ``pos`` is
    masked), then a flash-style combine: a MAX all-reduce of the row
    maxima, a SUM all-reduce of the partial outputs and sums. No cache
    moves; the traffic is O(B·H·Dh) whatever the context length. ``x``
    and the output are replicated over the ranks."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("csr_window_attention_sharded is a decode step")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // hkv
    w, sinks = cfg.long_window, cfg.long_sinks
    scale = 1.0 / dh ** 0.5
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    pos = cache["pos"]
    seq_axes = tuple(a for a in ("data", "model") if a in mesh_shape(mesh))
    k_loc, v_loc = cache["k"], cache["v"]
    l_loc = k_loc.shape[1]
    offset = collectives.axis_index(mesh, seq_axes) * l_loc
    if offset <= pos < offset + l_loc:  # the new token lands in this slice
        k_loc[:, pos - offset] = k_new[:, 0].to(k_loc.dtype)
        v_loc[:, pos - offset] = v_new[:, 0].to(v_loc.dtype)
    kpos = offset + torch.arange(l_loc, device=x.device)
    valid = (kpos <= pos) & ((kpos > pos - w) | (kpos < sinks))
    qg = q.reshape(b, 1, hkv, g, dh).float()
    logits = torch.einsum("bshgd,blhd->bhgsl", qg, k_loc.float()) * scale
    logits = logits.masked_fill(~valid, float("-inf"))
    m = collectives.pmax(torch.amax(logits, dim=-1, keepdim=True), mesh, seq_axes)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe) * valid
    l_sum = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgsl,blhd->bshgd", p, v_loc.float())
    stats = torch.cat([o.reshape(b, 1, h, dh), l_sum.reshape(b, 1, h, 1)], dim=-1)
    stats = collectives.psum(stats, mesh, seq_axes)
    out = stats[..., :dh] / torch.clamp_min(stats[..., dh:], 1e-30)
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return linear(out, params.wo), {"k": k_loc, "v": v_loc, "pos": pos + 1}


# ----------------------------------------------------------------- MLA
def init_mla(gen, cfg: ArchConfig, dtype=torch.float32) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return Params(
        wq=dense_init(gen, d, h * qk_dim, dtype),
        w_dkv=dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        kv_norm=zeros(gen, (m.kv_lora_rank,), dtype),
        w_uk=dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dtype),
        w_uv=dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype),
        wo=dense_init(gen, h * m.v_head_dim, d, dtype),
    )


def mla_attention(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head Latent Attention (DeepSeek-V2). The cache stores the
    compressed latent c_kv + the shared rope key."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = linear(x, params.wq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = linear(x, params.w_dkv)  # (B,S,rank+dr)
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c_kv = rmsnorm(c_kv, params.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # (B,S,1,dr)

    if cache is not None:
        pos = cache["pos"]
        c_all = write_along_seq(cache["c_kv"], c_kv, pos)
        kr_all = write_along_seq(cache["k_rope"], k_rope[:, :, 0], pos)
        l = c_all.shape[1]
        qpos = pos + torch.arange(s, device=x.device)[:, None]
        new_cache = {"c_kv": c_all, "k_rope": kr_all, "pos": pos + s}
    else:
        c_all, kr_all = c_kv, k_rope[:, :, 0]
        l = s
        qpos = torch.arange(s, device=x.device)[:, None]
        new_cache = None

    if cache is not None and os.environ.get("REPRO_MLA_ABSORB") == "1":
        # weight absorption (DeepSeek-V2 §2.1): W_uk folds into the query
        # and W_uv into the output, so attention runs in the latent space
        return _mla_absorbed(params, q_nope, q_rope, c_all, kr_all, qpos, cfg, new_cache, x)

    k_nope = linear(c_all, params.w_uk).reshape(b, l, h, dn)
    v = linear(c_all, params.w_uv).reshape(b, l, h, dv)

    scale = 1.0 / (dn + dr) ** 0.5
    logits = (
        torch.einsum("bshd,blhd->bhsl", q_nope.float(), k_nope.float())
        + torch.einsum("bshd,bld->bhsl", q_rope.float(), kr_all.float())
    ) * scale
    mask = additive_mask(_causal_ok(qpos, l, None, x.device))[None, None]
    probs = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("bhsl,blhd->bshd", probs.to(v.dtype), v).reshape(b, s, h * dv)
    return linear(out, params.wo), new_cache


def _mla_absorbed(params, q_nope, q_rope, c_all, kr_all, qpos, cfg, new_cache, x):
    """Absorbed-weight MLA attention over the latent cache."""
    m = cfg.mla
    b, s, h, dn = q_nope.shape
    dv = m.v_head_dim
    l = c_all.shape[1]
    scale = 1.0 / (dn + m.qk_rope_head_dim) ** 0.5
    w_uk = params.w_uk.reshape(m.kv_lora_rank, h, dn)
    w_uv = params.w_uv.reshape(m.kv_lora_rank, h, dv)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk.float())
    logits = (
        torch.einsum("bshr,blr->bhsl", q_lat, c_all.float())
        + torch.einsum("bshd,bld->bhsl", q_rope.float(), kr_all.float())
    ) * scale
    mask = additive_mask(_causal_ok(qpos, l, None, x.device))[None, None]
    probs = torch.softmax(logits + mask, dim=-1)
    o_lat = torch.einsum("bhsl,blr->bshr", probs, c_all.float())
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv.float())
    out = out.reshape(b, s, h * dv).to(x.dtype)
    return linear(out, params.wo), new_cache


# -------------------------------------------------------- cache builders
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> Dict:
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.mla:
        m = cfg.mla
        return {
            "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                                  device=device),
            "pos": 0,
        }
    return {
        "k": torch.zeros((batch, max_len, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, hkv, dh), dtype=dtype, device=device),
        "pos": 0,
    }
