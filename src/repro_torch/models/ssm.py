"""Mamba-2 block: SSD (state-space duality), chunked [arXiv:2405.21060].

Port of repro/models/ssm.py. Prefill uses the chunked dual form (an
intra-chunk attention-like term plus an inter-chunk state recurrence,
JAX's `lax.scan` a Python loop over chunks); decode is the O(1)
recurrent update. The intra-chunk exponent is masked *before* ``exp``:
masked entries have positive exponents that overflow.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import Params, dense_init, normal, rmsnorm, zeros


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    n_heads = d_in // s.head_dim
    return d_in, n_heads, s.d_state, s.head_dim, s.conv_width


def init_mamba2(gen, cfg: ArchConfig, dtype=torch.float32) -> Params:
    d_in, h, n, p, cw = _dims(cfg)
    d = cfg.d_model
    conv_ch = d_in + 2 * n
    dev = gen.device
    return Params(
        w_in=dense_init(gen, d, 2 * d_in + 2 * n + h, dtype),
        conv_w=normal(gen, (cw, conv_ch), 0.2, dtype),
        conv_b=zeros(gen, (conv_ch,), dtype),
        a_log=torch.log(torch.linspace(1.0, 16.0, h, device=dev)).float(),
        dt_bias=zeros(gen, (h,)),
        d_skip=torch.ones(h, device=dev),
        norm=zeros(gen, (d_in,), dtype),
        w_out=dense_init(gen, d_in, d, dtype),
    )


def _split_proj(zxbcdt, cfg):
    d_in, h, n, p, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xc = zxbcdt[..., d_in:2 * d_in]
    b = zxbcdt[..., 2 * d_in:2 * d_in + n]
    c = zxbcdt[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xc, b, c, dt


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), width w.shape[0]."""
    cw = w.shape[0]
    xpad = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(xpad[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(cw))
    return out + b


def _ssd(params, x: torch.Tensor, cfg: ArchConfig, h0: torch.Tensor):
    """The chunked SSD over x (B, S, D) from state h0: (out, final state,
    the conv's pre-activation input)."""
    d_in, h, n, p, _ = _dims(cfg)
    bsz, s, _ = x.shape
    q = min(cfg.ssm.chunk, s)
    nc = s // q

    z, xc, b, c, dt = _split_proj(x @ params.w_in.to(x.dtype), cfg)
    conv_in = torch.cat([xc, b, c], -1)
    conv = F.silu(causal_conv(conv_in, params.conv_w, params.conv_b).float()).to(x.dtype)
    xc, b, c = conv[..., :d_in], conv[..., d_in:d_in + n], conv[..., d_in + n:]

    dt = F.softplus(dt.float() + params.dt_bias)  # (B,S,H)
    a = -torch.exp(params.a_log)  # (H,)
    dlog = dt * a  # (B,S,H), negative log-decay per step

    xh = xc.reshape(bsz, nc, q, h, p).float()
    bq = b.reshape(bsz, nc, q, n).float()
    cq = c.reshape(bsz, nc, q, n).float()
    dtq = dt.reshape(bsz, nc, q, h)
    cum = torch.cumsum(dlog.reshape(bsz, nc, q, h), dim=2)  # (B,NC,Q,H)

    # ---- intra-chunk (dual quadratic form, masked) -------------------
    cb = torch.einsum("bcqn,bckn->bcqk", cq, bq)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None] - cum[:, :, None, :]  # (B,NC,Q,K,H)
    seg = seg.masked_fill(~mask[None, None, :, :, None], -math.inf)  # before exp
    m = cb[..., None] * torch.exp(seg) * dtq[:, :, None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xh)

    # ---- chunk states + inter-chunk recurrence -----------------------
    last = cum[:, :, -1]  # (B,NC,H)
    s_decay = torch.exp(last[:, :, None] - cum) * dtq  # (B,NC,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bq, s_decay, xh)
    h_prev = h0
    h_prevs = []
    for i in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * torch.exp(last[:, i])[:, :, None, None] + states[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,NC,H,N,P)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cq, torch.exp(cum), h_prevs)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + xh.reshape(bsz, s, h, p) * params.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, d_in)
    y = rmsnorm((y * F.silu(z.float())).to(x.dtype), params.norm, cfg.norm_eps)
    return y @ params.w_out.to(x.dtype), h_prev, conv_in


def mamba2_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Chunked SSD over full sequences. x: (B, S, D)."""
    d_in, h, n, p, _ = _dims(cfg)
    s, q = x.shape[1], cfg.ssm.chunk
    if not (s % q == 0 or s < q):
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    h0 = torch.zeros((x.shape[0], h, n, p), dtype=torch.float32, device=x.device)
    return _ssd(params, x, cfg, h0)[0]


def mamba2_prefill(params, x: torch.Tensor, cfg: ArchConfig, cache: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """The chunked forward from the cache's state, returning the final SSM
    state and the conv state (the last cw - 1 pre-activation inputs)."""
    cw = cfg.ssm.conv_width
    out, h_final, conv_in = _ssd(params, x, cfg, cache["h"])
    new_cache = {
        "h": h_final,
        "conv": conv_in[:, -(cw - 1):].to(cache["conv"].dtype),
        "pos": cache["pos"] + x.shape[1],
    }
    return out, new_cache


# ------------------------------------------------------------- decoding
def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> Dict:
    d_in, h, n, p, cw = _dims(cfg)
    return {
        "h": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, d_in + 2 * n), dtype=dtype, device=device),
        "pos": 0,
    }


def conv_history(conv: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The conv window (B, cw, C): the cached cw - 1 inputs, then the new
    one, in their promoted dtype (JAX's concatenate promotes too)."""
    dt = torch.promote_types(conv.dtype, new.dtype)
    return torch.cat([conv.to(dt), new.to(dt)], dim=1)


def mamba2_step(params, x: torch.Tensor, cfg: ArchConfig, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent update. x: (B, 1, D)."""
    d_in, h, n, p, cw = _dims(cfg)
    bsz = x.shape[0]
    z, xc, b, c, dt = _split_proj(x @ params.w_in.to(x.dtype), cfg)
    hist = conv_history(cache["conv"], torch.cat([xc, b, c], -1))  # (B,cw,C)
    conv = F.silu(
        (torch.einsum("bwc,wc->bc", hist, params.conv_w.to(hist.dtype))
         + params.conv_b).float()
    )[:, None].to(x.dtype)
    xc, b, c = conv[..., :d_in], conv[..., d_in:d_in + n], conv[..., d_in + n:]

    dt = F.softplus(dt[:, 0].float() + params.dt_bias)  # (B,H)
    a = -torch.exp(params.a_log)
    decay = torch.exp(dt * a)  # (B,H)
    xh = xc[:, 0].reshape(bsz, h, p).float()
    bv = b[:, 0].float()  # (B,N)
    cv = c[:, 0].float()
    h_new = cache["h"] * decay[:, :, None, None] + torch.einsum("bn,bh,bhp->bhnp", bv, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", cv, h_new) + xh * params.d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_in)
    y = rmsnorm((y * F.silu(z.float())).to(x.dtype), params.norm, cfg.norm_eps)
    out = y @ params.w_out.to(x.dtype)
    return out, {"h": h_new, "conv": hist[:, 1:], "pos": cache["pos"] + 1}
