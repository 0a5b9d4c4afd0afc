"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8.

Port of repro/models/rglru.py. Prefill runs a log-depth inclusive scan
(JAX's `associative_scan`, here Hillis-Steele doubling: the same
combine, in another order); decode is the single-step update. The block
wraps the LRU in Griffin's recurrent block: a gelu gate branch and a
conv -> LRU branch, merged and projected out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import Params, dense_init, gelu, normal, zeros
from repro_torch.models.ssm import causal_conv, conv_history

_C = 8.0


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru(gen, cfg: ArchConfig, dtype=torch.float32) -> Params:
    d = cfg.d_model
    w = _lru_width(cfg)
    cw = cfg.hybrid.conv_width
    # Lambda such that a lies in (0.9, 0.999) at r = 1 (Griffin appendix)
    lin = torch.linspace(0.9, 0.999, w, device=gen.device)
    return Params(
        w_x=dense_init(gen, d, w, dtype),  # conv -> LRU branch
        w_y=dense_init(gen, d, w, dtype),  # gelu gate branch
        conv_w=normal(gen, (cw, w), 0.2, dtype),
        conv_b=zeros(gen, (w,), dtype),
        w_input_gate=dense_init(gen, w, w, dtype, scale=0.01),
        w_rec_gate=dense_init(gen, w, w, dtype, scale=0.01),
        lam=torch.log(torch.expm1(-torch.log(lin) / _C)).float(),
        w_out=dense_init(gen, w, d, dtype),
    )


def _gates(params, u):
    i_t = torch.sigmoid(u @ params.w_input_gate.to(u.dtype))
    r_t = torch.sigmoid(u @ params.w_rec_gate.to(u.dtype))
    log_a = -_C * torch.nn.functional.softplus(params.lam) * r_t.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return i_t.float(), a, beta


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, along axis 1, in
    log2(S) doubling steps of the combine (a1, b1), (a2, b2) ->
    (a1 * a2, b1 * a2 + b2)."""
    shift = 1
    while shift < a.shape[1]:
        b = torch.cat([b[:, :shift], b[:, :-shift] * a[:, shift:] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def _recurrence(params, x: torch.Tensor):
    """(output, LRU states h (B, S, W), the conv's input)."""
    y_branch = gelu(x @ params.w_y.to(x.dtype))
    xin = x @ params.w_x.to(x.dtype)
    u = causal_conv(xin, params.conv_w, params.conv_b)
    i_t, a, beta = _gates(params, u)
    h = linear_scan(a, beta * (i_t * u.float()))
    out = (h.to(x.dtype) * y_branch) @ params.w_out.to(x.dtype)
    return out, h, xin


def rglru_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); full-sequence scan."""
    return _recurrence(params, x)[0]


def rglru_prefill(params, x: torch.Tensor, cfg: ArchConfig, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence scan that also returns the final recurrent state."""
    out, h, xin = _recurrence(params, x)
    cw = cfg.hybrid.conv_width
    new_cache = {
        "h": h[:, -1],
        "conv": xin[:, -(cw - 1):].to(cache["conv"].dtype),
        "pos": cache["pos"] + x.shape[1],
    }
    return out, new_cache


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> Dict:
    w = _lru_width(cfg)
    cw = cfg.hybrid.conv_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, w), dtype=dtype, device=device),
        "pos": 0,
    }


def rglru_step(params, x: torch.Tensor, cfg: ArchConfig, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); single-step recurrence."""
    y_branch = gelu(x @ params.w_y.to(x.dtype))
    xin = x @ params.w_x.to(x.dtype)  # (B,1,W)
    hist = conv_history(cache["conv"], xin)
    u = (torch.einsum("bwc,wc->bc", hist, params.conv_w.to(hist.dtype)) + params.conv_b)[:, None]
    i_t, a, beta = _gates(params, u)
    h = cache["h"] * a[:, 0] + (beta * (i_t * u.float()))[:, 0]
    out = (h[:, None].to(x.dtype) * y_branch) @ params.w_out.to(x.dtype)
    return out, {"h": h, "conv": hist[:, 1:], "pos": cache["pos"] + 1}
