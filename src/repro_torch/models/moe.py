"""Mixture-of-Experts FFN, single device.

Port of repro/models/moe.py's single-device path: ``moe_ffn_ref`` (the
sort + grouped-GEMM dispatch, also the oracle) with its input-aware
dispatch variant, and ``moe_ffn``, which takes it as JAX does on one
device. The expert-parallel ``moe_ffn_ep`` and ``moe_param_specs`` need
a mesh and are not ported. JAX's ``jax.lax.ragged_dot`` becomes one
``torch.matmul`` per expert over its group of sorted token copies.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import Params, dense_init, init_swiglu, normal, swiglu


def init_moe(gen, cfg: ArchConfig, dtype=torch.float32) -> Params:
    mo = cfg.moe
    d, e, fe = cfg.d_model, mo.n_experts, mo.d_expert
    p = Params(
        router=dense_init(gen, d, e, torch.float32),  # router in f32
        w_gate=normal(gen, (e, d, fe), (1 / d) ** 0.5, dtype),
        w_up=normal(gen, (e, d, fe), (1 / d) ** 0.5, dtype),
        w_down=normal(gen, (e, fe, d), (1 / fe) ** 0.5, dtype),
    )
    if mo.n_shared:
        p.shared = init_swiglu(gen, d, mo.n_shared * fe, dtype)
    return p


def _route(t: torch.Tensor, router: torch.Tensor, top_k: int):
    """t: (T, D) -> (gates (T,k) f32, ids (T,k)). Softmax, then top-k,
    then renormalisation (qwen3-style norm_topk_prob)."""
    logits = t.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, ids


def _ragged_dot(x: torch.Tensor, w: torch.Tensor, bounds: List[int]) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows [bounds[e], bounds[e+1]) of x times w[e],
    one product per non-empty group, concatenated (differentiable)."""
    parts = [x[bounds[e]:bounds[e + 1]] @ w[e].to(x.dtype)
             for e in range(w.shape[0]) if bounds[e + 1] > bounds[e]]
    return torch.cat(parts) if parts else x.new_zeros((x.shape[0], w.shape[-1]))


def _expert_compute(xs, gs, w_gate, w_up, w_down):
    """xs: (M, D) sorted by group; gs: (E,) group sizes."""
    bounds = [0]
    for n in gs.tolist():
        bounds.append(bounds[-1] + n)
    h = F.silu(_ragged_dot(xs, w_gate, bounds).float())
    u = _ragged_dot(xs, w_up, bounds).float()
    return _ragged_dot((h * u).to(xs.dtype), w_down, bounds)


def dispatch_variant(cfg: ArchConfig, n_tokens: int) -> str:
    """Input-aware dispatch choice, JAX's roofline-style switch:
    ``dense_onehot`` (every expert on every token, combined by the (T, E)
    gate matrix) when its expert FLOPs undercut ``sorted_ragged``'s plus
    its ~5 gather/scatter passes over T·top_k rows, else ``sorted_ragged``."""
    mo = cfg.moe
    dense_flops = 6.0 * n_tokens * mo.n_experts * cfg.d_model * mo.d_expert
    sorted_flops = 6.0 * n_tokens * mo.top_k * cfg.d_model * mo.d_expert
    sorted_overhead = 5.0 * n_tokens * mo.top_k * cfg.d_model * 40  # bytes-ish
    return "dense_onehot" if dense_flops < sorted_flops + sorted_overhead else "sorted_ragged"


def moe_ffn_ref(params, x: torch.Tensor, cfg: ArchConfig, variant: str = "auto") -> torch.Tensor:
    """Single-device MoE with an input-aware dispatch variant."""
    mo = cfg.moe
    b, s, d = x.shape
    t = x.reshape(-1, d)
    n = t.shape[0]
    if variant == "auto":
        variant = dispatch_variant(cfg, n)
    gates, ids = _route(t, params.router, mo.top_k)
    if variant == "dense_onehot":
        # (T, E) combine matrix with the top-k gates scattered in
        comb = torch.zeros((n, mo.n_experts), dtype=torch.float32, device=x.device)
        comb.scatter_(1, ids, gates)
        tf = t.float()
        h = F.silu(torch.einsum("td,edf->tef", tf, params.w_gate.float()))
        u = torch.einsum("td,edf->tef", tf, params.w_up.float())
        y_all = torch.einsum("tef,efd->ted", h * u, params.w_down.float())
        out = torch.einsum("te,ted->td", comb, y_all)
    else:
        eflat = ids.reshape(-1)  # (n*k,)
        order = torch.argsort(eflat, stable=True)
        tok = order // mo.top_k
        xs = t[tok]
        gs = torch.bincount(eflat, minlength=mo.n_experts)
        y = _expert_compute(xs, gs, params.w_gate, params.w_up, params.w_down)
        contrib = y.float() * gates.reshape(-1)[order][:, None]
        out = torch.zeros((n, d), dtype=torch.float32, device=x.device).index_add_(0, tok, contrib)
    out = out.reshape(b, s, d).to(x.dtype)
    if mo.n_shared:
        out = out + swiglu(params.shared, x)
    return out


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MoE FFN on one device: JAX's ``moe_ffn`` with no mesh (or a
    one-device data axis) takes ``moe_ffn_ref``."""
    return moe_ffn_ref(params, x, cfg)
