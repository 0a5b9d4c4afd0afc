"""Mixture-of-Experts FFN (port of repro/models/moe.py).

Two paths, selected by whether a mesh is given:

* ``moe_ffn_ref``: one device, sort + grouped GEMMs (also the oracle),
  with its input-aware dispatch variant;
* ``moe_ffn_ep``: expert parallel over a process mesh. Each rank holds
  its slice of the experts, (n_experts / data, d, d_expert / model) as
  ``moe_param_specs`` says, and its own tokens; token copies go to the
  experts' owners over 'data' in fixed-capacity buffers (all-to-all),
  are grouped by a second sort, multiplied, summed over 'model' and
  sent back. Overflowing copies are dropped (``capacity_factor``,
  Switch-style).

JAX's ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per expert
over its group of sorted token copies; rows past the last group come
out as zeros, as ragged_dot leaves them.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import mesh_shape
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
    one product per non-empty group, concatenated, then zero rows for
    the rows past the last group (differentiable)."""
    parts = [x[bounds[e]:bounds[e + 1]] @ w[e].to(x.dtype)
             for e in range(w.shape[0]) if bounds[e + 1] > bounds[e]]
    if bounds[-1] < x.shape[0]:
        parts.append(x.new_zeros((x.shape[0] - bounds[-1], w.shape[-1])))
    return torch.cat(parts)


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


# ------------------------------------------------------------------- EP
def moe_param_specs(cfg: ArchConfig, data_axis="data", model_axis="model") -> Dict:
    """Specs for EP: experts over 'data', expert-hidden over 'model';
    router replicated; shared experts TP over 'model'."""
    specs: Dict = {
        "router": (None, None),
        "w_gate": (data_axis, None, model_axis),
        "w_up": (data_axis, None, model_axis),
        "w_down": (data_axis, model_axis, None),
    }
    if cfg.moe and cfg.moe.n_shared:
        specs["shared"] = {
            "w_gate": (None, model_axis),
            "w_up": (None, model_axis),
            "w_down": (model_axis, None),
        }
    return specs


def ep_active(cfg: ArchConfig, mesh, data_axis: str = "data") -> bool:
    """Whether ``moe_ffn`` takes the expert-parallel path on ``mesh``: a
    'data' axis of more than one rank that divides the experts."""
    if mesh is None:
        return False
    n_data = mesh_shape(mesh).get(data_axis, 1)
    return n_data > 1 and cfg.moe.n_experts % n_data == 0


def capacity(n_tokens: int, top_k: int, n_data: int, capacity_factor: float) -> int:
    """Slots per destination rank in the dispatch buffers."""
    return int(math.ceil(n_tokens * top_k / n_data * capacity_factor))


def dispatch_plan(eflat: torch.Tensor, e_loc: int, n_data: int, cap: int):
    """Where each token copy goes: ``eflat`` (n·k expert ids) stably sorted
    (``order``, ``e_sorted``), each sorted copy's destination rank
    ``dest`` and ``slot`` in its buffer (copies past ``cap`` are not
    kept and point at slot cap - 1), ``keep``, and ``written``: the
    copies whose row the buffer holds.

    JAX scatters every sorted copy to (dest, slot) in order, the dropped
    ones as zeros with the pad expert id, and its CPU scatter keeps the
    last write: in a destination that overflows, slot cap - 1 ends up
    empty and the kept copy sorted into it gets nothing back. A scatter
    with repeated indices has no defined order on a card, so the plan
    says so explicitly: that copy is kept but not written."""
    n = eflat.shape[0]
    order = torch.argsort(eflat, stable=True)
    e_sorted = eflat[order]
    dest = torch.div(e_sorted, e_loc, rounding_mode="floor")  # sorted, as e_sorted is
    idx_in_dest = torch.arange(n, device=eflat.device) - torch.searchsorted(dest, dest)
    keep = idx_in_dest < cap
    slot = torch.where(keep, idx_in_dest, torch.full_like(idx_in_dest, cap - 1))
    overflow = torch.bincount(dest, minlength=n_data) > cap
    written = keep & ~(overflow[dest] & (slot == cap - 1))
    return order, e_sorted, dest, slot, keep, written


def moe_ffn_ep(
    params,
    x: torch.Tensor,
    cfg: ArchConfig,
    mesh,
    capacity_factor: float = 1.25,
    data_axis: str = "data",
    model_axis: str = "model",
) -> torch.Tensor:
    """Expert-parallel MoE forward on this rank (see the module docstring):
    ``x`` (B_loc, S, D) is this rank's tokens, ``params`` its slices of
    the experts (``moe_param_specs``) with the router and any shared
    expert whole. Ranks along 'model' hold the same tokens. The output
    is this rank's tokens' (B_loc, S, D)."""
    mo = cfg.moe
    n_data = mesh_shape(mesh)[data_axis]
    e_loc = mo.n_experts // n_data
    if e_loc * n_data != mo.n_experts or params.w_gate.shape[0] != e_loc:
        raise ValueError(f"{mo.n_experts} experts over {n_data} data ranks: each rank must hold "
                         f"{mo.n_experts / n_data} of them, not {params.w_gate.shape[0]}")
    compact = os.environ.get("REPRO_MOE_COMPACT") == "1"
    b_loc, s, d = x.shape
    t = x.reshape(-1, d)
    n, k = t.shape[0], mo.top_k
    gates, ids = _route(t, params.router, k)
    gflat = gates.reshape(-1)
    cap = capacity(n, k, n_data, capacity_factor)
    order, e_sorted, dest, slot, keep, written = dispatch_plan(ids.reshape(-1), e_loc, n_data, cap)
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    cell = dest * cap + slot  # (dest, slot) in the flat (n_data * cap) buffer
    send_x = t.new_zeros((n_data * cap, d)).index_copy(0, cell[written], t[tok_sorted[written]])
    send_e = torch.full((n_data * cap,), e_loc, dtype=torch.int32, device=x.device)  # pad id
    send_e = send_e.index_copy(0, cell[written], (e_sorted[written] % e_loc).to(torch.int32))

    recv_x = collectives.all_to_all(send_x, mesh, data_axis)
    recv_e = collectives.all_to_all(send_e, mesh, data_axis)

    # group the received copies by local expert (the pad id e_loc sorts last)
    order2 = torch.argsort(recv_e, stable=True)
    # every 'model' rank multiplies the same copies by its slice of the
    # experts: the gradient of the copies is the sum of the slices'
    xs = collectives.psum_grad(recv_x[order2], mesh, model_axis)
    gs = torch.bincount(recv_e[order2], minlength=e_loc + 1)[:e_loc]
    y = _expert_compute(xs, gs, params.w_gate, params.w_up, params.w_down)
    if compact:
        # bf16 partial-sum exchange over the TP axis
        y = y.to(x.dtype)
    y = collectives.psum(y, mesh, model_axis)  # TP over the expert hidden dim
    # unsort back to (n_data, cap, D) and return to the senders;
    # REPRO_MOE_COMPACT=1: return buffers in the activations' dtype, the
    # gate-weighted combine still in fp32
    back_dt = x.dtype if compact else torch.float32
    y_back = torch.zeros((n_data * cap, d), dtype=back_dt, device=x.device)
    y_back = y_back.index_copy(0, order2, y.to(back_dt))
    back = collectives.all_to_all(y_back, mesh, data_axis).float()
    # combine: the copy at (dest, slot) belongs to sorted position i
    contrib = back[cell] * torch.where(keep, gflat[order], torch.zeros_like(gflat))[:, None]
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device).index_add(0, tok_sorted,
                                                                              contrib)
    out = out.reshape(b_loc, s, d).to(x.dtype)
    if mo.n_shared:
        out = out + swiglu(params.shared, x)
    return out


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig, mesh=None, **kw) -> torch.Tensor:
    """The MoE FFN: ``moe_ffn_ref`` without a mesh or where the mesh's
    'data' axis is one rank or does not divide the experts, else
    ``moe_ffn_ep`` with ``REPRO_MOE_CF`` as its capacity factor (default
    1.25)."""
    if not ep_active(cfg, mesh):
        return moe_ffn_ref(params, x, cfg)
    kw.setdefault("capacity_factor", float(os.environ.get("REPRO_MOE_CF", "1.25")))
    return moe_ffn_ep(params, x, cfg, mesh, **kw)
