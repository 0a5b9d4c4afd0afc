"""The public functional surface for scheduled sparse ops.

Port of repro/api.py: graph first, dense operands next, scheduler and
options keyword-only.

    from repro_torch import api
    c = api.spmm(csr, b, sage=sage)            # scheduled + differentiable
    e = api.sddmm(csr, x, y, sage=sage)
    out = api.attention(csr, q, k, v, sage=sage)

Routing, per call:

- ``sage=None`` — the plain-torch reference oracles (kernels/ref.py) on
  the operands' device, differentiable: their backward is the explicit,
  chunked backward oracles (``spmm_bwd_ref``, ``sddmm_bwd_ref``,
  ``csr_attention_bwd_ref``), so a reference gradient at Reddit scale
  keeps no gathered chunk alive (autograd through the forward oracles
  would hold 28 GB per gathered operand at Reddit-0.25, F = 256).
- ``sage`` given, ``differentiable=True`` (the default) — the
  `torch.autograd.Function`s of core/autodiff.py: forward AND backward
  each run as scheduled ops with their own cache keys ("spmm" and
  "spmm_bwd_b" are distinct decisions).
- ``sage`` given, ``differentiable=False`` — forward-only scheduling
  (decide + memoized runner), for inference.

``sage`` is anything exposing ``decide(csr, f, op)`` and
``build_runner(csr, decision)``, e.g. `repro_torch.core.AutoSage`;
attention goes to its pipeline-level ``decide_attention`` when it has one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autodiff
from repro_torch.kernels import ref
from repro_torch.sparse.csr import CSR

__all__ = ["spmm", "sddmm", "attention"]


def _index(csr: CSR, device: torch.device) -> tuple:
    return (torch.from_numpy(csr.rowptr).to(device),
            torch.from_numpy(csr.colind).to(device))


class _RefSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, b, rowptr, colind):
        ctx.save_for_backward(vals, b, rowptr, colind)
        return ref.spmm_ref(rowptr, colind, vals, b)

    @staticmethod
    def backward(ctx, g):
        vals, b, rowptr, colind = ctx.saved_tensors
        gv, gb = ref.spmm_bwd_ref(rowptr, colind, vals, b, g.contiguous(),
                                  want_val=ctx.needs_input_grad[0])
        return gv, gb, None, None


class _RefSDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, rowptr, colind):
        ctx.save_for_backward(x, y, rowptr, colind)
        return ref.sddmm_ref(rowptr, colind, x, y)

    @staticmethod
    def backward(ctx, g):
        x, y, rowptr, colind = ctx.saved_tensors
        gx, gy = ref.sddmm_bwd_ref(rowptr, colind, x, y, g.contiguous())
        return gx, gy, None, None


class _RefAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rowptr, colind, scale):
        ctx.save_for_backward(q, k, v, rowptr, colind)
        ctx.scale = scale
        return ref.csr_attention_ref(rowptr, colind, q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rowptr, colind = ctx.saved_tensors
        gq, gk, gv = ref.csr_attention_bwd_ref(rowptr, colind, q, k, v, g.contiguous(),
                                               ctx.scale)
        return gq, gk, gv, None, None, None


def spmm(
    csr: CSR,
    b: torch.Tensor,
    *,
    sage=None,
    vals: Optional[torch.Tensor] = None,
    differentiable: bool = True,
) -> torch.Tensor:
    """C = A @ B for CSR A (n_rows x n_cols), dense B (n_cols x F).

    ``vals``: optional runtime edge values (a tensor in CSR edge order,
    e.g. learned edge weights) overriding A's stored values; gradients
    flow to them. Without it, A's values are constants and only grad_B
    flows."""
    if sage is None:
        if vals is None and csr.val is not None:
            vals = torch.from_numpy(csr.values_or_ones(csr.val.dtype)).to(b.device)
        return _RefSpMM.apply(vals, b, *_index(csr, b.device))
    if differentiable:
        return autodiff.spmm(csr, b, sched=sage, vals=vals)
    if vals is not None:
        return autodiff._scheduled(sage, csr.structural(), b.shape[1], "spmm_dyn", vals, b)
    return autodiff._scheduled(sage, csr, b.shape[1], "spmm", b)


def sddmm(
    csr: CSR,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    sage=None,
    differentiable: bool = True,
) -> torch.Tensor:
    """A~_ij = <X_i, Y_j> for (i, j) in S(A); the CSR-ordered nnz vector.
    Reads the sparsity pattern only."""
    if sage is None:
        return _RefSDDMM.apply(x, y, *_index(csr, x.device))
    if differentiable:
        return autodiff.sddmm(csr, x, y, sched=sage)
    return autodiff._scheduled(sage, csr.structural(), x.shape[1], "sddmm", x, y)


def attention(
    csr: CSR,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sage=None,
    scale: Optional[float] = None,
    differentiable: bool = True,
) -> torch.Tensor:
    """CSR attention: SDDMM -> row-softmax -> SpMM on S(A).

    The scheduled path makes one joint pipeline-level decision (composed
    3-stage candidates vs the fused CUDA kernels) and assumes the default
    ``scale = 1/sqrt(d)``; a custom ``scale`` routes to the reference
    pipeline (still differentiable), since the scheduled candidates bake
    the default. Attention reads the sparsity pattern only: stored values
    are ignored, and a graph with duplicate edges keeps the fused kernels
    out of the pool (deduplicate it with ``csr.dedup_edges()`` first)."""
    if sage is None or scale is not None:
        return _RefAttention.apply(q, k, v, *_index(csr, q.device), scale)
    if differentiable:
        return autodiff.attention(csr, q, k, v, sched=sage)
    return autodiff._scheduled(sage, csr.structural(), q.shape[1], "attention", q, k, v)
