"""The public functional surface for scheduled sparse ops.

Port of repro/api.py for SpMM and CSR attention:

    from repro_torch import api
    c = api.spmm(csr, b)                                   # reference
    c = api.spmm(csr, b, sage=sage, differentiable=False)  # scheduled
    out = api.attention(csr, q, k, v, sage=sage, differentiable=False)

Routing, per call:

- ``sage=None`` — the plain-torch reference (kernels/ref.py) on
  ``b.device``, differentiable through torch autograd.
- ``sage`` given, ``differentiable=False`` — forward-only scheduling
  (decide + memoized runner), as `repro.core.autodiff._scheduled` does.
- ``sage`` given, ``differentiable=True`` (the default, as in `repro`)
  raises NotImplementedError: the scheduled backward ops are ROADMAP.md
  Queue 1 item 5, and the port never drops a gradient silently.

``sage`` is anything exposing ``decide(csr, f, op)`` and
``build_runner(csr, decision)``, e.g. `repro_torch.core.AutoSage`;
attention goes to its pipeline-level ``decide_attention`` when it has one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import obs
from repro_torch.kernels import ref
from repro_torch.sparse.csr import CSR

__all__ = ["spmm", "attention"]


def _decide(sched, csr: CSR, f: int, op: str):
    """One scheduled decision; the pipeline-level attention decide when
    the scheduler has one."""
    if op == "attention" and hasattr(sched, "decide_attention"):
        return sched.decide_attention(csr, f)
    return sched.decide(csr, f, op)


def _scheduled(sched, csr: CSR, f: int, op: str, *args):
    """decide + (memoized) prepare + run one scheduled op."""
    with obs.span(f"fwd.{op}", op=op):
        d = _decide(sched, csr, int(f), op)
        runner = sched.build_runner(csr, d)
        with obs.span("run", op=op, choice=d.choice):
            return runner(*args)


def spmm(
    csr: CSR,
    b: torch.Tensor,
    *,
    sage=None,
    differentiable: bool = True,
) -> torch.Tensor:
    """C = A @ B for CSR A (n_rows x n_cols), dense B (n_cols x F)."""
    if sage is None:
        dev = b.device
        val = None if csr.val is None else torch.from_numpy(
            csr.values_or_ones(csr.val.dtype)
        ).to(dev)
        return ref.spmm_ref(
            torch.from_numpy(csr.rowptr).to(dev),
            torch.from_numpy(csr.colind).to(dev),
            val,
            b,
        )
    if differentiable:
        raise NotImplementedError(
            "scheduled SpMM with gradients is not ported yet (ROADMAP.md "
            "Queue 1 item 5: differentiable facade and SAGE training); pass "
            "differentiable=False for a forward-only call"
        )
    return _scheduled(sage, csr, b.shape[1], "spmm", b)


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
    pipeline, since the scheduled candidates bake the default. Attention
    reads the sparsity pattern only: stored values are ignored, and a
    graph with duplicate edges keeps the fused kernels out of the pool
    (deduplicate it with ``csr.dedup_edges()`` first)."""
    if sage is None or scale is not None:
        dev = q.device
        return ref.csr_attention_ref(
            torch.from_numpy(csr.rowptr).to(dev),
            torch.from_numpy(csr.colind).to(dev),
            q, k, v, scale,
        )
    if differentiable:
        raise NotImplementedError(
            "scheduled attention with gradients is not ported yet (ROADMAP.md "
            "Queue 1 item 6: the attention backward ops); pass "
            "differentiable=False for a forward-only call"
        )
    return _scheduled(sage, csr.structural(), q.shape[1], "attention", q, k, v)
