"""Differentiable scheduled sparse ops: `torch.autograd.Function`s whose
backward passes are scheduled ops in their own right.

Port of repro/core/autodiff.py. The backward of every sparse op is itself
a sparse op with other shapes and an inverted skew (SpMM's backward is an
SDDMM on the forward pattern plus an SpMM on the transpose, whose degrees
are the in-degrees), so each backward op gets its own decision: its own
`InputFeatures`, its own cache key (op strings such as "spmm_bwd_b", with
the cotangent's F) and the full estimate -> probe -> guardrail ->
cache/replay path of `AutoSage.decide`. The op taxonomy lives in
core/features.py, the runtime-valued SpMM family in core/registry.py.

The transposed CSR comes from the memoized `CSR.transpose_with_perm()`,
and `AutoSage.build_runner` memoizes the prepared layout per (graph, op,
choice), so after the first step a training loop converts nothing. The
index arrays the backward needs on the device (rowptr, colind and the
transpose's edge permutation) are uploaded once per graph and device.

Defense in depth, as in the JAX package: when the scheduler's decide or
build_runner raises (a duck-typed scheduler without a fallback chain of
its own; `AutoSage` rescues its decides itself), `_scheduled` serves the
reference oracle (core/resilience.py) and counts the fault and the
fallback. `ReplayMiss` still raises, and so does every fault that
`resilience.must_raise` (a sticky CUDA error; on a card, any fault that
was not injected); AUTOSAGE_RESILIENCE=0 lets every fault raise.

The entry point for users is the `repro_torch.api` facade; models/gnn.py
routes through it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.kernels import ref
from repro_torch.sparse.csr import CSR


def _decide(sched, csr: CSR, f: int, op: str):
    """One scheduled decision; the pipeline-level attention decide when the
    scheduler has one."""
    if op == "attention" and hasattr(sched, "decide_attention"):
        return sched.decide_attention(csr, f)
    return sched.decide(csr, f, op)


def _scheduled(sched, csr: CSR, f: int, op: str, *args):
    """decide + (memoized) prepare + run one scheduled op."""
    kind = "bwd" if "_bwd" in op else "fwd"
    with obs.span(f"{kind}.{op}", op=op):
        try:
            d = _decide(sched, csr, int(f), op)
            runner = sched.build_runner(csr, d)
        except Exception as exc:
            # a step's op must not die on a scheduling fault: the
            # reference oracle is always runnable. ReplayMiss stays loud —
            # the replay contract forbids silent substitution
            from repro_torch.core import resilience
            from repro_torch.core.cache import ReplayMiss

            device = args[-1].device
            if (isinstance(exc, ReplayMiss) or not resilience.enabled()
                    or resilience.must_raise(exc, device)):
                raise
            resilience.record_fault("decide", "", op, exc, device)
            resilience.record_fallback("scheduler", "reference", op, device)
            runner = resilience.reference_runner(csr, op, device)
            with obs.span("run", device, op=op, choice="reference"):
                return runner(*args)
        with obs.span("run", args[-1].device, op=op, choice=d.choice):
            return runner(*args)


def _on_device(csr: CSR, device: torch.device) -> Dict[str, torch.Tensor]:
    """rowptr, colind and the transpose's edge permutation of ``csr`` as
    tensors on ``device``, uploaded once per graph object and device."""
    memo = getattr(csr, "_autodiff_dev_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(csr, "_autodiff_dev_memo", memo)
    hit = memo.get(device)
    if hit is None:
        _, perm = csr.transpose_with_perm()
        hit = memo[device] = {
            "rowptr": torch.from_numpy(np.asarray(csr.rowptr)).to(device),
            "colind": torch.from_numpy(np.asarray(csr.colind)).to(device),
            "perm": torch.from_numpy(perm).to(device),
        }
    return hit


# ----------------------------------------------------------------- SpMM
class _SpMM(torch.autograd.Function):
    """A's values baked (the GNN training path): the only cotangent is
    grad_B, one scheduled SpMM on the transpose ("spmm_bwd_b")."""

    @staticmethod
    def forward(ctx, b, sched, csr):
        ctx.sched, ctx.csr = sched, csr
        return _scheduled(sched, csr, b.shape[1], "spmm", b)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        t, _ = ctx.csr.transpose_with_perm()
        gb = _scheduled(ctx.sched, t, g.shape[1], "spmm_bwd_b", g)
        return gb, None, None


class _SpMMVals(torch.autograd.Function):
    """Runtime edge values: grad_vals is a scheduled SDDMM on the forward
    pattern ("spmm_bwd_vals"), grad_B a runtime-valued SpMM on the
    transpose ("spmm_bwd_b_dyn") with the permuted values."""

    @staticmethod
    def forward(ctx, vals, b, sched, s):
        ctx.sched, ctx.s = sched, s
        ctx.save_for_backward(vals, b)
        return _scheduled(sched, s, b.shape[1], "spmm_dyn", vals, b)

    @staticmethod
    def backward(ctx, g):
        vals, b = ctx.saved_tensors
        g = g.contiguous()
        sched, s = ctx.sched, ctx.s
        gv = _scheduled(sched, s, b.shape[1], "spmm_bwd_vals", g, b)
        t, _ = s.transpose_with_perm()
        perm = _on_device(s, g.device)["perm"]
        gb = _scheduled(sched, t, g.shape[1], "spmm_bwd_b_dyn", vals[perm], g)
        return gv.to(vals.dtype), gb.to(b.dtype), None, None


def spmm(csr: CSR, b: torch.Tensor, *, sched, vals: Optional[torch.Tensor] = None):
    """C = A @ B through the scheduler, differentiable.

    vals=None: A's stored values are constants; the forward runs "spmm"
    and the backward "spmm_bwd_b" on the memoized transpose. vals given:
    runtime edge values (e.g. learned edge weights) overriding A's; the
    forward runs "spmm_dyn" and both cotangents flow."""
    if vals is None:
        return _SpMM.apply(b, sched, csr)
    return _SpMMVals.apply(vals, b, sched, csr.structural())


# ---------------------------------------------------------------- SDDMM
class _SDDMM(torch.autograd.Function):
    """The per-edge cotangent scatters through the pattern: grad_X =
    A(g) @ Y ("sddmm_bwd_x"), grad_Y = A^T(g) @ X ("sddmm_bwd_y"), both
    runtime-valued SpMMs."""

    @staticmethod
    def forward(ctx, x, y, sched, s):
        ctx.sched, ctx.s = sched, s
        ctx.save_for_backward(x, y)
        return _scheduled(sched, s, x.shape[1], "sddmm", x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()
        sched, s = ctx.sched, ctx.s
        gx = _scheduled(sched, s, y.shape[1], "sddmm_bwd_x", g, y)
        t, _ = s.transpose_with_perm()
        perm = _on_device(s, g.device)["perm"]
        gy = _scheduled(sched, t, x.shape[1], "sddmm_bwd_y", g[perm], x)
        return gx.to(x.dtype), gy.to(y.dtype), None, None


def sddmm(csr: CSR, x: torch.Tensor, y: torch.Tensor, *, sched):
    """Per-edge <X_i, Y_j> on S(A) through the scheduler, differentiable."""
    return _SDDMM.apply(x, y, sched, csr.structural())


# ------------------------------------------------------------ attention
class _Attention(torch.autograd.Function):
    """The forward is the joint "attention" decision. There is no fused
    backward kernel, so the backward decomposes into its sparse pieces,
    each scheduled: the logits recompute and the gradient of the probs
    are pattern-only SDDMMs ("attention_bwd_e", "attention_bwd_p"), the
    q, k, v gradients runtime-valued SpMMs ("attention_bwd_q/_k/_v")
    whose values are the probs or the softmax VJP's output; the softmax
    VJP itself is a segment op. Scale is the default 1/sqrt(d). The
    softmax recompute and its VJP are spans of their own
    (``softmax.recompute``, ``softmax.vjp``) with their device time; the
    permutation gathers ``probs[perm]`` and ``gl[perm]`` lie outside
    every span that takes device time."""

    @staticmethod
    def forward(ctx, q, k, v, sched, s):
        ctx.sched, ctx.s = sched, s
        ctx.save_for_backward(q, k, v)
        return _scheduled(sched, s, q.shape[1], "attention", q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.contiguous()
        sched, s = ctx.sched, ctx.s
        scale = 1.0 / (q.shape[-1] ** 0.5)
        dev = _on_device(s, g.device)
        rowptr, colind, perm = dev["rowptr"], dev["colind"], dev["perm"]
        # recompute the probs (the fused forward never materializes them)
        e = _scheduled(sched, s, q.shape[1], "attention_bwd_e", q, k)
        with obs.span("softmax.recompute", g.device, op="attention"):
            probs = ref.row_softmax_ref(rowptr, colind, e * scale)
        del e
        t, _ = s.transpose_with_perm()
        # grad_V = A^T(probs) @ g
        gv = _scheduled(sched, t, g.shape[1], "attention_bwd_v", probs[perm], g)
        # grad w.r.t. probs: per-edge <g_i, V_j>, then the softmax VJP
        gp = _scheduled(sched, s, g.shape[1], "attention_bwd_p", g, v)
        with obs.span("softmax.vjp", g.device, op="attention"):
            gl = ref.row_softmax_bwd_ref(rowptr, colind, probs, gp) * scale
        del gp, probs
        gq = _scheduled(sched, s, k.shape[1], "attention_bwd_q", gl, k)
        gk = _scheduled(sched, t, q.shape[1], "attention_bwd_k", gl[perm], q)
        return gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), None, None


def attention(csr: CSR, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sched):
    """CSR attention (SDDMM -> row softmax -> SpMM) through the
    pipeline-level scheduler, differentiable."""
    return _Attention.apply(q, k, v, sched, csr.structural())
