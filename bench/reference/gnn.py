"""Plain fp32 PyTorch reference of the attention cells' training step.

Independent of the program: it reads the graph's raw CSR arrays and the
initial weights that the benchmark made, and works out the row softmax
and the attention's products again, as gathers and index sums chunked
so that a gathered operand holds at most 2**27 values. In fp32 every
product computes with TF32 off. For the control (``precision="tf32"``)
every operand of every product, forward and backward, is rounded to
TF32 first, which is what a tensor core does to fp32 operands when TF32
is allowed: the dense projections (`mm`), the SDDMM's q·k logits and
the SpMM's P·V, whose backward products take the rounded operands and
the rounded incoming gradient (`operand`, `result`). ``"tf32_sparse"``
rounds the sparse products alone: a lower-precision SDDMM, SpMM or
attention kernel under exact projections.

A loss function returns (loss, gradients by weight name); `sgd` runs
steps of p -= lr * grad over it, as the program's ``sgd_step`` does.
``keep_rows`` restricts the loss's mean to the first rows: the fault
"half of the batch left out".
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CHUNK_ELEMS = 1 << 27
# fp32; TF32 in every product; TF32 in the attention's sparse products
# alone (SDDMM, P·V), the dense projections in fp32
PRECISIONS = ("fp32", "tf32", "tf32_sparse")


@contextlib.contextmanager
def fp32_matmul():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest even at TF32's 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


class _Operand(torch.autograd.Function):
    """A product's operand in TF32: rounded; its gradient passes on."""

    @staticmethod
    def forward(ctx, t):
        return tf32_round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """A product's result: unchanged; the gradient that comes back into
    it, an operand of the backward's products, is rounded to TF32."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    return _Operand.apply(t) if precision == "tf32" else t


def result(t: torch.Tensor, precision: str) -> torch.Tensor:
    return _Result.apply(t) if precision == "tf32" else t


def _parts(precision: str) -> Tuple[str, str]:
    """(dense, sparse): the precision of the projections and of the
    attention's sparse products."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return ("tf32" if precision == "tf32" else "fp32",
            "fp32" if precision == "fp32" else "tf32")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _TF32MM.apply(a, b)
    if precision != "fp32":
        raise ValueError(f"precision {precision!r}: a product is fp32 or tf32")
    return a @ b


class Pattern:
    """A CSR pattern on the device with its per-edge rows and row chunks."""

    def __init__(self, rowptr: torch.Tensor, colind: torch.Tensor, n_cols: int):
        self.rowptr = rowptr.to(torch.int64)
        self.colind = colind.to(torch.int64)
        self.n_rows = int(rowptr.shape[0]) - 1
        self.n_cols = int(n_cols)
        self.rows = torch.repeat_interleave(
            torch.arange(self.n_rows, device=rowptr.device), self.rowptr.diff())
        self._rp = self.rowptr.cpu().numpy()

    def chunks(self, per_edge: int) -> List[Tuple[int, int, int, int]]:
        """(r0, r1, e0, e1): runs of rows whose edges times ``per_edge``
        stay within CHUNK_ELEMS (at least one row each)."""
        budget = max(1, CHUNK_ELEMS // max(per_edge, 1))
        out, r0, rp = [], 0, self._rp
        while r0 < self.n_rows:
            r1 = int(np.searchsorted(rp, rp[r0] + budget, side="right")) - 1
            r1 = min(max(r1, r0 + 1), self.n_rows)
            out.append((r0, r1, int(rp[r0]), int(rp[r1])))
            r0 = r1
        return out

def _grads(loss: torch.Tensor, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(weights)
    gs = torch.autograd.grad(loss, [weights[n] for n in names])
    return dict(zip(names, gs))


def _leaves(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}


def _attention_rows(p: Pattern, q, k, v, r0, r1, e0, e1, precision: str = "fp32"):
    """Rows r0:r1 of softmax(q k^T / sqrt(d) on the pattern) @ v."""
    local = p.rows[e0:e1] - r0
    cols = p.colind[e0:e1]
    qi = operand(q[r0:r1].index_select(0, local), precision)
    s = result((qi * operand(k.index_select(0, cols), precision)).sum(-1), precision)
    s = s * q.shape[1] ** -0.5
    with torch.no_grad():  # a constant shift: the softmax's gradient is unchanged
        m = torch.full((r1 - r0,), float("-inf"), device=q.device).scatter_reduce(
            0, local, s, "amax")
    e = torch.exp(s - m[local])
    den = torch.zeros(r1 - r0, device=q.device).index_add(0, local, e)
    prob = e / den[local]
    pv = operand(prob, precision)[:, None] * operand(v.index_select(0, cols), precision)
    return result(torch.zeros(r1 - r0, v.shape[1], device=q.device).index_add(0, local, pv),
                  precision)


def gat_loss(p: Pattern, x: torch.Tensor, precision: str = "fp32",
             keep_rows: Optional[int] = None) -> Callable:
    """One dot-product graph-attention layer, out = softmax_row(q k^T /
    sqrt(d)) v over the pattern with q, k, v = x W_q, x W_k, x W_v, and
    the loss 0.5 * mean over rows of |out_i|^2. The attention runs in
    row chunks, each with its own backward into q, k and v. With
    ``keep_rows`` only the first rows enter the mean."""
    n = p.n_rows if keep_rows is None else keep_rows
    dense, sparse = _parts(precision)

    def loss_fn(weights):
        w = _leaves(weights)
        q, k, v = (mm(x, w[name], dense) for name in ("wq", "wk", "wv"))
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
        loss = torch.zeros((), device=x.device)
        for r0, r1, e0, e1 in p.chunks(3 * q.shape[1]):
            if r0 >= n:
                break
            r1 = min(r1, n)
            e1 = int(p._rp[r1])
            out = _attention_rows(p, qd, kd, vd, r0, r1, e0, e1, sparse)
            part = 0.5 * (out * out).sum() / n
            part.backward()
            loss += part.detach()
        gs = torch.autograd.grad([q, k, v], [w[nm] for nm in ("wq", "wk", "wv")],
                                 grad_outputs=[qd.grad, kd.grad, vd.grad])
        return loss, dict(zip(("wq", "wk", "wv"), gs))

    return loss_fn


def sgd(loss_fns: List[Callable], weights: Dict[str, torch.Tensor], lr: float
        ) -> Tuple[List[float], List[Dict[str, torch.Tensor]]]:
    """One SGD step per loss function (p -= lr * grad, in fp32): the
    losses before each update and the weights after each."""
    w = {n: t.detach().clone() for n, t in weights.items()}
    losses, states = [], []
    with fp32_matmul():
        for fn in loss_fns:
            loss, grads = fn(w)
            with torch.no_grad():
                for n in w:
                    w[n] = w[n] - lr * grads[n]
            losses.append(float(loss))
            states.append({n: t.clone() for n, t in w.items()})
    return losses, states
