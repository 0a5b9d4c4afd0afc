"""Plain-torch oracles: ground truth for the tests, the guardrail
baselines' semantics, the plain versions the CUDA kernels are held
against, and the reference gradients of training on the card.

Port of repro/kernels/ref.py (SpMM, SDDMM, row softmax, CSR attention,
their closed-form backward oracles and the block-ELL, ragged and
merge-path layout oracles), with the same signatures. The backward
oracles are explicit VJPs, not autograd through the forward ones:
autograd would keep every gathered chunk alive for the backward (three
28 GB operands for attention at Reddit-0.25, D = 256). Each oracle works in chunks of rows, row blocks or slots, so
its memory stays bounded at Reddit scale: the JAX oracle's one-shot
gather ``b_blocks[slot_colblk]`` would build an (S, bc, F) array of
163 GB there, and ``sddmm_ref``'s ``x[rows]`` / ``y[colind]`` 28 GB each
at 27.8 M edges and F = 256. The CSR oracles reduce each row with
``torch.segment_reduce`` over the sorted CSR rows, so they give the same
bits on every run; the layout oracles use ``index_add_``, whose CUDA
atomics may change the last bits between runs.

CSR device representation: rowptr int32[n+1], colind int32[nnz],
val float[nnz] (or None => ones).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# elements of the largest gathered intermediate per chunk (512 MB fp32)
CHUNK_ELEMS = 1 << 27


def spmm_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    val: Optional[torch.Tensor],
    b: torch.Tensor,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """C = A @ B for CSR A (n_rows x n_cols), dense B (n_cols x F)."""
    n_rows = rowptr.shape[0] - 1
    f = b.shape[1]
    out = torch.zeros((n_rows, f), dtype=b.dtype, device=b.device)
    for r, r_hi, lo, hi in _row_chunks(rowptr, f, chunk_elems):
        g = b.index_select(0, colind[lo:hi])
        if val is not None:
            g.mul_(val[lo:hi, None].to(b.dtype))
        offsets = rowptr[r : r_hi + 1].to(torch.int64) - lo
        out[r:r_hi] = torch.segment_reduce(g, "sum", offsets=offsets, axis=0)
    return out


def _row_chunks(rowptr: torch.Tensor, per_edge: int, chunk_elems: int):
    """Yield (r, r_hi, lo, hi): the longest runs of rows whose edges
    times ``per_edge`` fit ``chunk_elems`` (>= 1 row each), skipping runs
    without edges; lo:hi is the runs' edge range."""
    n_rows = rowptr.shape[0] - 1
    rp = rowptr.cpu().numpy().astype(np.int64)
    budget = max(1, chunk_elems // max(per_edge, 1))
    r = 0
    while r < n_rows:
        r_hi = int(np.searchsorted(rp, rp[r] + budget, side="right")) - 1
        r_hi = min(max(r_hi, r + 1), n_rows)
        if rp[r_hi] > rp[r]:
            yield r, r_hi, int(rp[r]), int(rp[r_hi])
        r = r_hi


def _edge_rows(rowptr: torch.Tensor, r: int, r_hi: int) -> torch.Tensor:
    """Row id of every edge of rows r..r_hi-1."""
    deg = torch.diff(rowptr[r : r_hi + 1].to(torch.int64))
    return torch.repeat_interleave(
        torch.arange(r, r_hi, device=rowptr.device), deg
    )


def sddmm_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """A~_ij = <X_i, Y_j> for (i,j) in S(A); returns val-vector[nnz]."""
    out = torch.zeros(colind.shape[0], dtype=torch.result_type(x, y), device=x.device)
    for r, r_hi, lo, hi in _row_chunks(rowptr, x.shape[1], chunk_elems):
        g = x.index_select(0, _edge_rows(rowptr, r, r_hi))
        g.mul_(y.index_select(0, colind[lo:hi]))
        out[lo:hi] = g.sum(-1)
    return out


def row_softmax_ref(
    rowptr: torch.Tensor, colind: torch.Tensor, val: torch.Tensor
) -> torch.Tensor:
    """Numerically stable softmax within each CSR row (over its nnz).
    Works on the nnz vector whole: its intermediates are nnz-sized."""
    offsets = rowptr.to(torch.int64)
    rows = _edge_rows(rowptr, 0, rowptr.shape[0] - 1)
    row_max = torch.segment_reduce(val, "max", offsets=offsets, axis=0)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    shifted = torch.exp(val - row_max[rows])
    denom = torch.segment_reduce(shifted, "sum", offsets=offsets, axis=0)
    return shifted / torch.clamp(denom[rows], min=1e-30)


def csr_attention_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """SDDMM -> row-softmax -> SpMM (the paper's pipeline, §8.7)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = sddmm_ref(rowptr, colind, q, k, chunk_elems) * scale
    probs = row_softmax_ref(rowptr, colind, logits)
    return spmm_ref(rowptr, colind, probs, v, chunk_elems)


# ---- backward oracles (ground truth for core/autodiff.py) ------------
# Closed-form VJPs of the forward oracles. SpMM's backward is an SDDMM
# (grad w.r.t. vals) plus a transposed SpMM (grad w.r.t. B), the latter
# a scatter over colind, which is A^T @ grad without building A^T.
def _scatter_cols(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    w: Optional[torch.Tensor],
    x: torch.Tensor,
    n_out: int,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """out[j] = sum over edges (i, j) of w_ij * x_i  (A(w)^T @ x)."""
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    for r, r_hi, lo, hi in _row_chunks(rowptr, x.shape[1], chunk_elems):
        g = x.index_select(0, _edge_rows(rowptr, r, r_hi))
        if w is not None:
            g.mul_(w[lo:hi, None].to(x.dtype))
        out.index_add_(0, colind[lo:hi].long(), g)
    return out


def spmm_bwd_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    val: Optional[torch.Tensor],
    b: torch.Tensor,
    grad_c: torch.Tensor,
    chunk_elems: int = CHUNK_ELEMS,
    want_val: bool = True,
) -> tuple:
    """VJP of spmm_ref w.r.t. (val, b): returns (grad_val[nnz], grad_b);
    grad_val is None when ``want_val`` is false."""
    # dL/dval_ij = <grad_C_i, B_j>  (an SDDMM on the forward pattern)
    grad_val = sddmm_ref(rowptr, colind, grad_c, b, chunk_elems) if want_val else None
    # dL/dB_j = sum_i val_ij * grad_C_i  (SpMM on the transposed CSR)
    grad_b = _scatter_cols(rowptr, colind, val, grad_c, b.shape[0], chunk_elems)
    return grad_val, grad_b


def sddmm_bwd_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    grad_e: torch.Tensor,
    chunk_elems: int = CHUNK_ELEMS,
) -> tuple:
    """VJP of sddmm_ref w.r.t. (x, y): two SpMMs whose sparse values are
    the per-edge cotangent — one on A, one on A^T."""
    g = grad_e.to(x.dtype)
    grad_x = spmm_ref(rowptr, colind, g, y, chunk_elems)
    grad_y = _scatter_cols(rowptr, colind, g, x, y.shape[0], chunk_elems)
    return grad_x, grad_y


def row_softmax_bwd_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    probs: torch.Tensor,
    grad_probs: torch.Tensor,
) -> torch.Tensor:
    """VJP of row_softmax_ref given its *output* probs: per row,
    grad_logits = p * (grad_p - <p, grad_p>)."""
    rows = _edge_rows(rowptr, 0, rowptr.shape[0] - 1)
    tmp = probs * grad_probs
    row_dot = torch.segment_reduce(tmp, "sum", offsets=rowptr.to(torch.int64), axis=0)
    return tmp - probs * row_dot[rows]


def csr_attention_bwd_ref(
    rowptr: torch.Tensor,
    colind: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    grad_out: torch.Tensor,
    scale: Optional[float] = None,
    chunk_elems: int = CHUNK_ELEMS,
) -> tuple:
    """VJP of csr_attention_ref w.r.t. (q, k, v): recompute probs, then
    compose the spmm/sddmm/softmax backward pieces."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = sddmm_ref(rowptr, colind, q, k, chunk_elems) * scale
    probs = row_softmax_ref(rowptr, colind, logits)
    del logits
    # out = SpMM(A(probs), v): grads w.r.t. probs (per edge) and v
    grad_probs, grad_v = spmm_bwd_ref(rowptr, colind, probs, v, grad_out, chunk_elems)
    grad_logits = row_softmax_bwd_ref(rowptr, colind, probs, grad_probs)
    del grad_probs
    grad_q, grad_k = sddmm_bwd_ref(rowptr, colind, q, k, grad_logits * scale,
                                   chunk_elems)
    return grad_q, grad_k, grad_v


def _b_blocks(b: torch.Tensor, bc: int) -> torch.Tensor:
    """B as (n_col_blocks, bc, F), zero-padded to a multiple of bc rows."""
    pad = (-b.shape[0]) % bc
    if pad:
        b = torch.cat([b, b.new_zeros((pad, b.shape[1]))])
    return b.reshape(-1, bc, b.shape[1])


def spmm_block_ell_ref(
    colblk: torch.Tensor,  # int32 (nrb, W)
    vals: torch.Tensor,  # f32 (nrb, W, rb, bc)
    b: torch.Tensor,  # (n_cols, F)
    bc: int,
) -> torch.Tensor:
    """Returns (nrb*rb, F). Padded slots have zero vals => no masking."""
    nrb, w, rb, _ = vals.shape
    slot_rowblk = torch.arange(nrb, device=vals.device).repeat_interleave(w)
    return spmm_ragged_ell_ref(
        slot_rowblk, colblk.reshape(-1), vals.reshape(nrb * w, rb, bc), b, nrb, bc
    )


def _row_blocks(x: torch.Tensor, rb: int, n_blocks: int) -> torch.Tensor:
    """x as (n_blocks, rb, F): rows past x's end read as zero."""
    pad = n_blocks * rb - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return x[: n_blocks * rb].reshape(n_blocks, rb, x.shape[1])


def chunk_ranges(n: int, per_item: int, chunk_elems: int = CHUNK_ELEMS):
    """Yield (lo, hi) ranges over n items of ``per_item`` elements each,
    ``chunk_elems`` elements (>= 1 item) at a time."""
    step = max(1, chunk_elems // max(per_item, 1))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def sddmm_block_ell_ref(
    colblk: torch.Tensor,  # int32 (nrb, W)
    mask: torch.Tensor,  # (nrb, W, rb, bc) structural 0/1 (incl. slot padding)
    x: torch.Tensor,  # (nrb*rb, F)
    y: torch.Tensor,  # (n_cols, F)
    bc: int,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Block-ELL SDDMM: per stored micro-tile, X_i @ Y_j^T, masked."""
    nrb, w, rb, _ = mask.shape
    f = x.shape[1]
    xb = _row_blocks(x, rb, nrb)
    yb = _b_blocks(y, bc)
    out = torch.empty(mask.shape, dtype=torch.result_type(x, y), device=x.device)
    for lo, hi in chunk_ranges(nrb, w * bc * f, chunk_elems):
        tiles = torch.einsum("srf,swbf->swrb", xb[lo:hi], yb[colblk[lo:hi].long()])
        out[lo:hi] = tiles * mask[lo:hi]
    return out


def row_softmax_block_ell_ref(
    vals: torch.Tensor,  # (nrb, W, rb, bc) logits
    mask: torch.Tensor,  # structural mask, same shape
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Softmax per padded row (axis over (W, bc)), masked positions -> 0."""
    neg = torch.finfo(vals.dtype).min
    out = torch.empty_like(vals)
    nrb, w, rb, bc = vals.shape
    for lo, hi in chunk_ranges(nrb, w * rb * bc, chunk_elems):
        on = mask[lo:hi] > 0
        masked = torch.where(on, vals[lo:hi], neg)
        m = masked.amax(dim=(1, 3), keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.exp(masked - m) * on
        out[lo:hi] = e / torch.clamp(e.sum(dim=(1, 3), keepdim=True), min=1e-30)
    return out


def csr_attention_block_ell_ref(
    colblk: torch.Tensor,
    mask: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bc: int,
    scale: Optional[float] = None,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Block-ELL SDDMM -> row softmax -> SpMM; returns (nrb*rb, D). Row
    blocks are independent, so the three stages run per chunk of row
    blocks and no (nrb, W, rb, bc) intermediate is ever whole."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    nrb, w, rb, _ = mask.shape
    d = q.shape[1]
    qb = _row_blocks(q, rb, nrb)
    out = torch.empty((nrb, rb, d), dtype=torch.float32, device=q.device)
    for lo, hi in chunk_ranges(nrb, w * bc * d, chunk_elems):
        cb, mk = colblk[lo:hi], mask[lo:hi]
        q_c = qb[lo:hi].reshape(-1, d)
        logits = sddmm_block_ell_ref(cb, mk, q_c, k, bc, chunk_elems) * scale
        probs = row_softmax_block_ell_ref(logits, mk, chunk_elems)
        out[lo:hi] = spmm_block_ell_ref(cb, probs, v, bc).reshape(hi - lo, rb, d)
    return out.reshape(nrb * rb, d)


def spmm_ragged_ell_ref(
    slot_rowblk: torch.Tensor,  # int (n_slots,)
    slot_colblk: torch.Tensor,  # int (n_slots,)
    slot_vals: torch.Tensor,  # f32 (n_slots, rb, bc)
    b: torch.Tensor,  # (n_cols, F)
    n_row_blocks: int,
    bc: int,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Slot-compacted SpMM oracle: returns (n_row_blocks*rb, F)."""
    n_slots, rb, _ = slot_vals.shape
    f = b.shape[1]
    bb = _b_blocks(b, bc).to(slot_vals.dtype)
    out = torch.zeros((n_row_blocks, rb, f), dtype=torch.float32, device=b.device)
    step = max(1, chunk_elems // max(bc * f, 1))
    for lo in range(0, n_slots, step):
        hi = min(n_slots, lo + step)
        tiles = torch.bmm(slot_vals[lo:hi], bb[slot_colblk[lo:hi].long()])
        out.index_add_(0, slot_rowblk[lo:hi].long(), tiles)
    return out.reshape(n_row_blocks * rb, f)


def spmm_merge_path_ref(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (padded_slots,) tail-padded
    tile_vals: torch.Tensor,  # f32 (n_tiles, tile_slots, rb, bc)
    b: torch.Tensor,  # (n_cols, F)
    n_slots: int,
    bc: int,
) -> torch.Tensor:
    """Merge-path SpMM oracle: the tiling is a pure reshape of the ragged
    slot stream, so this is the ragged oracle on the unpadded slots, with
    slot row blocks recovered from blkptr."""
    n_row_blocks = blkptr.shape[0] - 1
    rb = tile_vals.shape[2]
    slot_vals = tile_vals.reshape(-1, rb, tile_vals.shape[3])[:n_slots]
    slot_rowblk = torch.searchsorted(
        blkptr.long(), torch.arange(n_slots, device=blkptr.device), right=True
    ) - 1
    return spmm_ragged_ell_ref(
        slot_rowblk, slot_colblk[:n_slots], slot_vals, b, n_row_blocks, bc
    )


def sddmm_ragged_ell_ref(
    slot_rowblk: torch.Tensor,  # int (n_slots,)
    slot_colblk: torch.Tensor,  # int (n_slots,)
    mask: torch.Tensor,  # (n_slots, rb, bc) structural 0/1
    x: torch.Tensor,  # (n_rows, F)
    y: torch.Tensor,  # (n_cols, F)
    bc: int,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Slot-compacted SDDMM oracle: per-slot masked X_i @ Y_j^T tiles."""
    n_slots, rb, _ = mask.shape
    f = x.shape[1]
    xb = _row_blocks(x, rb, -(-x.shape[0] // rb))
    yb = _b_blocks(y, bc)
    out = torch.empty(mask.shape, dtype=torch.result_type(x, y), device=x.device)
    for lo, hi in chunk_ranges(n_slots, (rb + bc) * f, chunk_elems):
        tiles = torch.bmm(xb[slot_rowblk[lo:hi].long()],
                          yb[slot_colblk[lo:hi].long()].transpose(1, 2))
        out[lo:hi] = tiles * mask[lo:hi]
    return out


def sddmm_merge_path_ref(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (padded_slots,) tail-padded
    tile_mask: torch.Tensor,  # f32 (n_tiles, tile_slots, rb, bc)
    x: torch.Tensor,  # (n_rows, F)
    y: torch.Tensor,  # (n_cols, F)
    n_slots: int,
    bc: int,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Merge-path SDDMM oracle: the ragged oracle over the unpadded
    slots; returns (n_slots, rb, bc)."""
    rb = tile_mask.shape[2]
    mask = tile_mask.reshape(-1, rb, tile_mask.shape[3])[:n_slots]
    slot_rowblk = torch.searchsorted(
        blkptr.long(), torch.arange(n_slots, device=blkptr.device), right=True
    ) - 1
    return sddmm_ragged_ell_ref(slot_rowblk, slot_colblk[:n_slots], mask, x, y, bc,
                                chunk_elems)
