"""Plain-torch oracles for the SpMM slice: ground truth for the tests,
the guardrail baseline's semantics, and the plain versions the CUDA
kernels are held against.

Port of the SpMM half of repro/kernels/ref.py, with the same signatures.
Each oracle works in chunks of rows or slots, so its memory stays bounded
at Reddit scale: the JAX oracle's one-shot gather ``b_blocks[slot_colblk]``
would build an (S, bc, F) array of 163 GB there. ``spmm_ref`` sums each
row with ``torch.segment_reduce`` over the sorted CSR rows, so it gives
the same bits on every run; the layout oracles use ``index_add_``, whose
CUDA atomics may change the last bits between runs.

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
    rp = rowptr.cpu().numpy().astype(np.int64)
    budget = max(1, chunk_elems // max(f, 1))
    r = 0
    while r < n_rows:
        # the longest run of rows whose edges fit the budget (>= 1 row)
        r_hi = int(np.searchsorted(rp, rp[r] + budget, side="right")) - 1
        r_hi = min(max(r_hi, r + 1), n_rows)
        lo, hi = int(rp[r]), int(rp[r_hi])
        if hi > lo:
            g = b.index_select(0, colind[lo:hi])
            if val is not None:
                g.mul_(val[lo:hi, None].to(b.dtype))
            offsets = rowptr[r : r_hi + 1].to(torch.int64) - lo
            out[r:r_hi] = torch.segment_reduce(g, "sum", offsets=offsets, axis=0)
        r = r_hi
    return out


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
