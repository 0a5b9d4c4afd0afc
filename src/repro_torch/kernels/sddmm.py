"""Block-ELL SDDMM (per stored micro-tile, X_blk @ Y_blkᵀ times the
structural mask): hand-written CUDA kernels for Hopper, their plain-torch
versions, and the wrappers that pick between them.

Port of repro/kernels/sddmm_pallas.py. The kernels live in
``csrc/sddmm.cu`` (built and loaded by kernels/build.py); its header says
what bounds them on an H100 and what the design does about it.

  sddmm_block_ell   <- sddmm_block_ell   (dense-W: (nrb, W, rb, bc) tiles,
                                          padded slots included)
  sddmm_ragged_ell  <- sddmm_ragged_ell  (one tile per live slot)
  sddmm_merge_path  <- sddmm_merge_path  ((n_tiles, tile_slots, rb, bc)
                                          tiles; row blocks by bisection)

All three run one per-slot routine that computes only the cells whose
mask is > 0. Each such dot product runs one fixed order, whatever the
layout: lane l of a warp takes feature columns 4l + 128k + j
(k = 0, 1, ..., j = 0..3) in one fp32 fmaf chain, and a fixed xor
butterfly sums the 32 partials. So the live tiles of the three layouts
are equal bit for bit. Masked cells are +0.0 (the Pallas kernels
multiply by the mask and may leave -0.0 or, for a +-inf or NaN dot,
NaN there; no edge reads a masked cell), and tiles without an edge —
padded dense-W slots, the ragged dummy slot, merge tail slots — are all
+0.0. The kernels add +0.0 to every live cell, so no -0.0 appears. The
plain versions multiply whole tiles with ``torch.bmm`` and keep the
same rule on masked cells.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the current stream or raises.
``LAUNCHES`` counts the launches of each kernel (one per wrapper call).
Unlike the Pallas kernels the wrappers take X and Y unpadded: rows past
their ends read as zero, and any F works (no padding to 32).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import CHUNK_ELEMS, chunk_ranges

LAUNCHES: Dict[str, int] = {
    "sddmm_block_ell": 0,
    "sddmm_ragged_ell": 0,
    "sddmm_merge_path": 0,
}

BLOCKINGS = ((8, 8), (16, 8))  # (rb, bc) the kernels are built for

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """csrc/sddmm.cu, built at first use, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = build.load("sddmm")
        lib.autosage_sddmm_dense.argtypes = [
            _P, _P, _P, _P, _P, _LL, _I, _I, _I, _LL, _LL, _I, _P,
        ]
        lib.autosage_sddmm_ragged.argtypes = [
            _P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P,
        ]
        lib.autosage_sddmm_merge.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _I, _I, _LL, _LL, _I, _P,
        ]
        for fn in (lib.autosage_sddmm_dense, lib.autosage_sddmm_ragged,
                   lib.autosage_sddmm_merge):
            fn.restype = _I
        _LIB = lib
    return _LIB


def n_bisect(n_row_blocks: int) -> int:
    """Steps of the fixed-trip row-block bisection (sddmm_pallas.py's
    ``n_bisect``): enough for any row block count up to n_row_blocks."""
    return max(n_row_blocks, 2).bit_length() + 1


# -------------------------------------------------------------- plain
def _blocks(a: torch.Tensor, rows: int) -> torch.Tensor:
    """a as (n_blocks, rows, F), zero-padded to whole blocks."""
    pad = (-a.shape[0]) % rows
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    return a.reshape(-1, rows, a.shape[1])


def sddmm_slots_plain(
    slot_rowblk: torch.Tensor,  # int (S,)
    slot_colblk: torch.Tensor,  # int (S,)
    mask: torch.Tensor,  # f32 (S, rb, bc) structural 0/1
    x: torch.Tensor,  # (n_x_rows, F)
    y: torch.Tensor,  # (n_y_rows, F)
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """The kernels' function over a slot list, in chunks of slots:
    (S, rb, bc) tiles, dot * mask on masked-in cells and +0.0 elsewhere.
    Row blocks past X's end read as zero."""
    n_slots, rb, bc = mask.shape
    f = x.shape[1]
    xb, yb = _blocks(x, rb), _blocks(y, bc)
    xb = torch.cat([xb, xb.new_zeros((1, rb, f))])  # rows past the end
    last = xb.shape[0] - 1
    out = torch.empty(mask.shape, dtype=torch.float32, device=x.device)
    for lo, hi in chunk_ranges(n_slots, (rb + bc) * max(f, 1), chunk_elems):
        rows = torch.clamp(slot_rowblk[lo:hi].long(), max=last)
        tiles = torch.bmm(xb[rows], yb[slot_colblk[lo:hi].long()].transpose(1, 2))
        m = mask[lo:hi]
        out[lo:hi] = torch.where(m > 0, tiles * m, torch.zeros((), device=x.device))
    return out


def sddmm_ragged_ell_plain(slot_rowblk, slot_colblk, mask, x, y):
    """Plain version of `sddmm_ragged_ell`."""
    return sddmm_slots_plain(slot_rowblk, slot_colblk, mask, x, y)


def sddmm_block_ell_plain(colblk, mask, x, y):
    """Plain version of `sddmm_block_ell`: the dense-W grid is a slot list
    whose padded slots have all-zero masks."""
    nrb, w, rb, bc = mask.shape
    slot_rowblk = torch.arange(nrb, device=colblk.device).repeat_interleave(w)
    out = sddmm_slots_plain(slot_rowblk, colblk.reshape(-1),
                            mask.reshape(nrb * w, rb, bc), x, y)
    return out.reshape(mask.shape)


def sddmm_merge_path_plain(blkptr, slot_colblk, tile_rowblk, tile_mask, x, y):
    """Plain version of `sddmm_merge_path`: each slot's row block is
    bisect_right(blkptr, slot) - 1 (tail slots fall in the last row block,
    and their masks are zero)."""
    n_tiles, ts, rb, bc = tile_mask.shape
    nrb = blkptr.shape[0] - 1
    slot_rowblk = torch.searchsorted(
        blkptr.long(), torch.arange(n_tiles * ts, device=blkptr.device), right=True
    ) - 1
    out = sddmm_slots_plain(torch.clamp(slot_rowblk, max=max(nrb - 1, 0)), slot_colblk,
                            tile_mask.reshape(n_tiles * ts, rb, bc), x, y)
    return out.reshape(tile_mask.shape)


# ------------------------------------------------------------ kernels
def _check(name, mask, x, y):
    rb, bc = mask.shape[-2:]
    if (rb, bc) not in BLOCKINGS:
        raise ValueError(f"{name}: {rb}x{bc} tiles; the kernels take {BLOCKINGS}")
    if mask.data_ptr() % (rb * bc // 8):  # one vector load of rb*bc/32 cells a lane
        raise ValueError(f"{name}: the mask tiles must be {rb * bc // 8}-byte aligned")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and y {tuple(y.shape)} disagree on F")
    return rb, bc


def sddmm_ragged_ell(
    slot_rowblk: torch.Tensor,  # int32 (n_slots,)
    slot_colblk: torch.Tensor,  # int32 (n_slots,)
    mask: torch.Tensor,  # f32 (n_slots, rb, bc) structural 0/1
    x: torch.Tensor,  # f32 (n_rows, F)
    y: torch.Tensor,  # f32 (n_cols, F)
) -> torch.Tensor:
    """Slot-compacted SDDMM: one (rb, bc) tile per live slot, in
    RaggedBlockELL slot order; dummy slots come out all-zero."""
    if x.device.type == "cpu":
        return sddmm_ragged_ell_plain(slot_rowblk, slot_colblk, mask, x, y)
    name = "sddmm_ragged_ell"
    build.check_operands(name, x.device, slot_rowblk=slot_rowblk,
                         slot_colblk=slot_colblk, mask=mask, x=x, y=y)
    rb, bc = _check(name, mask, x, y)
    n_slots = mask.shape[0]
    if slot_rowblk.shape[0] != n_slots or slot_colblk.shape[0] != n_slots:
        raise ValueError(f"{name}: {n_slots} mask tiles for {slot_rowblk.shape[0]} / "
                         f"{slot_colblk.shape[0]} slots")
    out = torch.empty(mask.shape, dtype=torch.float32, device=x.device)
    if n_slots == 0:
        return out
    rc = _lib().autosage_sddmm_ragged(
        slot_rowblk.data_ptr(), slot_colblk.data_ptr(), mask.data_ptr(), x.data_ptr(),
        y.data_ptr(), out.data_ptr(), n_slots, rb, bc, x.shape[0], y.shape[0],
        x.shape[1], build.stream_of(x.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def sddmm_block_ell(
    colblk: torch.Tensor,  # int32 (nrb, W)
    mask: torch.Tensor,  # f32 (nrb, W, rb, bc) structural 0/1, padding 0
    x: torch.Tensor,  # f32 (n_rows, F)
    y: torch.Tensor,  # f32 (n_cols, F)
) -> torch.Tensor:
    """Dense-W SDDMM: (nrb, W, rb, bc) tiles; padded slots all-zero and
    live tiles equal to the ragged kernel's bit for bit."""
    if x.device.type == "cpu":
        return sddmm_block_ell_plain(colblk, mask, x, y)
    name = "sddmm_block_ell"
    build.check_operands(name, x.device, colblk=colblk, mask=mask, x=x, y=y)
    rb, bc = _check(name, mask, x, y)
    nrb, w = colblk.shape
    if tuple(mask.shape[:2]) != (nrb, w):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not match colblk "
                         f"{tuple(colblk.shape)}")
    out = torch.empty(mask.shape, dtype=torch.float32, device=x.device)
    if nrb * w == 0:
        return out
    rc = _lib().autosage_sddmm_dense(
        colblk.data_ptr(), mask.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
        nrb, w, rb, bc, x.shape[0], y.shape[0], x.shape[1], build.stream_of(x.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def sddmm_merge_path(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (n_tiles * tile_slots,) tail-padded
    tile_rowblk: torch.Tensor,  # int32 (n_tiles,) merge start row block
    tile_mask: torch.Tensor,  # f32 (n_tiles, tile_slots, rb, bc) structural 0/1
    x: torch.Tensor,  # f32 (n_rows, F)
    y: torch.Tensor,  # f32 (n_cols, F)
) -> torch.Tensor:
    """nnz-balanced SDDMM: (n_tiles, tile_slots, rb, bc) tiles whose flat
    reshape is the ragged slot order; tail slots all-zero."""
    if x.device.type == "cpu":
        return sddmm_merge_path_plain(blkptr, slot_colblk, tile_rowblk, tile_mask, x, y)
    name = "sddmm_merge_path"
    build.check_operands(name, x.device, blkptr=blkptr, slot_colblk=slot_colblk,
                         tile_rowblk=tile_rowblk, mask=tile_mask, x=x, y=y)
    rb, bc = _check(name, tile_mask, x, y)
    n_tiles, ts = tile_mask.shape[:2]
    if slot_colblk.shape[0] != n_tiles * ts or tile_rowblk.shape[0] != n_tiles:
        raise ValueError(f"{name}: {n_tiles} x {ts} mask tiles for "
                         f"{slot_colblk.shape[0]} slots and {tile_rowblk.shape[0]} tiles")
    out = torch.empty(tile_mask.shape, dtype=torch.float32, device=x.device)
    nrb = blkptr.shape[0] - 1
    if n_tiles == 0:
        return out
    rc = _lib().autosage_sddmm_merge(
        blkptr.data_ptr(), slot_colblk.data_ptr(), tile_rowblk.data_ptr(),
        tile_mask.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), n_tiles, ts,
        nrb, n_bisect(nrb), rb, bc, x.shape[0], y.shape[0], x.shape[1],
        build.stream_of(x.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
