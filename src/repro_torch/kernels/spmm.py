"""Block-ELL SpMM (C = A @ B, A sparse): hand-written CUDA kernels for
Hopper, their plain-torch versions, and the wrappers that pick between
them.

Port of repro/kernels/spmm_pallas.py. The kernels live in
``csrc/spmm.cu`` (built and loaded by kernels/build.py); its header says
what bounds each on an H100 and what the design does about it.

  spmm_block_ell   <- spmm_block_ell   (dense-W: every row block walks
                                        all W slots, padded ones too)
  spmm_ragged_ell  <- spmm_ragged_ell  (live slots only, sorted by row
                                        block)
  spmm_merge_path  <- spmm_merge_path  (nnz-balanced runs of merge tiles,
                                        carry + fixup for straddling rows)

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the current stream or raises.
``LAUNCHES`` counts the launches of each kernel (one per wrapper call).

Unlike the Pallas kernels the wrappers take B unpadded: rows past
``b.shape[0]`` count as zero, any F works, and ``n_rows`` cuts the
padded last row block off the output.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {
    "spmm_block_ell": 0,
    "spmm_ragged_ell": 0,
    "spmm_merge_path": 0,
}

# the merge kernel runs at most this many blocks per feature tile; each
# block covers ceil(n_tiles / MERGE_MAX_BLOCKS) consecutive merge tiles
MERGE_MAX_BLOCKS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def f_tile(f: int) -> int:
    """Feature columns per CUDA block: one thread per column, a multiple
    of 32, at most 256."""
    return min(256, -(-max(f, 1) // 32) * 32)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """csrc/spmm.cu, built at first use, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = build.load("spmm")
        lib.autosage_spmm_rows.argtypes = [
            _P, _I, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _LL, _I, _P,
        ]
        lib.autosage_spmm_rows.restype = _I
        lib.autosage_spmm_merge.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _LL, _P, _P, _P, _I, _I, _LL, _I,
            _LL, _I, _P,
        ]
        lib.autosage_spmm_merge.restype = _I
        _LIB = lib
    return _LIB


# ------------------------------------------------------------- ragged
def spmm_ragged_ell_plain(blkptr, slot_colblk, slot_vals, b, n_rows=None):
    """Plain version of `spmm_ragged_ell` (the slot-compacted oracle)."""
    nrb = blkptr.shape[0] - 1
    _, rb, bc = slot_vals.shape
    counts = torch.diff(blkptr.long())
    slot_rowblk = torch.repeat_interleave(
        torch.arange(nrb, device=blkptr.device), counts
    )
    out = ref.spmm_ragged_ell_ref(slot_rowblk, slot_colblk, slot_vals, b, nrb, bc)
    return out[: nrb * rb if n_rows is None else n_rows]


def spmm_ragged_ell(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (n_slots,)
    slot_vals: torch.Tensor,  # f32 (n_slots, rb, bc)
    b: torch.Tensor,  # f32 (n_cols, F)
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """Slot-compacted SpMM over a RaggedBlockELL: returns (n_rows, F),
    n_rows defaulting to nrb * rb. One CUDA block per (row block, feature
    tile) walks blkptr[i]..blkptr[i+1] in slot order."""
    if b.device.type == "cpu":
        return spmm_ragged_ell_plain(blkptr, slot_colblk, slot_vals, b, n_rows)
    name = "spmm_ragged_ell"
    build.check_operands(name, b.device, blkptr=blkptr, slot_colblk=slot_colblk,
                         vals=slot_vals, b=b)
    nrb = blkptr.shape[0] - 1
    _, rb, bc = slot_vals.shape
    n_rows = nrb * rb if n_rows is None else n_rows
    if not 0 <= n_rows <= nrb * rb:
        raise ValueError(f"{name}: n_rows={n_rows} outside [0, {nrb * rb}]")
    f = b.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=b.device)
    if nrb == 0 or f == 0 or n_rows == 0:
        return out
    rc = _lib().autosage_spmm_rows(
        blkptr.data_ptr(), 0, slot_colblk.data_ptr(), slot_vals.data_ptr(),
        b.data_ptr(), out.data_ptr(), nrb, rb, bc, b.shape[0], f, n_rows,
        f_tile(f), build.stream_of(b.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# ------------------------------------------------------------ dense-W
def spmm_block_ell_plain(colblk, vals, b, n_rows=None):
    """Plain version of `spmm_block_ell` (the block-ELL oracle)."""
    nrb, _, rb, bc = vals.shape
    out = ref.spmm_block_ell_ref(colblk, vals, b, bc)
    return out[: nrb * rb if n_rows is None else n_rows]


def spmm_block_ell(
    colblk: torch.Tensor,  # int32 (nrb, W)
    vals: torch.Tensor,  # f32 (nrb, W, rb, bc)
    b: torch.Tensor,  # f32 (n_cols, F)
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """Dense-W block-ELL SpMM: every row block walks all W slots, padded
    (all-zero) ones included, with the ragged kernel's per-slot FMA order,
    so its output equals the ragged kernel's bit for bit."""
    if b.device.type == "cpu":
        return spmm_block_ell_plain(colblk, vals, b, n_rows)
    name = "spmm_block_ell"
    build.check_operands(name, b.device, colblk=colblk, vals=vals, b=b)
    nrb, w, rb, bc = vals.shape
    n_rows = nrb * rb if n_rows is None else n_rows
    if not 0 <= n_rows <= nrb * rb:
        raise ValueError(f"{name}: n_rows={n_rows} outside [0, {nrb * rb}]")
    f = b.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=b.device)
    if nrb == 0 or f == 0 or n_rows == 0:
        return out
    rc = _lib().autosage_spmm_rows(
        None, w, colblk.data_ptr(), vals.data_ptr(), b.data_ptr(),
        out.data_ptr(), nrb, rb, bc, b.shape[0], f, n_rows, f_tile(f),
        build.stream_of(b.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# --------------------------------------------------------- merge-path
def spmm_merge_path_plain(blkptr, slot_colblk, tile_vals, b, n_slots, n_rows=None):
    """Plain version of `spmm_merge_path` (the merge-path oracle)."""
    nrb = blkptr.shape[0] - 1
    rb, bc = tile_vals.shape[2], tile_vals.shape[3]
    out = ref.spmm_merge_path_ref(blkptr, slot_colblk, tile_vals, b, n_slots, bc)
    return out[: nrb * rb if n_rows is None else n_rows]


def spmm_merge_path(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (n_tiles * tile_slots,) tail-padded
    tile_rowblk: torch.Tensor,  # int32 (n_tiles,) merge start row block
    tile_offset: torch.Tensor,  # int32 (n_tiles,) start offset in that block
    tile_vals: torch.Tensor,  # f32 (n_tiles, tile_slots, 8, 8)
    b: torch.Tensor,  # f32 (n_cols, F)
    n_slots: int,
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """nnz-balanced SpMM over a MergePathELL (rb = bc = 8).

    The Pallas kernel keeps the whole output panel resident across a
    sequential grid; CUDA blocks run in parallel and in no order. So each
    block takes a run of consecutive merge tiles (at most MERGE_MAX_BLOCKS
    runs), writes the rows that start inside its run, and leaves the
    partial sum of a row it continues in a carry buffer; a second kernel
    adds each row's carries in run order. No float atomics: two launches
    give the same bits."""
    if b.device.type == "cpu":
        return spmm_merge_path_plain(blkptr, slot_colblk, tile_vals, b, n_slots, n_rows)
    name = "spmm_merge_path"
    build.check_operands(name, b.device, blkptr=blkptr, slot_colblk=slot_colblk,
           tile_rowblk=tile_rowblk, tile_offset=tile_offset, vals=tile_vals, b=b)
    n_tiles, tile_slots, rb, bc = tile_vals.shape
    nrb = blkptr.shape[0] - 1
    n_rows = nrb * rb if n_rows is None else n_rows
    if not 0 <= n_rows <= nrb * rb:
        raise ValueError(f"{name}: n_rows={n_rows} outside [0, {nrb * rb}]")
    if not (n_tiles - 1) * tile_slots < n_slots <= n_tiles * tile_slots:
        raise ValueError(f"{name}: n_slots={n_slots} does not fit {n_tiles} tiles")
    f = b.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=b.device)
    if nrb == 0 or n_tiles == 0 or f == 0 or n_rows == 0:
        return out
    tiles_per_block = -(-n_tiles // MERGE_MAX_BLOCKS)
    n_blocks = -(-n_tiles // tiles_per_block)
    carry = torch.empty((n_blocks, rb, f), dtype=torch.float32, device=b.device)
    rc = _lib().autosage_spmm_merge(
        blkptr.data_ptr(), slot_colblk.data_ptr(), tile_vals.data_ptr(),
        tile_rowblk.data_ptr(), tile_offset.data_ptr(), tile_slots,
        tiles_per_block, n_blocks, n_slots, b.data_ptr(), out.data_ptr(),
        carry.data_ptr(), rb, bc, b.shape[0], f, n_rows, f_tile(f),
        build.stream_of(b.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
