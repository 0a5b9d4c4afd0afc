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

The kernels do the work of the tiles' nonzeros only. For finite B that
is what the Pallas kernels and the plain versions compute; where B holds
+-inf or NaN in a row that a tile pairs only with zero values, those
multiply whole tiles and give NaN (0 * inf), while the kernels give the
CSR product's value, as ``ref.spmm_ref`` does on the CSR.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import I, LL, P

LAUNCHES: Dict[str, int] = {
    "spmm_block_ell": 0,
    "spmm_ragged_ell": 0,
    "spmm_merge_path": 0,
}

WARP = 32
# feature columns one warp covers: 4 per lane (csrc/spmm.cu kChunkCols)
F_CHUNK = 128
# the merge kernel splits the tile stream into at most this many runs,
# one warp per (run, feature chunk): about one run per warp an H100 holds
# resident (132 SMs x 64 warps = 8,448), so at F = 256 two chunks give a
# few waves of equal, nnz-balanced runs; the carry buffer holds one
# rb x F panel per run
MERGE_MAX_RUNS = 8192


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def f_tile(f: int) -> int:
    """Feature columns one warp covers per unit of work (a slot of one
    feature chunk): up to F_CHUNK, 4 per lane, fewer for narrow F."""
    return min(F_CHUNK, -(-max(f, 1) // WARP) * WARP)


def n_chunks(f: int) -> int:
    """Feature chunks a row block (or merge run) is split into, one warp
    each: ceil(f / f_tile(f))."""
    return -(-max(f, 1) // F_CHUNK)


def vec4(b: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether a lane takes its 4 columns as one float4: F % 4 == 0 and
    B and C 16-byte aligned."""
    return b.shape[1] % 4 == 0 and b.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def lane_columns(f: int, chunk: int, lane: int, vec: bool) -> list:
    """The feature columns a lane owns in a chunk, as the kernels map
    them: 4 consecutive ones, one float4 (vec), or 4 strided by the warp
    width; either way a warp-wide load is coalesced."""
    base = chunk * F_CHUNK
    cols = ([base + 4 * lane + k for k in range(4)] if vec
            else [base + lane + WARP * k for k in range(4)])
    return [c for c in cols if c < f]


def rowblock_order(blkptr: torch.Tensor) -> torch.Tensor:
    """int32 permutation of the row blocks, longest slot chain first: the
    order in which the ragged kernel's warps take them, so the chains of
    hub row blocks start in the first wave instead of trailing the last."""
    return torch.argsort(torch.diff(blkptr), descending=True, stable=True).to(torch.int32)


def merge_runs(n_tiles: int) -> Tuple[int, int]:
    """(tiles_per_run, n_runs): the merge tiles split into consecutive
    runs of equal length (the last may be shorter), at most
    MERGE_MAX_RUNS of them."""
    per_run = max(1, -(-n_tiles // MERGE_MAX_RUNS))
    return per_run, -(-n_tiles // per_run)


def _check_aligned(name: str, vals: torch.Tensor) -> None:
    """The kernels read a tile with one vector load per lane."""
    if vals.data_ptr() % 16:
        raise ValueError(f"{name}: the value tiles must be 16-byte aligned")


# csrc/spmm.cu, built at first use, with its C signatures declared
_lib = functools.partial(build.load, "spmm", {
    "autosage_spmm_rows": [P, P, I, P, P, P, P, LL, I, I, LL, I, LL, I, I, P],
    "autosage_spmm_merge": [
        P, P, P, P, P, I, I, I, LL, P, P, P, I, I, LL, I, LL, I, I, P,
    ],
})


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
    n_rows defaulting to nrb * rb. One warp per (row block, feature
    chunk) walks blkptr[i]..blkptr[i+1] in slot order, doing the work of
    the tiles' nonzeros only; warps take the row blocks longest first
    (`rowblock_order`)."""
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
    _check_aligned(name, slot_vals)
    order = rowblock_order(blkptr)
    rc = _lib().autosage_spmm_rows(
        blkptr.data_ptr(), order.data_ptr(), 0, slot_colblk.data_ptr(), slot_vals.data_ptr(),
        b.data_ptr(), out.data_ptr(), nrb, rb, bc, b.shape[0], f, n_rows,
        n_chunks(f), vec4(b, out), build.stream_of(b.device),
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
    (all-zero) ones included, at the cost of their reads; the live tiles
    take the ragged kernel's FMA order, so its output equals the ragged
    kernel's bit for bit."""
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
    _check_aligned(name, vals)
    rc = _lib().autosage_spmm_rows(
        None, None, w, colblk.data_ptr(), vals.data_ptr(), b.data_ptr(),
        out.data_ptr(), nrb, rb, bc, b.shape[0], f, n_rows, n_chunks(f),
        vec4(b, out), build.stream_of(b.device),
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
    sequential grid; warps run in parallel and in no order. So each warp
    takes a run of consecutive merge tiles (`merge_runs`) in one feature
    chunk, writes the rows that start inside its run, and leaves the
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
    _check_aligned(name, tile_vals)
    per_run, n_runs = merge_runs(n_tiles)
    carry = torch.empty((n_runs, rb, f), dtype=torch.float32, device=b.device)
    rc = _lib().autosage_spmm_merge(
        blkptr.data_ptr(), slot_colblk.data_ptr(), tile_vals.data_ptr(),
        tile_rowblk.data_ptr(), tile_offset.data_ptr(), tile_slots,
        per_run, n_runs, n_slots, b.data_ptr(), out.data_ptr(),
        carry.data_ptr(), rb, bc, b.shape[0], f, n_rows, n_chunks(f),
        vec4(b, out), build.stream_of(b.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
