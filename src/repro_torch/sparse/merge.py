"""Merge-path partition table: nnz-balanced tiling of a slot stream.

Every other kernel family in this repo is *row-partitioned*: a grid cell
owns a row block and runs that block's whole slot chain, so one mega-hub
row serializes a grid cell no matter how the remaining rows are spread.
Merge-path (Merrill & Garland's CSR SpMV schedule; GNNAdvisor's
`part_pointers`/`part2Node` neighbor groups are the GNN analogue) splits
the *nonzero stream* evenly instead: grid cell ``t`` owns slots
``[t*tile_slots, (t+1)*tile_slots)`` of the RaggedBlockELL slot stream
regardless of which rows they belong to.

The host precomputes, per tile, the starting (row block, nnz offset)
merge coordinate. The CUDA kernel (kernels/spmm.py:spmm_merge_path)
starts each block at its first tile's row block and walks ``blkptr``
from there. A tile whose ``tile_offset`` is > 0 continues a row an
earlier tile started: its partial sum for that row goes to a carry
buffer, and a second pass adds the carries in tile order. That changes
the summation order of straddling rows, so on the GPU merge-path is
close to, not bit-identical with, the ragged kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.bsr import RaggedBlockELL

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class MergePathELL:
    """nnz-balanced tiling of a RaggedBlockELL slot stream.

    blkptr:      int32[n_row_blocks + 1]   slot range per row block — the
                                           "rowptr slice" the kernels
                                           binary-search rows in
    slot_colblk: int32[n_tiles*tile_slots] column-block id per slot
                                           (padded slots point at block 0)
    tile_vals:   f32[n_tiles, tile_slots, rb, bc]  micro-tiles, grouped
                                           by owning merge tile (padded
                                           slots are all-zero)
    tile_rowblk: int32[n_tiles]            merge start coordinate: row
                                           block owning the tile's first
                                           slot
    tile_offset: int32[n_tiles]            merge start coordinate: slot
                                           offset of the tile's first
                                           slot *within* that row block
    tile_nslots: int32[n_tiles]            live (non-padded) slots per
                                           tile; only the last tile can
                                           be partial
    """

    blkptr: np.ndarray
    slot_colblk: np.ndarray
    tile_vals: np.ndarray
    tile_rowblk: np.ndarray
    tile_offset: np.ndarray
    tile_nslots: np.ndarray
    rb: int
    bc: int
    tile_slots: int
    n_rows: int
    n_cols: int
    n_slots: int  # live slots (== RaggedBlockELL.n_slots)

    @property
    def n_tiles(self) -> int:
        return self.tile_rowblk.shape[0]

    @property
    def n_row_blocks(self) -> int:
        return self.blkptr.shape[0] - 1

    @property
    def n_col_blocks(self) -> int:
        return -(-self.n_cols // self.bc)

    @property
    def padded_rows(self) -> int:
        return self.n_row_blocks * self.rb


def build_merge_path(rag: RaggedBlockELL, tile_slots: int = 8) -> MergePathELL:
    """Partition ``rag``'s slot stream into equal ``tile_slots`` tiles.

    The start coordinates are the merge-path diagonal intersections of
    the (row, nnz) grid restricted to slot granularity:
    ``tile_rowblk[t] = searchsorted(blkptr, t*tile_slots, 'right') - 1``
    and ``tile_offset[t]`` the distance from that row block's first slot.
    The slot stream itself is only *reshaped* (plus tail padding), so the
    per-slot values/colblk order — and hence kernel accumulation order —
    is exactly the ragged layout's.
    """
    if tile_slots < 1:
        raise ValueError(f"tile_slots must be >= 1, got {tile_slots}")
    n_slots = rag.n_slots
    n_tiles = -(-n_slots // tile_slots) if n_slots else 0
    padded_slots = n_tiles * tile_slots
    if padded_slots > _INT32_MAX:
        raise ValueError(
            f"merge-path table overflows int32 indices: {padded_slots} "
            f"padded slots > {_INT32_MAX}; shrink the graph or partition it"
        )
    pad = padded_slots - n_slots
    colblk = np.pad(rag.slot_colblk, (0, pad)).astype(np.int32)
    vals = np.pad(
        rag.slot_vals.astype(np.float32), ((0, pad), (0, 0), (0, 0))
    ).reshape(n_tiles, tile_slots, rag.rb, rag.bc)
    tiling = merge_tiling(rag.blkptr, n_slots, tile_slots)
    return MergePathELL(
        blkptr=rag.blkptr.astype(np.int32),
        slot_colblk=colblk,
        tile_vals=vals,
        **tiling,
        rb=rag.rb,
        bc=rag.bc,
        tile_slots=tile_slots,
        n_rows=rag.n_rows,
        n_cols=rag.n_cols,
        n_slots=n_slots,
    )


def merge_tiling(blkptr: np.ndarray, n_slots: int, tile_slots: int) -> dict:
    """The merge start coordinates of ``n_slots`` slots cut into tiles of
    ``tile_slots``: int32 ``tile_rowblk``, ``tile_offset`` and
    ``tile_nslots`` as `MergePathELL` holds them (the slot stream itself
    is untouched, so a caller that needs no value tiles skips the padded
    copy `build_merge_path` makes)."""
    n_tiles = -(-n_slots // tile_slots) if n_slots else 0
    starts = np.arange(n_tiles, dtype=np.int64) * tile_slots
    tile_rowblk = (
        np.searchsorted(blkptr.astype(np.int64), starts, side="right") - 1
    ).astype(np.int32)
    return {
        "tile_rowblk": tile_rowblk,
        "tile_offset": (starts - blkptr[tile_rowblk]).astype(np.int32),
        "tile_nslots": np.minimum(tile_slots, n_slots - starts).astype(np.int32),
    }
