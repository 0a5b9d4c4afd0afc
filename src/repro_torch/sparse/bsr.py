"""Block-ELL format: CSR re-blocked into dense rb x bc micro-tiles.

Port of repro/sparse/bsr.py, array for array:

  - rows grouped into blocks of ``rb`` rows,
  - columns grouped into blocks of ``bc`` columns,
  - for each row-block, the list of referenced column-block ids is padded
    to a uniform width ``W`` (the ELL width of that partition),
  - the values of each (row-block, col-block) pair are stored as a dense
    ``rb x bc`` micro-tile.

The CUDA SpMM kernels (kernels/spmm.py) walk these tiles slot by slot.
Padding waste (``nnz_padded / nnz``) is an input feature the scheduler's
estimate stage accounts for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.sparse.csr import CSR

_INT32_MAX = np.iinfo(np.int32).max


def _check_int32(what: str, value: int) -> None:
    """Slot/blkptr arrays are int32 on-device; refuse layouts whose
    indices would silently wrap instead (paper-scale graphs can hit
    this through nnz or through n_row_blocks * width padding)."""
    if value > _INT32_MAX:
        raise ValueError(
            f"block-ELL layout overflows int32 indices: {what} = {value} "
            f"> {_INT32_MAX}; partition the graph (e.g. hub-split / batch "
            f"subgraphs) or reduce the block size"
        )


@dataclasses.dataclass(frozen=True)
class BlockELL:
    """Padded block-sparse row format.

    colblk: int32[n_row_blocks, width]        column-block id per slot
                                              (padded slots point at block 0)
    vals:   float32[n_row_blocks, width, rb, bc]  dense micro-tiles
                                              (padded slots are all-zero)
    nslots: int32[n_row_blocks]               live slots per row-block
    src_nnz: stored edge count of the source CSR row subset (-1 if the
             BlockELL was hand-built), recorded so padding can be audited
             after the fact without re-reading the CSR.
    """

    colblk: np.ndarray
    vals: np.ndarray
    nslots: np.ndarray
    rb: int
    bc: int
    n_rows: int
    n_cols: int
    src_nnz: int = -1

    @property
    def n_row_blocks(self) -> int:
        return self.colblk.shape[0]

    @property
    def width(self) -> int:
        return self.colblk.shape[1]

    @property
    def n_col_blocks(self) -> int:
        return -(-self.n_cols // self.bc)

    @property
    def padded_rows(self) -> int:
        return self.n_row_blocks * self.rb

    @property
    def nnz_dense_tiles(self) -> int:
        return int(self.nslots.sum()) * self.rb * self.bc

    def padding_waste(self, nnz: int) -> float:
        """nnz_padded / nnz — how much dense micro-tile work per real nnz."""
        if nnz == 0:
            return 1.0
        return self.nnz_dense_tiles / nnz

    @property
    def padding_frac(self) -> float:
        """Fraction of the dense-W slot grid that is padding, in [0, 1).

        This is what the dense-W kernels pay and the ragged kernels do
        not: a grid over (n_row_blocks, width) runs `width` slots per row
        block regardless of `nslots`. 0.75 means 3 of every 4 tile
        products multiply an all-zero tile.
        """
        grid = self.n_row_blocks * self.width
        if grid == 0:
            return 0.0
        return 1.0 - float(self.nslots.sum()) / grid

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.padded_rows, self.n_col_blocks * self.bc), np.float32)
        for i in range(self.n_row_blocks):
            for s in range(int(self.nslots[i])):
                c = int(self.colblk[i, s])
                out[i * self.rb : (i + 1) * self.rb, c * self.bc : (c + 1) * self.bc] += self.vals[i, s]
        return out[: self.n_rows, : self.n_cols]

    def to_ragged(self) -> "RaggedBlockELL":
        """Slot-compacted (CSR-of-blocks) view; zero re-packing cost.

        Live slots of each row block are concatenated in their in-block
        order, so a ragged kernel accumulates the exact same values in
        the exact same order as the dense-W kernel (whose padded slots
        add exact zeros) — outputs are value-identical. Every row block
        keeps at least one slot: an empty block gets a single all-zero
        dummy slot pointing at column-block 0, so the ragged grid still
        visits (and therefore initializes) every output row block.

        Memoized per object: the registry's ragged variants and the
        grad-op layout path (core/autodiff.py via registry dynamic
        builders) both call this on the same BlockELL during one
        decide + prepare sequence.
        """
        memo = getattr(self, "_ragged_memo", None)
        if memo is not None:
            return memo
        rag = self._to_ragged_uncached()
        object.__setattr__(self, "_ragged_memo", rag)
        return rag

    def _to_ragged_uncached(self) -> "RaggedBlockELL":
        nrb, w = self.colblk.shape
        ns = self.nslots.astype(np.int64)
        if nrb == 0:
            return RaggedBlockELL(
                blkptr=np.zeros(1, np.int32),
                slot_rowblk=np.zeros(0, np.int32),
                slot_colblk=np.zeros(0, np.int32),
                slot_vals=np.zeros((0, self.rb, self.bc), np.float32),
                rb=self.rb, bc=self.bc, n_rows=self.n_rows,
                n_cols=self.n_cols, src_nnz=self.src_nnz,
            )
        ns_eff = np.maximum(ns, 1)
        blkptr = np.zeros(nrb + 1, np.int64)
        np.cumsum(ns_eff, out=blkptr[1:])
        _check_int32("ragged slot count (blkptr[-1])", int(blkptr[-1]))
        slot_rowblk = np.repeat(np.arange(nrb, dtype=np.int32), ns_eff)
        if w == 0:  # no stored slots at all: dummy-only layout
            slot_colblk = np.zeros(nrb, np.int32)
            slot_vals = np.zeros((nrb, self.rb, self.bc), np.float32)
        else:
            take = np.arange(w)[None, :] < np.maximum(ns, 1)[:, None]
            slot_colblk = self.colblk[take]
            slot_vals = np.ascontiguousarray(self.vals[take])
        return RaggedBlockELL(
            blkptr=blkptr.astype(np.int32),
            slot_rowblk=slot_rowblk,
            slot_colblk=slot_colblk.astype(np.int32),
            slot_vals=slot_vals.astype(np.float32),
            rb=self.rb, bc=self.bc, n_rows=self.n_rows, n_cols=self.n_cols,
            src_nnz=self.src_nnz,
        )


@dataclasses.dataclass(frozen=True)
class RaggedBlockELL:
    """Slot-compacted block-ELL: the flat CSR-of-blocks layout the ragged
    kernels walk (one step per *actual* slot).

    blkptr:      int32[n_row_blocks + 1]  slot range of each row block
    slot_rowblk: int32[n_slots]           owning row block per slot
    slot_colblk: int32[n_slots]           column-block id per slot
    slot_vals:   float32[n_slots, rb, bc] dense micro-tiles

    Slots are sorted by (row block, column block); `slot_rowblk` is the
    scalar-prefetched array that drives the output index_map, `blkptr`
    the init-on-first-slot-of-block condition. Empty row blocks own one
    all-zero dummy slot (see BlockELL.to_ragged), so n_slots >= n_row_blocks.
    """

    blkptr: np.ndarray
    slot_rowblk: np.ndarray
    slot_colblk: np.ndarray
    slot_vals: np.ndarray
    rb: int
    bc: int
    n_rows: int
    n_cols: int
    src_nnz: int = -1

    @property
    def n_row_blocks(self) -> int:
        return self.blkptr.shape[0] - 1

    @property
    def n_slots(self) -> int:
        return int(self.slot_colblk.shape[0])

    @property
    def n_col_blocks(self) -> int:
        return -(-self.n_cols // self.bc)

    @property
    def padded_rows(self) -> int:
        return self.n_row_blocks * self.rb

    @property
    def nnz_dense_tiles(self) -> int:
        return self.n_slots * self.rb * self.bc


def _slot_key_base(csr: CSR, bc: int) -> int:
    """Base of the composite (row block, col block) sort key.

    Load-bearing shared constant: csr_to_block_ell orders slots by this
    key (via np.unique) and block_ell_edge_index recovers each edge's
    slot by searching the same key space — both sides must compute it
    identically or edge->slot lookups silently point at wrong tiles.
    """
    return csr.n_cols // bc + 2


def _expand_edges(csr: CSR, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-edge (local_row, col, abs_pos) arrays for a row subset, in CSR
    storage order — the single edge-enumeration both the block-ELL
    conversion and the edge-index lookup build on."""
    deg = csr.degrees[rows] if rows.size else np.zeros(0, np.int64)
    total = int(deg.sum())
    edge_row = np.repeat(np.arange(rows.shape[0]), deg)
    if total:
        starts = csr.rowptr[rows]
        # absolute edge positions: starts[r] + offset within row
        offsets = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(deg)[:-1]]), deg
        )
        pos = np.repeat(starts, deg) + offsets
        edge_col = csr.colind[pos]
    else:
        pos = np.zeros(0, np.int64)
        edge_col = np.zeros(0, np.int32)
    return edge_row, edge_col, pos


def csr_to_block_ell(
    csr: CSR,
    rb: int = 8,
    bc: int = 8,
    rows: Optional[np.ndarray] = None,
    min_width: int = 1,
    width_multiple: int = 1,
) -> BlockELL:
    """Re-block (a subset of rows of) a CSR matrix into BlockELL.

    ``rows``: optional row-id subset (used by the hub-split: heavy rows go
    to one partition, light rows to another, each with its own width).
    """
    if rows is None:
        rows = np.arange(csr.n_rows)
    rows = np.asarray(rows)
    n = rows.shape[0]
    if n == 0:
        # empty row subset (e.g. a hub-split partition with no rows):
        # zero row blocks and zero slots — min_width/width_multiple pad
        # slots *within* row blocks and must not conjure a phantom
        # (1, min_width) block here. The ragged view is then 0 slots.
        return BlockELL(
            colblk=np.zeros((0, 0), np.int32),
            vals=np.zeros((0, 0, rb, bc), np.float32),
            nslots=np.zeros(0, np.int32),
            rb=rb, bc=bc, n_rows=0, n_cols=csr.n_cols, src_nnz=0,
        )
    n_row_blocks = -(-n // rb)
    vals_src = csr.values_or_ones(np.float32)

    # Per (local row, col-block) accumulation.
    # Vectorized gather of all edges of the selected rows.
    edge_row, edge_col, pos = _expand_edges(csr, rows)
    total = pos.shape[0]
    edge_val = vals_src[pos] if total else np.zeros(0, np.float32)

    blk_row = edge_row // rb
    sub_row = edge_row % rb
    blk_col = edge_col // bc
    sub_col = edge_col % bc

    # unique (blk_row, blk_col) pairs -> slots
    key_base = _slot_key_base(csr, bc)
    key = blk_row.astype(np.int64) * key_base + blk_col
    uniq, inv = np.unique(key, return_inverse=True)
    u_blk_row = (uniq // key_base).astype(np.int64)
    u_blk_col = (uniq % key_base).astype(np.int32)

    nslots = np.zeros(n_row_blocks, np.int32)
    np.add.at(nslots, u_blk_row, 1)
    width = int(nslots.max()) if nslots.size else 0
    width = max(width, min_width)
    width = -(-width // width_multiple) * width_multiple
    # slot/blkptr index arrays downstream are int32; fail loudly before
    # allocating a layout whose indices would silently wrap
    _check_int32("nnz of the row subset", int(total))
    _check_int32("dense slot grid (n_row_blocks * width)", n_row_blocks * width)

    # slot index of each unique pair within its row-block
    order = np.argsort(uniq, kind="stable")  # uniq already sorted; identity
    slot_of_uniq = np.zeros(uniq.shape[0], np.int64)
    # running count per row block (uniq sorted by key => grouped by blk_row)
    if uniq.size:
        starts_per_block = np.concatenate([[0], np.cumsum(nslots)[:-1]])
        slot_of_uniq = np.arange(uniq.shape[0]) - starts_per_block[u_blk_row]

    colblk = np.zeros((n_row_blocks, width), np.int32)
    vals = np.zeros((n_row_blocks, width, rb, bc), np.float32)
    if uniq.size:
        colblk[u_blk_row, slot_of_uniq] = u_blk_col
        np.add.at(
            vals,
            (blk_row, slot_of_uniq[inv], sub_row, sub_col),
            edge_val,
        )

    del order
    return BlockELL(
        colblk=colblk,
        vals=vals,
        nslots=nslots,
        rb=rb,
        bc=bc,
        n_rows=n,
        n_cols=csr.n_cols,
        src_nnz=total,
    )


def csr_to_ragged(
    csr: CSR, rb: int = 8, bc: int = 8
) -> Tuple[RaggedBlockELL, float, dict]:
    """``csr_to_block_ell(csr, rb, bc).to_ragged()``, that BlockELL's
    ``padding_frac`` and the ragged edge index, without building the
    dense-W table.

    The same arrays (the values accumulate cell by cell in the same edge
    order), at a fraction of the host memory and time: at Reddit-0.25
    the dense-W table a ragged layout is cut from holds 13.6 GB.

    The edge index maps every CSR edge, in storage order, to its cell of
    the ragged tiles: int32 ``edge_slot`` (the flat slot, which is
    ``blkptr[edge_blkrow] + edge_slot`` of `block_ell_edge_index`),
    ``edge_r`` and ``edge_c``.
    """
    n = csr.n_rows
    if n == 0:
        bell = csr_to_block_ell(csr, rb=rb, bc=bc)
        z = np.zeros(0, np.int32)
        return bell.to_ragged(), bell.padding_frac, {"edge_slot": z, "edge_r": z, "edge_c": z}
    nrb = -(-n // rb)
    vals_src = csr.values_or_ones(np.float32)
    edge_row, edge_col, pos = _expand_edges(csr, np.arange(n))
    total = pos.shape[0]
    _check_int32("nnz of the row subset", int(total))
    blk_row = edge_row // rb
    key_base = _slot_key_base(csr, bc)
    key = blk_row.astype(np.int64) * key_base + edge_col // bc
    uniq, inv = np.unique(key, return_inverse=True)
    u_blk_row = (uniq // key_base).astype(np.int64)
    nslots = np.bincount(u_blk_row, minlength=nrb).astype(np.int64)
    width = max(int(nslots.max()), 1)
    blkptr = np.zeros(nrb + 1, np.int64)
    np.cumsum(np.maximum(nslots, 1), out=blkptr[1:])
    n_slots = int(blkptr[-1])
    _check_int32("ragged slot count (blkptr[-1])", n_slots)
    # slot of each unique (row block, col block) pair: the row block's
    # first slot plus its rank inside the block; an empty block keeps
    # its one all-zero dummy slot at column block 0
    starts = np.concatenate([[0], np.cumsum(nslots)[:-1]])
    slot_of_uniq = blkptr[u_blk_row] + np.arange(uniq.shape[0]) - starts[u_blk_row]
    slot_colblk = np.zeros(n_slots, np.int32)
    slot_colblk[slot_of_uniq] = (uniq % key_base).astype(np.int32)
    edges = {
        "edge_slot": slot_of_uniq[inv].astype(np.int32),
        "edge_r": (edge_row % rb).astype(np.int32),
        "edge_c": (edge_col % bc).astype(np.int32),
    }
    slot_vals = np.zeros((n_slots, rb, bc), np.float32)
    if total:
        np.add.at(slot_vals, (edges["edge_slot"], edges["edge_r"], edges["edge_c"]),
                  vals_src[pos])
    rag = RaggedBlockELL(
        blkptr=blkptr.astype(np.int32),
        slot_rowblk=np.repeat(np.arange(nrb, dtype=np.int32), np.maximum(nslots, 1)),
        slot_colblk=slot_colblk,
        slot_vals=slot_vals,
        rb=rb, bc=bc, n_rows=n, n_cols=csr.n_cols, src_nnz=total,
    )
    return rag, 1.0 - float(nslots.sum()) / (nrb * width), edges


def block_ell_edge_index(
    csr: CSR, bell: BlockELL, rows: Optional[np.ndarray] = None
) -> dict:
    """Map every stored CSR edge (in CSR storage order) to its micro-tile
    cell in ``bell`` (built from the same csr/rows via csr_to_block_ell).

    Returns int32 arrays of length nnz(rows):
      edge_blkrow — owning row block
      edge_slot   — slot index within that row block (dense-W layout)
      edge_r/edge_c — position inside the (rb, bc) tile
    The ragged (flat) slot id of an edge is
    ``ragged.blkptr[edge_blkrow] + edge_slot`` — within-block slot order
    is identical in both layouts (to_ragged concatenates live slots).

    This is what lets a block-ELL SDDMM variant return the baseline's
    CSR-ordered nnz vector: gather the kernel's tile output at these
    indices. Duplicate (row, col) edges map to the same cell — both read
    the same <X_i, Y_j>, matching gather_dot per-edge semantics.
    """
    rb, bc = bell.rb, bell.bc
    if rows is None:
        rows = np.arange(csr.n_rows)
    rows = np.asarray(rows)
    edge_row, edge_col, pos = _expand_edges(csr, rows)
    if pos.shape[0] == 0:
        z = np.zeros(0, np.int32)
        return {"edge_blkrow": z, "edge_slot": z, "edge_r": z, "edge_c": z}

    blk_row = (edge_row // rb).astype(np.int64)
    blk_col = (edge_col // bc).astype(np.int64)
    # slots within a row block are stored in ascending column-block
    # order (np.unique in csr_to_block_ell), so a sorted search over the
    # same composite key recovers each edge's slot
    edge_key = blk_row * _slot_key_base(csr, bc) + blk_col
    # the inverse of np.unique is the searchsorted position; asking for
    # it keeps numpy on its sorting path (a bare np.unique of tens of
    # millions of keys takes a far slower path on some numpy releases)
    _, uniq_slot = np.unique(edge_key, return_inverse=True)
    slot_starts = np.concatenate(
        [[0], np.cumsum(bell.nslots[:-1], dtype=np.int64)]
    )
    edge_slot = uniq_slot - slot_starts[blk_row]
    return {
        "edge_blkrow": blk_row.astype(np.int32),
        "edge_slot": edge_slot.astype(np.int32),
        "edge_r": (edge_row % rb).astype(np.int32),
        "edge_c": (edge_col % bc).astype(np.int32),
    }


def hub_split(
    csr: CSR, hub_threshold: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Partition row ids into (hub_rows, light_rows) by degree threshold.

    The block-ELL form of the paper's CTA-per-hub mapping: heavy rows get
    their own BlockELL partition (large width, no padding pressure on
    light rows); light rows get a narrow-width partition.
    """
    deg = csr.degrees
    hub = np.nonzero(deg > hub_threshold)[0]
    light = np.nonzero(deg <= hub_threshold)[0]
    return hub, light
