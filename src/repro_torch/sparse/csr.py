"""CSR container and host-side utilities.

The CSR triplet (rowptr, colind, val) follows the paper's notation (§3).
Index arrays live as numpy on host (they parameterize kernel schedules and
cache keys); values are numpy too. Port of repro/sparse/csr.py: the same
arrays and the same graph signature, so schedule-cache keys agree.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, MutableMapping, Optional, Tuple

import numpy as np


class _TransposeStats(MutableMapping):
    """Transposed-layout cache telemetry, backed by the process metrics
    registry (``autosage_transpose_total{event=built|hits}``) so there is
    exactly one accounting path (core/obs.py). Keeps the historical
    dict surface — ``TRANSPOSE_STATS["built"] += 1``, membership,
    iteration. The registry import is lazy per access: repro_torch.sparse.csr sits
    below repro_torch.core in the import graph."""

    _KEYS = ("built", "hits")

    @staticmethod
    def _registry():
        from repro_torch.core.obs import REGISTRY

        return REGISTRY

    def __getitem__(self, key: str) -> int:
        if key not in self._KEYS:
            raise KeyError(key)
        v = self._registry().get("autosage_transpose_total", event=key)
        return int(v or 0)

    def __setitem__(self, key: str, value: int) -> None:
        if key not in self._KEYS:
            raise KeyError(key)
        self._registry().set_counter(
            "autosage_transpose_total", int(value), event=key
        )

    def __delitem__(self, key: str) -> None:
        raise TypeError("TRANSPOSE_STATS keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __repr__(self) -> str:
        return repr(dict(self))


# "built" counts real O(nnz log nnz) conversions, "hits" counts
# per-object memo or structure-cache reuse.
TRANSPOSE_STATS: MutableMapping = _TransposeStats()

# process-level structure cache keyed by graph signature: training loops
# rebuild CSR objects per step (e.g. models/gnn._norm_csr re-weights the
# same structure), so a per-object memo alone would re-transpose each
# step. Values are NOT cached here (the signature hashes structure only);
# a hit replays the cached permutation over the caller's values.
_TRANSPOSE_BY_SIG: Dict[str, tuple] = {}
_TRANSPOSE_BY_SIG_CAP = 32


def reset_transpose_stats() -> None:
    TRANSPOSE_STATS["built"] = 0
    TRANSPOSE_STATS["hits"] = 0


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix of shape (n_rows, n_cols).

    rowptr: int32[n_rows + 1]
    colind: int32[nnz]
    val:    float[nnz] (may be None => implicit ones, e.g. unweighted graph)
    """

    rowptr: np.ndarray
    colind: np.ndarray
    val: Optional[np.ndarray]
    n_rows: int
    n_cols: int

    # ---- invariants -------------------------------------------------
    def validate(self) -> None:
        assert self.rowptr.ndim == 1 and self.rowptr.shape[0] == self.n_rows + 1
        assert self.rowptr[0] == 0 and self.rowptr[-1] == self.nnz
        assert np.all(np.diff(self.rowptr) >= 0), "rowptr must be nondecreasing"
        if self.nnz:
            assert self.colind.min() >= 0 and self.colind.max() < self.n_cols
        if self.val is not None:
            assert self.val.shape == (self.nnz,)

    # ---- basic properties -------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.colind.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr).astype(np.int64)

    def degree_quantiles(self, qs=(0.5, 0.9, 0.99, 1.0)) -> np.ndarray:
        d = self.degrees
        if d.size == 0:
            return np.zeros(len(qs))
        return np.quantile(d, qs)

    def values_or_ones(self, dtype=np.float32) -> np.ndarray:
        if self.val is not None:
            return np.asarray(self.val, dtype=dtype)
        return np.ones(self.nnz, dtype=dtype)

    # ---- conversions -------------------------------------------------
    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=dtype)
        v = self.values_or_ones(dtype)
        for r in range(self.n_rows):
            lo, hi = self.rowptr[r], self.rowptr[r + 1]
            # duplicate col indices accumulate, matching SpMM semantics
            np.add.at(out[r], self.colind[lo:hi], v[lo:hi])
        return out

    def row_slice(self, rows: np.ndarray) -> "CSR":
        """Induced subgraph on a row subset (keeps all columns).

        This is the paper's probe subgraph: a fraction of rows with their
        full adjacency, so per-row work distribution is preserved.
        """
        rows = np.asarray(rows)
        deg = self.degrees[rows]
        new_rowptr = np.zeros(rows.shape[0] + 1, dtype=np.int32)
        np.cumsum(deg, out=new_rowptr[1:])
        nnz = int(new_rowptr[-1])
        new_colind = np.empty(nnz, dtype=np.int32)
        new_val = None if self.val is None else np.empty(nnz, dtype=self.val.dtype)
        for i, r in enumerate(rows):
            lo, hi = self.rowptr[r], self.rowptr[r + 1]
            o_lo, o_hi = new_rowptr[i], new_rowptr[i + 1]
            new_colind[o_lo:o_hi] = self.colind[lo:hi]
            if new_val is not None:
                new_val[o_lo:o_hi] = self.val[lo:hi]
        return CSR(new_rowptr, new_colind, new_val, rows.shape[0], self.n_cols)


    def structural(self) -> "CSR":
        """Values-free view of this matrix (same rowptr/colind, val=None).

        Memoized per object, and the view inherits the parent's graph
        signature memo (signatures hash structure only), so schedulers
        keyed on structure never re-hash. Ops whose sparse values are a
        runtime operand (the `*_bwd_*` grad ops in core/autodiff.py)
        build their layouts from this view.
        """
        if self.val is None:
            return self
        memo = getattr(self, "_structural_memo", None)
        if memo is None:
            memo = CSR(self.rowptr, self.colind, None, self.n_rows, self.n_cols)
            object.__setattr__(memo, "_sig_memo", graph_signature(self))
            dup = getattr(self, "_dup_memo", None)
            if dup is not None:
                object.__setattr__(memo, "_dup_memo", dup)
            object.__setattr__(self, "_structural_memo", memo)
        return memo

    def transpose(self) -> "CSR":
        """A^T as CSR (n_cols x n_rows); memoized — see transpose_with_perm."""
        return self.transpose_with_perm()[0]

    def transpose_with_perm(self) -> Tuple["CSR", np.ndarray]:
        """(A^T, perm) where ``A^T.val == A.val[perm]`` edge-for-edge.

        The backward pass of every scheduled op needs the transposed
        layout (grad w.r.t. the dense operand of SpMM is A^T @ grad_C;
        SDDMM grads scatter the cotangent through A and A^T), so this is
        memoized twice over: per object, and per graph signature in a
        bounded process-level cache whose entries hold structure + the
        edge permutation only. A training step therefore pays the
        O(nnz log nnz) conversion once per graph, not once per step —
        `AutoSage.build_runner`'s runner memo then keys on the stable
        transposed signature, so the backward kernel's prepared layout
        is reused too. Duplicate edges stay distinct entries (SpMM
        semantics accumulate them).
        """
        memo = getattr(self, "_transpose_memo", None)
        if memo is not None:
            TRANSPOSE_STATS["hits"] += 1
            return memo
        sig = graph_signature(self)
        cached = _TRANSPOSE_BY_SIG.get(sig)
        if cached is not None:
            t_rowptr, t_colind, order, t_sig = cached
            TRANSPOSE_STATS["hits"] += 1
        else:
            rows = np.repeat(
                np.arange(self.n_rows, dtype=np.int64), self.degrees
            )
            # sort edges by (col, row): the transposed CSR order
            order = np.lexsort((rows, self.colind)).astype(np.int64)
            t_rowptr = np.zeros(self.n_cols + 1, dtype=np.int32)
            np.add.at(t_rowptr[1:], self.colind, 1)
            np.cumsum(t_rowptr, out=t_rowptr)
            t_colind = rows[order].astype(np.int32)
            t = CSR(t_rowptr, t_colind, None, self.n_cols, self.n_rows)
            t_sig = graph_signature(t)
            while len(_TRANSPOSE_BY_SIG) >= _TRANSPOSE_BY_SIG_CAP:
                _TRANSPOSE_BY_SIG.pop(next(iter(_TRANSPOSE_BY_SIG)))
            _TRANSPOSE_BY_SIG[sig] = (t_rowptr, t_colind, order, t_sig)
            TRANSPOSE_STATS["built"] += 1
        t_val = None if self.val is None else np.asarray(self.val)[order]
        t = CSR(t_rowptr, t_colind, t_val, self.n_cols, self.n_rows)
        object.__setattr__(t, "_sig_memo", t_sig)
        memo = (t, order)
        object.__setattr__(self, "_transpose_memo", memo)
        return memo

    def has_duplicate_edges(self) -> bool:
        """True if some (row, col) pair is stored more than once.

        SpMM semantics accumulate duplicates, but attention masking does
        not: block-ELL conversion merges duplicates into one mask entry,
        so fused attention and the 3-kernel pipeline diverge on
        multigraphs. The scheduler gates the fused variant on this.
        Sort-independent (validate() never enforces within-row order).
        """
        if self.nnz < 2:
            return False
        memo = getattr(self, "_dup_memo", None)
        if memo is None:
            rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.degrees)
            key = rows * self.n_cols + self.colind.astype(np.int64)
            # sort + neighbour compare, not np.unique: some numpy releases
            # take a far slower path for a bare np.unique of a large array
            key.sort()
            memo = bool((key[1:] == key[:-1]).any())
            # memoized: feature extraction runs per decide (incl. warm-cache
            # hits in training loops)
            object.__setattr__(self, "_dup_memo", memo)
        return memo

    def dedup_edges(self) -> "CSR":
        """Collapse duplicate (row, col) entries, summing their values.

        Attention treats the sparsity pattern as a set of edges; use this
        to canonicalize generator output (which samples columns with
        replacement) before running the attention pipeline.
        """
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.degrees)
        key = rows * self.n_cols + self.colind.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        new_rows = (uniq // self.n_cols).astype(np.int32)
        new_cols = (uniq % self.n_cols).astype(np.int32)
        new_val = None
        if self.val is not None:
            new_val = np.zeros(uniq.shape[0], dtype=self.val.dtype)
            np.add.at(new_val, inv, self.val)
        rowptr = np.zeros(self.n_rows + 1, dtype=np.int32)
        np.add.at(rowptr[1:], new_rows, 1)
        np.cumsum(rowptr, out=rowptr)
        return CSR(rowptr, new_cols, new_val, self.n_rows, self.n_cols)


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    n_rows: int,
    n_cols: int,
    val: Optional[np.ndarray] = None,
) -> CSR:
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    if val is not None:
        val = val[order]
    rowptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(rowptr[1:], rows, 1)
    np.cumsum(rowptr, out=rowptr)
    return CSR(
        rowptr.astype(np.int32),
        cols.astype(np.int32),
        None if val is None else np.asarray(val),
        n_rows,
        n_cols,
    )


def csr_from_dense(a: np.ndarray) -> CSR:
    rows, cols = np.nonzero(a)
    return csr_from_coo(
        rows.astype(np.int32),
        cols.astype(np.int32),
        a.shape[0],
        a.shape[1],
        a[rows, cols].astype(a.dtype),
    )


def graph_signature(csr: CSR) -> str:
    """Stable content hash used in the persistent schedule-cache key.

    Hashes the structure (rowptr/colind) but not values: the paper keys
    on graph structure + (F, op, device); values change per step.
    Memoized per CSR object: it runs on every decide and runner lookup.
    """
    memo = getattr(csr, "_sig_memo", None)
    if memo is not None:
        return memo
    h = hashlib.sha256()
    h.update(np.int64([csr.n_rows, csr.n_cols, csr.nnz]).tobytes())
    h.update(np.ascontiguousarray(csr.rowptr, dtype=np.int64).tobytes())
    # colind can be huge; hash a deterministic stride sample + exact edges
    ci = np.ascontiguousarray(csr.colind, dtype=np.int64)
    if ci.size > 1_000_000:
        h.update(ci[:: max(1, ci.size // 1_000_000)].tobytes())
        h.update(ci[-1024:].tobytes())
    else:
        h.update(ci.tobytes())
    sig = h.hexdigest()[:16]
    object.__setattr__(csr, "_sig_memo", sig)
    return sig
