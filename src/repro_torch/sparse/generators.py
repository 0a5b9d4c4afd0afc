"""Synthetic graph generators matching the paper's workloads.

REDDIT / OGBN-PRODUCTS are replaced by synthetic graphs that match their
published *shape statistics* (node count, edge count, degree-distribution
family). All generators are vectorized numpy. Port of
repro/sparse/generators.py: the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sparse.csr import CSR, csr_from_coo


def _csr_from_degrees(
    degrees: np.ndarray, n_cols: int, rng: np.random.Generator
) -> CSR:
    """Build a CSR with given per-row degrees and uniform random columns."""
    degrees = degrees.astype(np.int64)
    n = degrees.shape[0]
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=rowptr[1:])
    nnz = int(rowptr[-1])
    colind = rng.integers(0, n_cols, size=nnz, dtype=np.int64)
    # sort columns within each row for locality (cheap global trick:
    # sort by row-id * n_cols + col)
    row_of = np.repeat(np.arange(n), degrees)
    order = np.argsort(row_of * n_cols + colind, kind="stable")
    colind = colind[order]
    return CSR(
        rowptr.astype(np.int32), colind.astype(np.int32), None, n, n_cols
    )


def erdos_renyi(n: int = 200_000, p: float = 2e-5, seed: int = 0) -> CSR:
    """ER graph per §8.2 (Table 4): N=200k, p=2e-5 => ~4 nnz/row."""
    rng = np.random.default_rng(seed)
    m = rng.binomial(n * n, p)
    rows = rng.integers(0, n, size=m, dtype=np.int64)
    cols = rng.integers(0, n, size=m, dtype=np.int64)
    return csr_from_coo(rows, cols, n, n)


def hub_skew(
    n: int = 200_000,
    base_deg: int = 4,
    hub_frac: float = 0.15,
    hub_deg: int = 1000,
    seed: int = 0,
) -> CSR:
    """Hub-skew synthetic per §8.2/§8.5: a fraction of rows are heavy hubs.

    Paper parameterization "N=200,000, k=4, h=0.15": k = base degree,
    h = hub row fraction. Hub degree is a free knob (Table 10 uses
    explicit hub/other degrees); default 1000 gives the heavy tail the
    split targets.
    """
    rng = np.random.default_rng(seed)
    deg = np.full(n, base_deg, dtype=np.int64)
    n_hubs = int(n * hub_frac)
    hub_rows = rng.choice(n, size=n_hubs, replace=False)
    deg[hub_rows] = hub_deg
    return _csr_from_degrees(deg, n, rng)


def single_hub(
    n: int = 512,
    nnz_frac: float = 0.9,
    base_deg: int = 2,
    seed: int = 0,
) -> CSR:
    """All-hub extreme: one row owns ``nnz_frac`` of the graph's nnz.

    The degenerate end of the skew axis (paper §8.5 stress tests): every
    row-partitioned kernel serializes the hub row's whole slot chain in
    one grid cell, while merge-path spreads it over deg/tile_slots cells.
    ``deg_max/deg_mean`` here is ~n*nnz_frac, far past the balance_bin
    boundary, so the estimate must rank merge-path first without a probe.
    """
    rng = np.random.default_rng(seed)
    deg = np.full(n, base_deg, dtype=np.int64)
    light_nnz = int(deg.sum()) - base_deg
    # duplicate columns within the hub row are fine (values accumulate)
    hub_deg = int(light_nnz * nnz_frac / max(1.0 - nnz_frac, 1e-6))
    deg[0] = max(hub_deg, base_deg)
    return _csr_from_degrees(deg, n, rng)


def table10_graph(
    n: int = 20_000, hub_deg: int = 5_000, other_deg: int = 64, seed: int = 0
) -> CSR:
    """Table 10 settings: N=20k, hub=5k/12k, other=64/32; 1% rows are hubs."""
    rng = np.random.default_rng(seed)
    deg = np.full(n, other_deg, dtype=np.int64)
    n_hubs = max(1, n // 100)
    deg[rng.choice(n, size=n_hubs, replace=False)] = hub_deg
    return _csr_from_degrees(deg, n, rng)


def reddit_like(scale: float = 0.05, seed: int = 0) -> CSR:
    """Reddit-shaped graph: N=232 965, ~114.6M edges, avg deg ~492,
    heavy-tailed (lognormal) degrees. ``scale`` shrinks node count and
    edge count together so avg degree (the bandwidth-bound regime driver)
    is preserved at ~scale*492 ... no: we preserve *average degree* by
    shrinking only N; full size via scale=1.0 (needs ~1.4 GB colind).
    """
    n = max(1024, int(232_965 * scale))
    avg_deg = 492.0 * min(1.0, scale * 4 + 0.25)  # cap host memory at small scale
    rng = np.random.default_rng(seed)
    # lognormal with heavy tail, normalized to target average degree
    raw = rng.lognormal(mean=0.0, sigma=1.4, size=n)
    deg = np.maximum(1, (raw / raw.mean() * avg_deg)).astype(np.int64)
    return _csr_from_degrees(deg, n, rng)


def products_like(scale: float = 0.01, seed: int = 0) -> CSR:
    """OGBN-Products-shaped: N=2 449 029, ~123.7M edges, avg deg ~50.5."""
    n = max(1024, int(2_449_029 * scale))
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=0.0, sigma=1.1, size=n)
    deg = np.maximum(1, (raw / raw.mean() * 50.5)).astype(np.int64)
    return _csr_from_degrees(deg, n, rng)


def power_law(
    n: int,
    alpha: float,
    avg_deg: float = 8.0,
    n_cols: Optional[int] = None,
    seed: int = 0,
) -> CSR:
    """Power-law degree graph: degree of rank-i row ∝ (i+1)^-alpha,
    normalized to ``avg_deg`` and shuffled over row ids. alpha = 0 is
    uniform; alpha ≳ 1.2 concentrates edges in a few hub rows."""
    rng = np.random.default_rng(seed)
    m = n_cols if n_cols is not None else n
    raw = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    deg = np.maximum(1, raw / raw.mean() * avg_deg).astype(np.int64)
    deg = np.minimum(deg, m)  # a row cannot usefully exceed n_cols edges
    rng.shuffle(deg)
    return _csr_from_degrees(deg, m, rng)


def fixed_degree(n: int, deg: int, n_cols: Optional[int] = None, seed: int = 0) -> CSR:
    """Uniform-degree graph: every row has exactly ``deg`` neighbors."""
    rng = np.random.default_rng(seed)
    return _csr_from_degrees(
        np.full(n, deg, dtype=np.int64), n_cols if n_cols is not None else n, rng
    )


def sample_subgraph_stream(
    parents: Sequence[CSR],
    n_graphs: int,
    rows_per_graph: int,
    seed: int = 0,
) -> List[CSR]:
    """Minibatch-style stream of induced subgraphs, cycling over parents:
    each a uniform random row subset carrying its full adjacency (batch
    rows aggregate over all their neighbours). Subgraphs of one parent
    differ in the rows sampled and share its degree regime, the workload
    `core.batch.BatchScheduler` buckets."""
    rng = np.random.default_rng(seed)
    out: List[CSR] = []
    for i in range(n_graphs):
        parent = parents[i % len(parents)]
        n = min(rows_per_graph, parent.n_rows)
        rows = np.sort(rng.choice(parent.n_rows, size=n, replace=False))
        out.append(parent.row_slice(rows))
    return out


def regime_shift_stream(
    n_graphs: int,
    rows_per_graph: int,
    n: int = 2048,
    alpha_lo: float = 0.0,
    alpha_hi: float = 1.6,
    avg_deg: float = 8.0,
    shift_at: float = 0.5,
    seed: int = 0,
) -> List[CSR]:
    """Minibatch stream whose input regime drifts mid-stream: subgraphs
    of power-law parents whose alpha stays at ``alpha_lo`` for the first
    ``shift_at`` of the stream, then ramps to ``alpha_hi``. The
    stale-decision workload the drift detector in core/batch.py catches.
    Consecutive graphs share a parent in pairs, so the regime moves only
    with alpha."""
    rng = np.random.default_rng(seed)
    out: List[CSR] = []
    n_stationary = int(n_graphs * shift_at)
    for i in range(n_graphs):
        if i < n_stationary:
            alpha = alpha_lo
        else:
            ramp = (i - n_stationary) / max(n_graphs - n_stationary - 1, 1)
            alpha = alpha_lo + (alpha_hi - alpha_lo) * ramp
        parent = power_law(n, alpha, avg_deg=avg_deg, seed=seed + 1000 + (i // 2))
        rows = np.sort(
            rng.choice(parent.n_rows, size=min(rows_per_graph, parent.n_rows),
                       replace=False)
        )
        out.append(parent.row_slice(rows))
    return out
