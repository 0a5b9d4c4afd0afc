"""Reddit- and Products-shaped graphs: a torch rewrite, on the device, of
``reddit_like`` / ``products_like`` (the port's ``sparse/generators.py``).
Lognormal degrees normalised to the dataset's average degree, uniform
columns sorted within each row, duplicates removed on request. The
numpy originals take 14.0 s / 9.0 s on a host CPU at full size; here
the work is a few device sorts.

Configuration keys: ``num_nodes``, ``avg_degree``, ``degree_sigma``,
``dedup``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.gen.graphs import Graph


def make(config: Dict[str, Any], gen: torch.Generator) -> Graph:
    return random_graph(config["num_nodes"], config["avg_degree"], config["degree_sigma"], gen,
                        dedup=config["dedup"])


def random_graph(n: int, avg_degree: float, sigma: float, gen: torch.Generator,
                 dedup: bool = False) -> Graph:
    """Degrees lognormal(0, sigma), scaled to ``avg_degree`` on average,
    floored, at least 1 (the port's generators' rule); uniform columns in
    [0, n), sorted within each row; with ``dedup`` every repeated (row,
    col) pair is kept once."""
    device = gen.device
    raw = torch.empty(n, dtype=torch.float64, device=device).log_normal_(0.0, sigma, generator=gen)
    deg = torch.clamp((raw / raw.mean() * avg_degree).floor(), min=1).to(torch.int64)
    nnz = int(deg.sum())
    rows = torch.repeat_interleave(torch.arange(n, device=device), deg)
    cols = torch.randint(0, n, (nnz,), generator=gen, device=device)
    key = torch.sort(rows * n + cols).values
    del rows, cols
    if dedup:
        key = torch.unique_consecutive(key)
    rows = torch.div(key, n, rounding_mode="floor")
    colind = key - rows * n
    counts = torch.bincount(rows, minlength=n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=rowptr[1:])
    return Graph(rowptr, colind, n, n)
