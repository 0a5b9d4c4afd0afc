"""On-device micro-probes (paper §4.2).

Port of repro/core/probe.py. Probes time candidates on an *induced
subgraph* — a stride sample of rows (default 2% of rows, min 512)
carrying their full adjacency, so per-row work distribution is
preserved. Each candidate runs once to warm up (kernel build, caches),
then is timed for `iters` iterations under a wall-time cap; the median
is reported, as in the paper. On a CUDA device each iteration is timed
with CUDA events around the call and a synchronize; on the CPU with
`time.perf_counter`.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import faultinject
from repro_torch.sparse.csr import CSR

DEFAULT_FRAC = float(os.environ.get("AUTOSAGE_PROBE_FRAC", "0.02"))
DEFAULT_MIN_ROWS = int(os.environ.get("AUTOSAGE_PROBE_MIN_ROWS", "512"))
DEFAULT_ITERS = int(os.environ.get("AUTOSAGE_PROBE_ITERS", "5"))
DEFAULT_CAP_MS = float(os.environ.get("AUTOSAGE_PROBE_CAP_MS", "1000"))


def induced_subgraph(
    csr: CSR, frac: float = DEFAULT_FRAC, min_rows: int = DEFAULT_MIN_ROWS,
    seed: int = 0, n_rows: Optional[int] = None,
) -> CSR:
    n = csr.n_rows
    n_sample = n_rows if n_rows is not None else max(min_rows, int(n * frac))
    n_sample = min(n, n_sample)
    # deterministic stride sample: identical sampling across candidates
    stride = max(1, n // n_sample)
    rows = np.arange(0, n, stride)[:n_sample]
    return csr.row_slice(rows)


@dataclasses.dataclass
class ProbeResult:
    name: str
    median_ms: float
    times_ms: List[float]
    iters_done: int
    capped: bool


def _timed_ms(fn: Callable[[], torch.Tensor], device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def time_callable(
    fn: Callable[[], torch.Tensor],
    device: torch.device,
    iters: int = DEFAULT_ITERS,
    cap_ms: float = DEFAULT_CAP_MS,
    name: str = "?",
) -> ProbeResult:
    """Median time of fn() on ``device`` under a wall-time cap."""
    faultinject.fault_point("probe", name=name)
    fn()  # warm-up (kernel build, allocator) — excluded, as in §6
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    start = time.perf_counter()
    capped = False
    for _ in range(iters):
        times.append(_timed_ms(fn, device))
        if (time.perf_counter() - start) * 1e3 > cap_ms:
            capped = True
            break
    return ProbeResult(
        name=name,
        median_ms=statistics.median(times),
        times_ms=times,
        iters_done=len(times),
        capped=capped,
    )
