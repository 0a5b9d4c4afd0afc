"""Scheduler flight recorder: spans, metrics and the estimate scorecard.

Port of the part of repro/core/obs.py that the scheduler stack calls:

  spans     nested spans over the decision procedure (``decide`` ->
            ``features``/``estimate``/``shortlist``/``probe``/
            ``guardrail``/``transfer``, ``prepare``, ``fwd.spmm``/
            ``run``, ``fault``, ``cache.lock_wait``/``cache.merge``), recorded in memory only when ``AUTOSAGE_OBS`` is
            set and this is not a replay run. The Perfetto export waits
            for a later slice.
  metrics   the process-wide registry of counters and log-bucketed
            histograms under the JAX package's metric names
            (``autosage_decides_total{op,tier,scheduler}``,
            ``autosage_probe_ms``, ``autosage_prepare_ms``, the
            resilience layer's ``autosage_faults_total{site,kind}``,
            ``autosage_fallback_total{from,to}`` and
            ``autosage_quarantine_total{event}``, the shared cache's
            ``autosage_cache_lock_wait_ms{outcome}`` and
            ``autosage_cache_merge_ms``, the transfer tier's
            ``autosage_transfer_verdict_total{verdict}``, ...). It
            always counts in memory and never writes files.
  scorecard every probe feeds (candidate, est_ms, measured_ms) pairs
            into ``autosage_est_abs_err_ms`` / ``autosage_est_rel_err``;
            the batch scheduler's ``observe`` feeds live runtimes.
  counters  `ScopedCounter`: a per-object count mirrored into the
            registry (the batch scheduler's stream counters).

This module imports nothing from the rest of the package
(sparse/csr.py and core/cache.py sit below it in the import graph).
"""
from __future__ import annotations

import bisect
import math
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


def enabled() -> bool:
    """Span recording on? AUTOSAGE_OBS set (and not "0"/"") AND not a
    replay-determinism run. Read per call, so tests can rotate env."""
    env = os.environ
    if env.get("AUTOSAGE_OBS") in (None, "", "0"):
        return False
    return env.get("AUTOSAGE_REPLAY_ONLY") != "1"


# completed spans as raw (name, t0_ns, t1_ns, tid, parent, depth, args)
_SPAN_CAP = int(os.environ.get("AUTOSAGE_OBS_SPAN_CAP", "200000"))
_spans: List[Tuple] = []
_tls = threading.local()


@contextmanager
def span(name: str, **args: Any):
    """Record one nested span; a no-op unless `enabled()`."""
    if not enabled():
        yield None
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    depth = len(stack)
    stack.append(name)
    t0 = time.perf_counter_ns()
    try:
        yield None
    finally:
        t1 = time.perf_counter_ns()
        stack.pop()
        if len(_spans) < _SPAN_CAP:
            _spans.append(
                (name, t0, t1, threading.get_ident(), parent, depth, args or None)
            )


def span_totals_ms() -> Dict[str, float]:
    """Total wall ms per span name over the spans recorded so far."""
    out: Dict[str, float] = {}
    for name, t0, t1, *_ in list(_spans):
        out[name] = out.get(name, 0.0) + (t1 - t0) * 1e-6
    return out


# log-spaced histogram bucket bounds (ms), sqrt(2) apart
_H_FACTOR = math.sqrt(2.0)
_H_BOUNDS: Tuple[float, ...] = tuple(1e-3 * _H_FACTOR ** i for i in range(54))


class Histogram:
    """Fixed log-bucket histogram (counts, sum, min, max)."""

    __slots__ = ("counts", "count", "sum", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * (len(_H_BOUNDS) + 1)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(_H_BOUNDS, v)] += 1
        self.count += 1
        self.sum += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Process-wide counters and histograms keyed by (name, labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[Tuple, float]] = {}
        self._hists: Dict[str, Dict[Tuple, Histogram]] = {}

    def inc(self, name: str, n: float = 1.0, **labels: Any) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[lk] = series.get(lk, 0.0) + n

    def set_counter(self, name: str, v: float, **labels: Any) -> None:
        """Direct counter assignment, for reset paths only."""
        with self._lock:
            self._counters.setdefault(name, {})[_label_key(labels)] = float(v)

    def observe(self, name: str, v: float, **labels: Any) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            h = series.get(lk)
            if h is None:
                h = series[lk] = Histogram()
            h.observe(v)

    def get(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels))

    def total(self, name: str, **labels: Any) -> float:
        """Sum of a counter over every label set matching ``labels``
        (subset match: total("x", op="spmm") sums all tiers)."""
        want = {k: str(v) for k, v in labels.items()}
        out = 0.0
        with self._lock:
            for lk, v in self._counters.get(name, {}).items():
                d = dict(lk)
                if all(d.get(k) == val for k, val in want.items()):
                    out += v
        return out

    def hist_series(self, name: str) -> Dict[Tuple, Histogram]:
        """Every label set of one histogram, label key -> Histogram."""
        with self._lock:
            return dict(self._hists.get(name, {}))


REGISTRY = MetricsRegistry()


class ScopedCounter:
    """A per-instance counter mirrored into the process registry, the one
    accounting path for per-object stats such as BatchScheduler's.
    ``value`` is the instance-local total (what `stats()` reports); every
    inc() also lands on the named registry counter with the given labels,
    so the process-wide series aggregate across instances."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1, **labels: Any) -> None:
        self.value += n
        REGISTRY.inc(self.name, n, **labels)


def _op_family(op: str) -> str:
    try:  # lazy: obs must not import the package at module level
        from repro_torch.core.features import op_kind

        return op_kind(op)
    except KeyError:
        return op


def record_estimate(
    op: str,
    candidate: str,
    est_ms: Optional[float],
    measured_ms: Optional[float],
    source: str = "probe",
) -> None:
    """One (candidate, est_ms, measured_ms) scorecard pair."""
    if est_ms is None or measured_ms is None:
        return
    est_ms, measured_ms = float(est_ms), float(measured_ms)
    if not (math.isfinite(est_ms) and math.isfinite(measured_ms)):
        return
    fam = _op_family(op)
    abs_err = abs(measured_ms - est_ms)
    REGISTRY.observe("autosage_est_abs_err_ms", abs_err, family=fam, source=source)
    REGISTRY.observe(
        "autosage_est_rel_err", abs_err / max(measured_ms, 1e-9),
        family=fam, source=source,
    )
    REGISTRY.inc(
        "autosage_est_pairs_total", family=fam, source=source,
        candidate_kind="baseline" if candidate == "baseline" else "challenger",
    )


def record_probe_estimates(
    op: str,
    probe_ms: Dict[str, float],
    estimates_ms: Dict[str, float],
    baseline_name: str,
) -> None:
    """Scorecard-feed every probed candidate against its roofline
    estimate ("baseline" maps to the baseline variant's estimate key)."""
    for cand, measured in probe_ms.items():
        est = estimates_ms.get(baseline_name if cand == "baseline" else cand)
        record_estimate(op, cand, est, measured, source="probe")
