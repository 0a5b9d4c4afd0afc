"""Scheduler flight recorder: spans, metrics, the estimate scorecard and
their exporters.

Port of repro/core/obs.py. Three instruments behind one gate
(``AUTOSAGE_OBS``):

  spans     nested spans over the decision procedure (``decide`` ->
            ``features``/``estimate``/``shortlist``/``probe``/
            ``guardrail``/``transfer``, ``prepare``, ``run``, the
            autodiff ``fwd.*``/``bwd.*`` op spans, the attention
            backward's ``softmax.recompute``/``softmax.vjp``,
            ``csr.transpose`` (builds only), ``model.norm_csr``,
            ``fault``, ``cache.lock_wait``/``cache.merge``,
            ``drift.reprobe``), recorded in memory only when
            ``AUTOSAGE_OBS`` is set and this is not a replay run, and
            exported as Chrome/Perfetto ``trace_event`` JSON. A span's
            wall time is host time: around an asynchronous CUDA launch
            it measures the launch, not the kernel. Two more views of
            the same span when it is recorded:
              * a ``torch.profiler.record_function`` range around its
                body, named after the span with ``.<op>`` appended
                (``decide.attention_bwd_q``, ``run.spmm``; a name that
                already ends in its op stays), ``choice`` in the range's
                args, so an active profiler puts the port's layers on
                the device timeline's own clock, on whatever thread ran
                them (autograd's included);
              * given the ``device`` its work runs on, a CUDA device, a
                pair of timing events on the current stream around the
                body, folded once the end event has completed into the
                histogram ``autosage_device_ms{span,op,choice}``: the
                stream time of the call, whatever kernels or torch ops
                implement it. A fold never waits: it takes only
                completed pairs, at each new record (the completed head
                of the queue) and before every registry read (all of
                them), so a read after a ``synchronize`` sees every pair.
  metrics   the process-wide registry of counters, gauges and
            log-bucketed histograms (p50/p95/p99 without sample storage)
            under the JAX package's metric names
            (``autosage_decides_total{op,tier,scheduler}``,
            ``autosage_probe_ms``, ``autosage_prepare_ms``,
            ``autosage_faults_total{site,kind}``,
            ``autosage_fallback_total{from,to}``,
            ``autosage_cache_lock_wait_ms{outcome}``,
            ``autosage_transfer_verdict_total{verdict}``, the serving
            tier's ``autosage_serve_requests_total{tier,op}``, ...),
            exported in Prometheus text format. It always counts in
            memory; `BatchScheduler.stats()` and sparse/csr.py's
            TRANSPOSE_STATS are views over it.
  scorecard every probe and every `BatchScheduler.observe()` feeds
            (candidate, est_ms, measured_ms) pairs into per-op-family
            error histograms (``autosage_est_abs_err_ms``).

Contract, as in the JAX package:

  * ``AUTOSAGE_OBS`` unset => no span, range or event is recorded and no
    file is ever created; counters still count in memory.
  * ``AUTOSAGE_REPLAY_ONLY=1`` => spans and file output are no-ops even
    with ``AUTOSAGE_OBS`` set, so replay runs stay bit-exact.
  * every line of a ``.jsonl`` stream is one complete record in one
    ``write()`` on an O_APPEND descriptor, so concurrent workers
    interleave whole lines.

This module imports nothing from the rest of the package
(sparse/csr.py and core/cache.py sit below it in the import graph), and
torch only on the enabled path.
"""
from __future__ import annotations

import atexit
import bisect
import json
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

OBS_SCHEMA = 1


def enabled() -> bool:
    """Span recording on? AUTOSAGE_OBS set (and not "0"/"") AND not a
    replay-determinism run. Read per call, so tests can rotate env."""
    env = os.environ
    if env.get("AUTOSAGE_OBS") in (None, "", "0"):
        return False
    return env.get("AUTOSAGE_REPLAY_ONLY") != "1"


def obs_dir() -> Path:
    """Where obs artifacts land: AUTOSAGE_OBS_DIR, else an ``obs/``
    subdirectory of AUTOSAGE_TELEMETRY_DIR, else results/obs."""
    d = os.environ.get("AUTOSAGE_OBS_DIR")
    if not d:
        t = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
        d = str(Path(t) / "obs") if t else "results/obs"
    return Path(d)


# ---------------------------------------------------------------- spans

# completed spans as raw (name, t0_ns, t1_ns, tid, parent, depth, args),
# rendered to records only at flush/export time: the decide hot path
# pays no dict build, no lock (list.append is atomic under the GIL) and
# no syscall per span
_SPAN_CAP = int(os.environ.get("AUTOSAGE_OBS_SPAN_CAP", "200000"))
_spans: List[Tuple] = []
_spans_lock = threading.Lock()  # flush/export/reset only, not the hot path
_spans_flushed = 0  # prefix of _spans already appended to spans.jsonl
_spans_dropped = 0
_active_dir: Optional[Path] = None  # obs dir captured at the first record
_tls = threading.local()
# wall-clock anchor: ts_us = anchor_wall + (perf_now - anchor_perf), so
# the hot path reads only the monotonic perf counter
_ANCHOR_WALL_NS = time.time_ns()
_ANCHOR_PERF_NS = time.perf_counter_ns()


def _jsonable(v: Any) -> Any:
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


def _render(rec: Tuple) -> Dict[str, Any]:
    """Raw span tuple -> the on-disk record schema."""
    name, t0, t1, tid, parent, depth, args = rec
    out: Dict[str, Any] = {
        "schema": OBS_SCHEMA,
        "name": name,
        "ph": "X",
        "ts_us": (_ANCHOR_WALL_NS + (t0 - _ANCHOR_PERF_NS)) // 1000,
        "dur_us": max((t1 - t0) // 1000, 1),
        "t_mono": t0 / 1e9,
        "pid": os.getpid(),
        "tid": tid,
        "parent": parent,
        "depth": depth,
    }
    if args:
        out["args"] = {k: _jsonable(v) for k, v in args.items()}
    return out


def _range_name(name: str, args: Dict[str, Any]) -> str:
    """The profiler range of a span: its name, ``.<op>`` appended unless
    the name already ends in its op."""
    op = args.get("op")
    if op is None or name.endswith(str(op)):
        return name
    return f"{name}.{op}"


@contextmanager
def span(name: str, device: Any = None, **args: Any):
    """Record one nested span; a no-op unless `enabled()`. A thread-local
    stack gives each span its parent and depth. The body runs inside a
    profiler range; with a CUDA ``device`` its stream time goes to
    ``autosage_device_ms`` once it has completed (a body that raises
    records none)."""
    if not enabled():
        yield None
        return
    import torch

    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    depth = len(stack)
    stack.append(name)
    t0 = time.perf_counter_ns()
    try:
        choice = args.get("choice")
        with torch.profiler.record_function(
                _range_name(name, args), None if choice is None else str(choice)):
            start = _record_event(device) if getattr(device, "type", None) == "cuda" else None
            yield None
            if start is not None:
                _push_device_pair(start, _record_event(device), name, args)
    finally:
        t1 = time.perf_counter_ns()
        stack.pop()
        global _spans_dropped, _active_dir
        if len(_spans) < _SPAN_CAP:
            _spans.append(
                (name, t0, t1, threading.get_ident(), parent, depth, args or None)
            )
            if _active_dir is None:
                _active_dir = obs_dir()
        else:
            _spans_dropped += 1


# ------------------------------------------------------ device time

DEVICE_MS = "autosage_device_ms"
# (start event, end event, labels) of device spans not yet folded, in
# record order
_pending: Deque[Tuple[Any, Any, Dict[str, str]]] = deque()
_pending_lock = threading.Lock()


def _record_event(device: Any) -> Any:
    """A timing event recorded now on ``device``'s current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _push_device_pair(start: Any, end: Any, name: str, args: Dict[str, Any]) -> None:
    labels = {"span": name}
    labels.update({k: str(args[k]) for k in ("op", "choice") if k in args})
    fold_device_times(head_only=True)
    with _pending_lock:
        _pending.append((start, end, labels))


def fold_device_times(head_only: bool = False) -> None:
    """Observe ``autosage_device_ms`` for each pending pair whose events
    have completed: the completed head of the queue, or with
    ``head_only`` False every completed pair. Never waits on the device;
    a pair whose events cannot be read any more is dropped."""
    if not _pending:
        return
    done = []
    with _pending_lock:
        try:
            if head_only:
                while _pending and _pending[0][1].query() and _pending[0][0].query():
                    done.append(_pending.popleft())
            else:
                rest = []
                for pair in _pending:
                    (done if pair[1].query() and pair[0].query() else rest).append(pair)
                _pending.clear()
                _pending.extend(rest)
        except Exception:  # noqa: BLE001 - telemetry must not fail the caller
            _pending.clear()
    for start, end, labels in done:
        try:
            ms = start.elapsed_time(end)
        except Exception:  # noqa: BLE001
            continue
        REGISTRY.observe(DEVICE_MS, ms, **labels)


def span_totals_ms() -> Dict[str, float]:
    """Total wall ms per span name over the spans recorded so far."""
    out: Dict[str, float] = {}
    for name, t0, t1, *_ in list(_spans):
        out[name] = out.get(name, 0.0) + (t1 - t0) * 1e-6
    return out


def span_names() -> List[str]:
    """Distinct span names recorded so far in this process."""
    with _spans_lock:
        return sorted({r[0] for r in _spans})


# --------------------------------------------------------------- metrics

# log-spaced histogram bucket bounds (ms), sqrt(2) apart from 1 µs to
# ~1.5 minutes: quantiles are exact to within one bucket ratio
_H_FACTOR = math.sqrt(2.0)
_H_BOUNDS: Tuple[float, ...] = tuple(1e-3 * _H_FACTOR ** i for i in range(54))


class Histogram:
    """Fixed log-bucket histogram: O(1) observe, O(buckets) quantile."""

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

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile, log-interpolated inside the landing
        bucket and clamped to the observed [min, max]."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum < rank:
                continue
            hi = _H_BOUNDS[i] if i < len(_H_BOUNDS) else self.vmax
            lo = _H_BOUNDS[i - 1] if i > 0 else min(self.vmin, hi)
            lo = max(lo, 1e-12)
            hi = max(hi, lo)
            est = lo * (hi / lo) ** ((rank - (cum - c)) / c)
            return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram in place (bucket-wise sum)."""
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _prom_labels(lk: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = []
    for k, v in lk:
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(k + '="' + escaped + '"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Process-wide counters, gauges and histograms keyed by (name,
    labels). Always counts in memory; files are written only by `flush()`,
    which the obs gate controls."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[Tuple, float]] = {}
        self._gauges: Dict[str, Dict[Tuple, float]] = {}
        self._hists: Dict[str, Dict[Tuple, Histogram]] = {}

    # ---- writes ------------------------------------------------------
    def inc(self, name: str, n: float = 1.0, **labels: Any) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[lk] = series.get(lk, 0.0) + n

    def set_counter(self, name: str, v: float, **labels: Any) -> None:
        """Direct counter assignment, for reset paths only."""
        with self._lock:
            self._counters.setdefault(name, {})[_label_key(labels)] = float(v)

    def set_gauge(self, name: str, v: float, **labels: Any) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = float(v)

    def observe(self, name: str, v: float, **labels: Any) -> None:
        lk = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            h = series.get(lk)
            if h is None:
                h = series[lk] = Histogram()
            h.observe(v)

    # ---- reads -------------------------------------------------------
    def get(self, name: str, **labels: Any) -> Optional[float]:
        lk = _label_key(labels)
        with self._lock:
            for store in (self._counters, self._gauges):
                if lk in store.get(name, {}):
                    return store[name][lk]
        return None

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

    def hist(self, name: str, **labels: Any) -> Optional[Histogram]:
        fold_device_times()
        with self._lock:
            return self._hists.get(name, {}).get(_label_key(labels))

    def hist_series(self, name: str) -> Dict[Tuple, Histogram]:
        """Every label set of one histogram, label key -> Histogram."""
        fold_device_times()
        with self._lock:
            return dict(self._hists.get(name, {}))

    def quantile(self, name: str, q: float, **labels: Any) -> Optional[float]:
        h = self.hist(name, **labels)
        return h.quantile(q) if h is not None else None

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # ---- exporters ---------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition: counters and gauges as single
        samples, histograms as cumulative ``_bucket{le=...}`` series plus
        ``_sum`` and ``_count``."""
        fold_device_times()
        lines: List[str] = []
        with self._lock:
            for kind, store in (("counter", self._counters), ("gauge", self._gauges)):
                for name in sorted(store):
                    lines.append(f"# TYPE {name} {kind}")
                    for lk in sorted(store[name]):
                        lines.append(f"{name}{_prom_labels(lk)} {_num(store[name][lk])}")
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for lk in sorted(self._hists[name]):
                    h = self._hists[name][lk]
                    cum = 0
                    for i, bound in enumerate(_H_BOUNDS):
                        cum += h.counts[i]
                        if cum == 0:
                            continue  # elide the empty low tail
                        le = 'le="{0:g}"'.format(bound)
                        lines.append(f"{name}_bucket{_prom_labels(lk, le)} {cum}")
                    inf = 'le="+Inf"'
                    lines.append(f"{name}_bucket{_prom_labels(lk, inf)} {h.count}")
                    lines.append(f"{name}_sum{_prom_labels(lk)} {_num(h.sum)}")
                    lines.append(f"{name}_count{_prom_labels(lk)} {h.count}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict[str, Any]:
        """JSON snapshot, the machine-readable twin of the Prometheus
        text (obs_cli ``summary`` aggregates these across workers)."""
        fold_device_times()
        out: Dict[str, Any] = {
            "schema": OBS_SCHEMA,
            "t_mono": time.monotonic(),
            "pid": os.getpid(),
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        with self._lock:
            for key, store in (("counters", self._counters), ("gauges", self._gauges)):
                for name, series in store.items():
                    out[key][name] = [
                        {"labels": dict(lk), "value": v} for lk, v in sorted(series.items())
                    ]
            for name, series in self._hists.items():
                out["histograms"][name] = [
                    {
                        "labels": dict(lk),
                        "count": h.count,
                        "sum": h.sum,
                        "min": None if h.count == 0 else h.vmin,
                        "max": None if h.count == 0 else h.vmax,
                        "p50": h.quantile(0.50),
                        "p95": h.quantile(0.95),
                        "p99": h.quantile(0.99),
                    }
                    for lk, h in sorted(series.items())
                ]
        return out


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


# ------------------------------------------------------------ scorecard


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
    """One (candidate, est_ms, measured_ms) scorecard pair. ``source`` is
    "probe" (estimate vs slope probe) or "observe" (estimate vs the live
    runtime feed)."""
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


def scorecard() -> Dict[str, Dict[str, Any]]:
    """Per-op-family estimate accuracy: pair count, mean/p95 absolute
    error (ms) and mean relative error, split by feed source."""
    out: Dict[str, Dict[str, Any]] = {}
    for lk, h in REGISTRY.hist_series("autosage_est_abs_err_ms").items():
        labels = dict(lk)
        key = f"{labels.get('family', '?')}/{labels.get('source', '?')}"
        rel = REGISTRY.hist("autosage_est_rel_err", **labels)
        out[key] = {
            "pairs": h.count,
            "mean_abs_err_ms": h.mean(),
            "p95_abs_err_ms": h.quantile(0.95),
            "mean_rel_err": rel.mean() if rel is not None else None,
        }
    return out


# -------------------------------------------------------------- serving

# metric names of the online serving tier (launch/serve.py):
#   autosage_serve_requests_total{tier,op}   requests by serving tier
#   autosage_serve_request_ms{bucket,tier}   decision latency per bucket
#   autosage_probe_stalls_total{tier}        requests that paid a probe
#                                            inline (must stay 0)
SERVE_REQUESTS = "autosage_serve_requests_total"
SERVE_REQUEST_MS = "autosage_serve_request_ms"
PROBE_STALLS = "autosage_probe_stalls_total"


def record_serve_request(bucket_sig: str, tier: str, ms: float, op: str = "?") -> None:
    """Account one served request: the tier counter and the per-bucket
    latency histogram."""
    REGISTRY.inc(SERVE_REQUESTS, tier=tier, op=op)
    REGISTRY.observe(SERVE_REQUEST_MS, ms, bucket=bucket_sig, tier=tier)


def record_probe_stall(tier: str) -> None:
    """A request paid a probe inline on the request path."""
    REGISTRY.inc(PROBE_STALLS, tier=tier)


def serve_latency_table() -> List[Dict[str, Any]]:
    """Per-bucket decision-latency percentiles, heaviest traffic first,
    with the tier mix each bucket served under (a bucket that upgraded
    mid-stream shows both "provisional" and "warm")."""
    by_bucket: Dict[str, Histogram] = {}
    tiers: Dict[str, Dict[str, int]] = {}
    for lk, h in REGISTRY.hist_series(SERVE_REQUEST_MS).items():
        labels = dict(lk)
        b = labels.get("bucket", "?")
        by_bucket.setdefault(b, Histogram()).merge(h)
        t = labels.get("tier", "?")
        tiers.setdefault(b, {})[t] = tiers.get(b, {}).get(t, 0) + h.count
    return [
        {
            "bucket": b,
            "requests": h.count,
            "p50_ms": h.quantile(0.50),
            "p95_ms": h.quantile(0.95),
            "p99_ms": h.quantile(0.99),
            "max_ms": None if h.count == 0 else h.vmax,
            "tiers": dict(sorted(tiers.get(b, {}).items())),
        }
        for b, h in sorted(by_bucket.items(), key=lambda kv: -kv[1].count)
    ]


# ------------------------------------------------------- file exporters


def _append_lines(path: Path, lines: List[str]) -> None:
    """Append each line as exactly one write() on an O_APPEND descriptor,
    so concurrent workers interleave whole records only."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(str(path), os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    try:
        for line in lines:
            os.write(fd, line.encode())
    finally:
        os.close(fd)


def _trace_events(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [
        {
            "name": r["name"],
            "cat": "autosage",
            "ph": "X",
            "ts": r["ts_us"],
            "dur": r["dur_us"],
            "pid": r["pid"],
            "tid": r["tid"],
            "args": r.get("args", {}),
        }
        for r in records
        if isinstance(r, dict) and r.get("ph") == "X"
    ]


def flush(directory: Optional[str] = None, force: bool = False) -> Dict[str, str]:
    """Write the flight recorder's state to disk:

      spans.jsonl        new spans, one per line, appended (shared by
                         fleet workers; whole-line atomic appends)
      trace_<pid>.json   this process's spans as Chrome trace JSON
      metrics_<pid>.prom Prometheus text snapshot of the registry
      metrics_<pid>.json the same snapshot, machine-readable

    A no-op (returns {}) unless obs is enabled or spans were recorded
    while it was; ``force`` overrides, for explicit CLI use. Returns the
    paths written."""
    global _spans_flushed
    with _spans_lock:
        recorded = bool(_spans) or _spans_flushed > 0
        base = _active_dir
    if not force and not (enabled() or recorded):
        return {}
    base = Path(directory) if directory else (base or obs_dir())
    pid = os.getpid()
    with _spans_lock:
        tail = _spans[_spans_flushed:]
        new = [_render(r) for r in tail]
        _spans_flushed += len(tail)
        all_spans = [_render(r) for r in _spans[:_spans_flushed]]
        dropped = _spans_dropped
    paths: Dict[str, str] = {}
    if new:
        _append_lines(base / "spans.jsonl",
                      [json.dumps(r, sort_keys=True) + "\n" for r in new])
    if all_spans or force:
        paths["spans"] = str(base / "spans.jsonl")
        trace = {
            "traceEvents": _trace_events(all_spans),
            "displayTimeUnit": "ms",
            "otherData": {"schema": OBS_SCHEMA, "dropped_spans": dropped},
        }
        tp = base / f"trace_{pid}.json"
        tp.parent.mkdir(parents=True, exist_ok=True)
        tp.write_text(json.dumps(trace))
        paths["trace"] = str(tp)
    base.mkdir(parents=True, exist_ok=True)
    (base / f"metrics_{pid}.prom").write_text(REGISTRY.prometheus_text())
    (base / f"metrics_{pid}.json").write_text(json.dumps(REGISTRY.to_dict()))
    paths["prom"] = str(base / f"metrics_{pid}.prom")
    paths["metrics"] = str(base / f"metrics_{pid}.json")
    return paths


def export_trace(out_path: str, directory: Optional[str] = None) -> Dict[str, Any]:
    """Merge spans.jsonl (every worker's appends) and this process's
    unflushed spans into one Chrome/Perfetto trace JSON at ``out_path``;
    returns the trace object."""
    base = Path(directory) if directory else (_active_dir or obs_dir())
    records: List[Dict[str, Any]] = []
    spans_file = base / "spans.jsonl"
    if spans_file.exists():
        for line in spans_file.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # torn tail from a crashed writer
    with _spans_lock:
        records.extend(_render(r) for r in _spans[_spans_flushed:])
    trace = {
        "traceEvents": _trace_events(records),
        "displayTimeUnit": "ms",
        "otherData": {"schema": OBS_SCHEMA},
    }
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace))
    return trace


def reset() -> None:
    """Clear the spans, the registry and the captured output dir."""
    global _spans_flushed, _spans_dropped, _active_dir
    with _spans_lock:
        _spans.clear()
        _spans_flushed = 0
        _spans_dropped = 0
        _active_dir = None
    with _pending_lock:
        _pending.clear()
    REGISTRY.reset()
    if getattr(_tls, "stack", None):
        _tls.stack = []


def summary_text() -> str:
    """Human-readable summary: headline counters, decide/probe/serve
    latency percentiles and the estimate scorecard."""
    lines = ["== autosage obs summary =="]
    for name, label in (
        ("autosage_decides_total", "decides"),
        ("autosage_probe_passes_total", "probe passes"),
        ("autosage_transfers_total", "transfers"),
        ("autosage_drift_events_total", "drift events"),
        ("autosage_transpose_total", "csr transposes"),
        (SERVE_REQUESTS, "serve requests"),
        (PROBE_STALLS, "probe stalls"),
    ):
        total = REGISTRY.total(name)
        if total:
            lines.append(f"  {label:14s} {int(total)}")
    for name in ("autosage_decide_ms", "autosage_probe_ms",
                 "autosage_cache_lock_wait_ms", SERVE_REQUEST_MS):
        series = REGISTRY.hist_series(name)
        if not series:
            continue
        agg = Histogram()
        for h in series.values():
            agg.merge(h)
        lines.append(
            f"  {name}: n={agg.count} p50={agg.quantile(0.5):.3f}ms "
            f"p95={agg.quantile(0.95):.3f}ms p99={agg.quantile(0.99):.3f}ms"
        )
    card = scorecard()
    if card:
        lines.append("  estimate scorecard (|est - measured| per op family):")
        for key in sorted(card):
            row = card[key]
            lines.append(
                f"    {key:18s} pairs={row['pairs']:<4d} "
                f"mean_abs_err={row['mean_abs_err_ms']:.3f}ms "
                f"mean_rel_err={row['mean_rel_err']:.2f}"
            )
    return "\n".join(lines)


def _atexit_flush() -> None:
    try:
        flush()
    except Exception:  # noqa: BLE001 - telemetry must not fail the exit
        pass


atexit.register(_atexit_flush)
