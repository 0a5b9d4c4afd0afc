"""The device timeline of a traced window, read from torch.profiler's
Chrome trace, and the arithmetic the per-layer readers share.

Times are microseconds in the profiler's one clock, in which kineto
places the host's operations and the card's kernels side by side. The
window is the ``bench.window`` annotation the harness puts around the
measured loop.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation"})
WINDOW = "bench.window"

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """Device operations (name, start, end) and host operations (name,
    start, end, thread) of one traced window [t0, t1]."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float, int]]
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6


def load_chrome_trace(path: Path) -> Trace:
    """Parse an exported profiler trace; the window is the (first)
    ``bench.window`` annotation, else the span of all events."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host = [], []
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, t0 = e.get("cat"), float(e["ts"])
        t1 = t0 + float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((e.get("name", "?"), t0, t1))
        elif cat in HOST_CATS:
            if e.get("name") == WINDOW and window is None:
                window = (t0, t1)
            host.append((e.get("name", "?"), t0, t1, e.get("tid")))
    if window is None:
        stamps = [t for _, a, b in device for t in (a, b)] or [0.0]
        window = (min(stamps), max(stamps))
    return Trace(device, host, window[0], window[1])


def union_us(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which any operation ran on the card."""
    return union_us(((a, b) for _, a, b in trace.device), trace.t0, trace.t1) * 1e-6


def idle_gaps(trace: Trace) -> List[Interval]:
    """The window's stretches with no device operation running."""
    gaps, end = [], trace.t0
    for _, a, b in sorted(trace.device, key=lambda e: e[1]):
        if a > end and a > trace.t0:
            gaps.append((end, min(a, trace.t1)))
        end = max(end, b)
        if end >= trace.t1:
            break
    if end < trace.t1:
        gaps.append((end, trace.t1))
    return [(a, b) for a, b in gaps if b > a]


def _innermost(events: List[Tuple[float, float, str]], points: Sequence[float]
               ) -> List[Optional[Tuple[float, float, str]]]:
    """For each time in ``points``, the innermost of one thread's nested
    ``events`` (start, end, name) running then, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out: List[Optional[Tuple[float, float, str]]] = [None] * len(points)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in sorted(range(len(points)), key=lambda i: points[i]):
        p = points[i]
        while j < len(events) and events[j][0] <= p:
            while stack and stack[-1][1] < events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def host_labels(trace: Trace, points: Sequence[float]) -> List[str]:
    """For each time in ``points``, the shortest host operation running
    then on any thread (the backward runs on autograd's own thread), or
    "host" where none was: host work outside every traced operation."""
    by_thread: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    for name, a, b, tid in trace.host:
        if name != WINDOW:
            by_thread[tid].append((a, b, name))
    best: List[Optional[Tuple[float, float, str]]] = [None] * len(points)
    for events in by_thread.values():
        for i, e in enumerate(_innermost(events, points)):
            if e is not None and (best[i] is None or e[1] - e[0] < best[i][1] - best[i][0]):
                best[i] = e
    return [e[2] if e is not None else "host" for e in best]


def top(pairs: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> Dict[str, List[List]]:
    """The ten device operations with the most time, and idle time by
    what the host was doing during it, in seconds."""
    ops: Dict[str, float] = defaultdict(float)
    for name, a, b in trace.device:
        a, b = max(a, trace.t0), min(b, trace.t1)
        if b > a:
            ops[name] += (b - a) * 1e-6
    gaps = idle_gaps(trace)
    labels = host_labels(trace, [(a + b) / 2 for a, b in gaps])
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, labels):
        idle[label] += (b - a) * 1e-6
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def matching_seconds(trace: Trace, substrings: Sequence[str]) -> float:
    """Summed device seconds, inside the window, of the operations whose
    name contains one of ``substrings``."""
    total = 0.0
    for name, a, b in trace.device:
        if any(s in name for s in substrings):
            a, b = max(a, trace.t0), min(b, trace.t1)
            if b > a:
                total += (b - a) * 1e-6
    return total
