"""decide_idle_ms.train: milliseconds per step in which the card sat idle
while the port decided: the window's idle gaps (bench/trace.py) where
they overlap the union of the port's ``decide.*`` profiler ranges
(core/obs.py), on any thread. Moves train_step_ms."""

from bench import trace


def _union(intervals):
    """Sorted, disjoint union of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(r):
    t = r.window.trace
    if t is None or not r.steps:
        return None
    decides = _union((a, b) for name, a, b, _ in t.host if name.startswith("decide."))
    if not decides:
        return None
    idle_us, j = 0.0, 0
    for a, b in trace.idle_gaps(t):  # sorted and disjoint
        while j < len(decides) and decides[j][1] <= a:
            j += 1
        k = j
        while k < len(decides) and decides[k][0] < b:
            idle_us += min(b, decides[k][1]) - max(a, decides[k][0])
            k += 1
    return idle_us * 1e-3 / r.steps
