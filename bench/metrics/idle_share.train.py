"""idle_share.train: percent of the traced window in which no operation
ran on the card, from the profiler's device timeline. Moves train_step_ms."""

from bench import trace


def read(r):
    t = r.window.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(t) / t.window_s)
