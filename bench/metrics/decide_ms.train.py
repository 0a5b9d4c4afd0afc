"""decide_ms.train: host milliseconds per step in the scheduler's
decisions (core/scheduler.py, core/pipeline.py), the window's share of
the port's autosage_decide_ms histogram. Moves train_step_ms."""


def read(r):
    d = r.window.hist_delta("autosage_decide_ms", scheduler="exact")
    return d.sum / r.steps if r.steps and d.count else None
