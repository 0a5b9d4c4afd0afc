"""softmax_bwd_ms.train: device milliseconds per step of the attention
backward's row softmax, its recompute and its VJP (core/autodiff.py):
the window's share of the port's autosage_device_ms histogram
(core/obs.py) for spans softmax.recompute and softmax.vjp. Moves
train_step_ms."""

SPANS = ("softmax.recompute", "softmax.vjp")


def read(r):
    d = [r.window.hist_delta("autosage_device_ms", span=s) for s in SPANS]
    if not r.steps or not sum(x.count for x in d):
        return None
    return sum(x.sum for x in d) / r.steps
