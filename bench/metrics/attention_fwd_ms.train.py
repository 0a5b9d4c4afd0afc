"""attention_fwd_ms.train: device milliseconds per step of the attention
forward's scheduled calls, whatever implements them: the window's share
of the port's autosage_device_ms{span="run"} histogram (core/obs.py,
CUDA events around each call) for op attention. Moves train_step_ms."""

OPS = ("attention",)


def read(r):
    d = [r.window.hist_delta("autosage_device_ms", span="run", op=op) for op in OPS]
    if not r.steps or not sum(x.count for x in d):
        return None
    return sum(x.sum for x in d) / r.steps
