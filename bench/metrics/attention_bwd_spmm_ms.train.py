"""attention_bwd_spmm_ms.train: device milliseconds per step of the
attention backward's runtime-valued SpMMs (the q, k and v gradients),
whatever implements them: the window's share of the port's
autosage_device_ms{span="run"} histogram (core/obs.py) for ops
attention_bwd_q, _k and _v. Moves train_step_ms."""

OPS = ("attention_bwd_q", "attention_bwd_k", "attention_bwd_v")


def read(r):
    d = [r.window.hist_delta("autosage_device_ms", span="run", op=op) for op in OPS]
    if not r.steps or not sum(x.count for x in d):
        return None
    return sum(x.sum for x in d) / r.steps
