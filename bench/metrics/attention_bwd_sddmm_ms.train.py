"""attention_bwd_sddmm_ms.train: device milliseconds per step of the
attention backward's SDDMMs (the logits recompute and the gradient of
the probs), whatever implements them: the window's share of the port's
autosage_device_ms{span="run"} histogram (core/obs.py) for ops
attention_bwd_e and attention_bwd_p. Moves train_step_ms."""

OPS = ("attention_bwd_e", "attention_bwd_p")


def read(r):
    d = [r.window.hist_delta("autosage_device_ms", span="run", op=op) for op in OPS]
    if not r.steps or not sum(x.count for x in d):
        return None
    return sum(x.sum for x in d) / r.steps
