"""moe_fwd_ms.lm: device milliseconds per step in the MoE FFNs' forward,
its activation-checkpointing recompute included: the window's share of
the port's autosage_device_ms histogram for span lm.moe
(models/transformer.py). Moves train_step_ms."""


def read(r):
    d = r.window.hist_delta("autosage_device_ms", span="lm.moe")
    return d.sum / r.steps if r.steps and d.count else None
