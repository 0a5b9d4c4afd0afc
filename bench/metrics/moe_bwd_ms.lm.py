"""moe_bwd_ms.lm: device milliseconds per step in the backward of the MoE
FFNs' grouped expert products: the window's share of the port's
autosage_device_ms histogram for span lm.moe_bwd (models/moe.py
_GroupedProduct.backward). None on a program without that span. Moves
train_step_ms."""


def read(r):
    d = r.window.hist_delta("autosage_device_ms", span="lm.moe_bwd")
    return d.sum / r.steps if r.steps and d.count else None
