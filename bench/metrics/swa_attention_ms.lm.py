"""swa_attention_ms.lm: device milliseconds per step of the sliding-window
layers' attention: the window's share of the port's autosage_device_ms
histogram (core/obs.py, CUDA events around each call) for the scheduled
CSR-attention ops (span run, ops attention and attention_bwd_*; in the
LM cell only the window layers schedule them), forward, remat recompute
and backward, and the backward's row-softmax spans (softmax.recompute,
softmax.vjp). Moves train_step_ms."""

OPS = ("attention", "attention_bwd_e", "attention_bwd_p", "attention_bwd_q",
       "attention_bwd_k", "attention_bwd_v")
SPANS = ("softmax.recompute", "softmax.vjp")


def read(r):
    runs = [r.window.hist_delta("autosage_device_ms", span="run", op=op) for op in OPS]
    soft = [r.window.hist_delta("autosage_device_ms", span=s) for s in SPANS]
    if not r.steps or not sum(x.count for x in runs):
        return None
    return sum(x.sum for x in runs + soft) / r.steps
