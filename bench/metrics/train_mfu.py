"""train_mfu: model FLOPs of a full-graph step (bench/work) over the
traced window's mean step time times the card's published fp32 peak, in
percent. Moves train_step_ms."""


def read(r):
    if r.peaks is None or not r.steps:
        return None
    step_s = r.window.seconds / r.steps
    return 100.0 * r.work["step_flops"] / (step_s * r.peaks[r.work["flops_peak"]])
