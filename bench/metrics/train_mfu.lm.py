"""train_mfu.lm: model FLOPs of an LM training step (bench/work/lm.py:
projections, router, top-k experts, head, band and causal attention,
times 3; remat not counted) over the traced window's mean step time
times the card's published fp32 peak, in percent: the reading of
train_mfu over the LM cell's work model. Moves train_step_ms."""

from bench import harness

read = harness.load_by_path(harness.BENCH / "metrics" / "train_mfu.py").read
