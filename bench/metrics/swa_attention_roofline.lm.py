"""swa_attention_roofline.lm: roofline share of the CSR-attention
pipeline's hand kernels (csrc/*.cu: attention, SDDMM, row softmax and the
SpMMs of its backward) over the sliding-window layers' scheduled calls
that ran on them (bench/roofline.py, the reading of
attention_roofline.train), each call's work counted on the causal band
(bench/traffic/lm_train.py `work_model`). Moves train_step_ms."""

from bench import harness

read = harness.load_by_path(harness.BENCH / "metrics" / "attention_roofline.train.py").read
