"""idle_share.lm: percent of the traced window of an LM cell in which no
operation ran on the card, from the profiler's device timeline; the
reading of idle_share.train, reported for the LM cells. Moves
train_step_ms."""

from bench import harness

read = harness.load_by_path(harness.BENCH / "metrics" / "idle_share.train.py").read
