"""Fault-tolerant train-state checkpoints (port of repro/checkpoint)."""
