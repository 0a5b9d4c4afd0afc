"""Synthetic token batches and the host prefetcher (port of repro/data)."""
