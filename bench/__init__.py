"""Benchmark of repro_torch, the PyTorch/CUDA port of AutoSAGE.

Run one cell of BENCHMARK.json from the root of a checkout:

    python3 bench/run.py --workload gat-products.train --seed 7 --seconds 51 --trace 0

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (whose ``family`` names ``models/<family>.py`` and
whose ``graph_generator`` names ``gen/<graph_generator>.py``), its traffic
mix in ``traffic/<traffic>.json`` (whose ``generator`` names
``traffic/<generator>.py``), its correctness limits in
``workloads/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. Nothing here imports jax or the JAX package;
nothing under ``reference/`` imports repro_torch.
"""
