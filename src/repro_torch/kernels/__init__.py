"""Kernels: hand-written CUDA for SpMM, SDDMM and fused attention
(spmm.py, sddmm.py, attention.py + ../csrc), their plain-torch versions,
the torch oracles (ref.py) and the library-op baselines."""
