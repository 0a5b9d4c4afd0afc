"""Kernels: hand-written CUDA for SpMM, SDDMM, fused attention and the
block-ELL row softmax (spmm.py, sddmm.py, attention.py, softmax.py +
../csrc), their plain-torch versions, the torch oracles (ref.py), the
library-op baselines, and the deprecated kernel-level entry points
(ops.py)."""
from repro_torch.kernels import ops, softmax

__all__ = ["ops", "softmax"]
