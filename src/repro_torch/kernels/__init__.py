"""SpMM kernels: hand-written CUDA (spmm.py + ../csrc), their plain-torch
versions, the torch oracles (ref.py) and the library-op baselines."""
