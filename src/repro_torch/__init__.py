"""AutoSAGE on PyTorch and CUDA: the port of the `repro` package (JAX on a
TPU) to one NVIDIA H100.

It mirrors `repro`'s layout (`sparse/`, `kernels/`, `core/`, `models/`,
`api.py`), imports torch and numpy and never `jax` or `repro`. Entry
points run on the card unless the caller passes ``device="cpu"``:

    from repro_torch import api
    c = api.spmm(csr, b, sage=sage, differentiable=False)
"""
