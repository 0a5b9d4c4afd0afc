"""Plain PyTorch references that decide ``correct``. Nothing here
imports jax, the JAX package or repro_torch."""
