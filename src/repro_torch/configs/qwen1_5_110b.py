"""Qwen1.5-110B — dense GQA with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
