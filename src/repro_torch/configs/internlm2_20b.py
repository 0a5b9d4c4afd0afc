"""InternLM2-20B — dense GQA decoder [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    head_dim=128,
    rope_theta=1e6,
    source="arXiv:2403.17297; hf",
)
