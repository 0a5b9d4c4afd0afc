"""Qwen3-235B-A22B — MoE: 128 experts, top-8, no shared experts
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoECfg(
        n_experts=128,
        top_k=8,
        n_shared=0,
        d_expert=1536,
        d_ff_dense=0,
        first_dense_layers=0,
    ),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
