"""InternVL2-1B — VLM: InternViT frontend (STUB: precomputed patch embeds
via input_specs) + Qwen2-0.5B-class decoder backbone [arXiv:2404.16821; hf].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    vlm_patches=256,  # precomputed InternViT patch embeddings (stub)
    source="arXiv:2404.16821; hf",
)
