"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, pattern
(rglru, rglru, local-attn) i.e. 1 attention per 2 recurrent blocks
[arXiv:2402.19427; hf].
"""
from repro_torch.configs.base import ArchConfig, HybridCfg

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=1e4,
    hybrid=HybridCfg(
        pattern=("rglru", "rglru", "attn"),
        lru_width=2560,
        local_window=2048,
        conv_width=4,
    ),
    source="arXiv:2402.19427; hf",
)
