"""DeepSeek-V2-Lite (16B) — MLA attention (kv_lora=512) + MoE
(64 routed experts top-6, 2 shared), first layer dense
[arXiv:2405.04434; hf].

Assigned spec: 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
"MoE 64e top-6". (The assignment note "2 shared+160 routed" mixes in the
full V2's 160 routed experts; we follow the primary 64e top-6 spec with
2 shared, matching the released V2-Lite.) Dense first-layer FFN width is
10944 per the released checkpoint.
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    rope_theta=1e4,
    mla=MLACfg(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoECfg(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_expert=1408,
        d_ff_dense=10944,
        first_dense_layers=1,
    ),
    source="arXiv:2405.04434; hf",
)
