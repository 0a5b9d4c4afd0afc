"""Mellum2-12B-A2.5B (JetBrains) — MoE in every layer: 64 experts of
width 896, top-8 with renormalised gates, no shared expert; GQA 32 query
heads of 128 over 4 KV heads; layers in periods of three sliding-window
layers (window 1,024, default rope) and one full layer (YaRN rope)
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct config.json].

A port-only config: it is not in `ARCH_IDS` (the JAX package has no
twin), and its per-layer attention lives in `PATTERNS`, read through
`configs.layers.layer_plan`. Fewer layers (``dataclasses.replace(CONFIG,
n_layers=4)``) keep the plan: it repeats by name. `REDUCED` is the tiny
same-family config of the CPU tests.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.configs.layers import FULL, WINDOW, LayerPattern, Rope

CONFIG = ArchConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    n_layers=28,
    d_model=2304,
    n_heads=32,
    n_kv_heads=4,
    d_ff=7168,
    vocab=98304,
    head_dim=128,
    qkv_bias=False,
    qk_norm=False,
    rope_theta=5e5,
    norm_eps=1e-6,
    tie_embeddings=False,
    moe=MoECfg(n_experts=64, top_k=8, n_shared=0, d_expert=896, d_ff_dense=0,
               first_dense_layers=0),
    source="hf:JetBrains/Mellum2-12B-A2.5B-Instruct",
)

WINDOW_ROPE = Rope(theta=5e5)
FULL_ROPE = Rope(theta=5e5, kind="yarn", factor=16.0, original_max_positions=8192,
                 beta_fast=32.0, beta_slow=1.0, attention_factor=1.2772588722239782)
PERIOD = (WINDOW, WINDOW, WINDOW, FULL)

REDUCED = dataclasses.replace(
    CONFIG, name=CONFIG.name + "_reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    moe=MoECfg(n_experts=8, top_k=2, n_shared=0, d_expert=32, d_ff_dense=0,
               first_dense_layers=0),
)

PATTERNS = {
    CONFIG.name: LayerPattern(PERIOD, 1024, WINDOW_ROPE, FULL_ROPE),
    REDUCED.name: LayerPattern(PERIOD, 8, WINDOW_ROPE, FULL_ROPE),
}
