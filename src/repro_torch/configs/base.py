"""Architecture configs and the assigned shape suite.

A copy of repro/configs/base.py: the port keeps its own, field for
field equal (tests/test_torch_configs.py). Every architecture has a
module `src/repro_torch/configs/<id>.py` exporting CONFIG;
`get_config(name)` resolves them, and `reduced(cfg)` produces the CPU
smoke-test variant (same family, tiny dims).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "long_decode"),
}


# ---------------------------------------------------------------- archs
@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0  # expert FFN hidden
    d_ff_dense: int = 0  # dense FFN layers (e.g. deepseek layer 0)
    first_dense_layers: int = 0


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    # recurrentgemma: block pattern period; e.g. ("rglru","rglru","attn")
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    lru_width: int = 0  # 0 => d_model
    local_window: int = 2048
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int = 12
    enc_seq: int = 1500  # whisper: 30s audio -> 1500 frames (stub embeds)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    enc_dec: Optional[EncDecCfg] = None
    # VLM stub frontend: number of precomputed patch embeddings prepended
    vlm_patches: int = 0
    # attention impl for long-context decode cells (DESIGN.md §3):
    # sliding-window + sink CSR attention (the paper's pipeline)
    long_window: int = 4096
    long_sinks: int = 128
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = d * s.expand
            per_layer = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) + d_in * d
        else:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            if self.mla:
                m = self.mla
                q = d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim
                )
                o = self.n_heads * m.v_head_dim * d
            attn = q + kv + o
            if self.moe:
                mo = self.moe
                ffn_moe = (mo.n_experts + mo.n_shared) * 3 * d * mo.d_expert + d * mo.n_experts
                ffn_dense = 3 * d * mo.d_ff_dense
                n_moe = self.n_layers - mo.first_dense_layers
                per_layer = attn + (
                    n_moe * ffn_moe + mo.first_dense_layers * ffn_dense
                ) / self.n_layers
            else:
                per_layer = attn + 3 * d * self.d_ff
            if self.hybrid:
                # rglru layers replace attention with recurrence of similar size
                pass
        total = emb + self.n_layers * per_layer
        if self.enc_dec:
            total += self.enc_dec.n_enc_layers * (4 * d * d + 3 * d * self.d_ff)
            total += self.n_layers * 4 * d * d  # cross-attention
        return int(total)

    def active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k+shared only."""
        if not self.moe:
            return self.n_params()
        mo = self.moe
        d = self.d_model
        full = self.n_params()
        all_exp = (mo.n_experts + mo.n_shared) * 3 * d * mo.d_expert
        act_exp = (mo.top_k + mo.n_shared) * 3 * d * mo.d_expert
        n_moe = self.n_layers - mo.first_dense_layers
        return int(full - n_moe * (all_exp - act_exp))


ARCH_IDS = [
    "internlm2_20b",
    "qwen2_5_32b",
    "qwen1_5_110b",
    "qwen3_14b",
    "internvl2_1b",
    "recurrentgemma_2b",
    "deepseek_v2_lite_16b",
    "qwen3_moe_235b_a22b",
    "whisper_small",
    "mamba2_2_7b",
    "gnn_sage",  # the paper's own workload
]


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: Dict = dict(
        name=cfg.name + "_reduced",
        family=cfg.family,
        n_layers=2 if not cfg.hybrid else 3,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab=256,
        head_dim=16,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        tie_embeddings=cfg.tie_embeddings,
        long_window=64,
        long_sinks=8,
    )
    if cfg.moe:
        kw["moe"] = MoECfg(
            n_experts=8, top_k=2, n_shared=min(cfg.moe.n_shared, 1),
            d_expert=32, d_ff_dense=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        kw["mla"] = MLACfg(kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = SSMCfg(d_state=16, expand=2, head_dim=16, chunk=32)
        kw["n_heads"] = 0
        kw["n_kv_heads"] = 0
        kw["head_dim"] = 0
    if cfg.hybrid:
        kw["hybrid"] = HybridCfg(pattern=cfg.hybrid.pattern, lru_width=0,
                                 local_window=32, conv_width=4)
    if cfg.enc_dec:
        kw["enc_dec"] = EncDecCfg(n_enc_layers=2, enc_seq=64)
    if cfg.vlm_patches:
        kw["vlm_patches"] = 16
    return ArchConfig(**kw)
