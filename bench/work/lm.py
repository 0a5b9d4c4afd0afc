"""Operations of the LM cells, counted from shapes.

Model FLOPs of one training step of a Mellum2-style decoder (GQA, a MoE
FFN in every layer, sliding-window and full causal layers): the
forward's products times 3 (the backward takes two products per
forward product); the recompute of activation checkpointing is not
model work and is not counted. Per token and layer: the q, k, v and o
projections, the router, the top-k experts' three products; the head's
unembedding once. Attention: q·k and P·V over the band's entries on a
window layer, over the causal triangle on a full layer (4·entries·d a
head). The few operations per element of norms, softmax, rope and the
loss are left out.
"""
from __future__ import annotations

from typing import Any, Dict, List


def band_nnz(seq_len: int, window: int) -> int:
    """Entries of one sequence's causal band: row t holds min(t + 1,
    window) columns."""
    w = min(window, seq_len)
    return w * (w + 1) // 2 + (seq_len - w) * window


def layer_kinds(config: Dict[str, Any]) -> List[str]:
    """The first ``num_hidden_layers`` of the config's ``layer_types``."""
    return config["layer_types"][:config["num_hidden_layers"]]


def dense_step_flops(config: Dict[str, Any], tokens: int) -> float:
    """The products of every matrix of weights (projections, router,
    experts, unembedding), forward and backward, for ``tokens`` tokens."""
    d, dh = config["hidden_size"], config["head_dim"]
    h, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    e, k, fe = config["num_experts"], config["num_experts_per_tok"], config["moe_intermediate_size"]
    per_layer = 2.0 * d * (2 * h * dh + 2 * hkv * dh) + 2.0 * d * e + k * 3 * 2.0 * d * fe
    fwd = tokens * (config["num_hidden_layers"] * per_layer + 2.0 * d * config["vocab_size"])
    return 3 * fwd


def attention_step_flops(config: Dict[str, Any], seq_len: int, batch: int) -> float:
    """q·k and P·V over each layer's pattern, forward and backward."""
    dh, h = config["head_dim"], config["num_attention_heads"]
    entries = 0
    for kind in layer_kinds(config):
        if kind == "sliding_attention":
            entries += band_nnz(seq_len, config["sliding_window"])
        else:
            entries += seq_len * (seq_len + 1) // 2
    return 3 * 4.0 * entries * dh * h * batch


def step_flops(config: Dict[str, Any], seq_len: int, batch: int) -> float:
    return dense_step_flops(config, seq_len * batch) + attention_step_flops(config, seq_len, batch)
