"""The ``mellum2`` family: a Mellum2-style decoder in the port (its
`LM` under the config's layer plan, `train.step.make_train_step`) and
the inputs both sides share: the weights and the token batches, drawn
from the run's seed on the device.

Weights are drawn leaf by leaf, in `weight_shapes` order, from one
generator seeded with the run's seed: embedding std 0.02, every other
matrix std 1/sqrt(fan_in), norm weights 0 (the port stores RMSNorm's
weight as an offset from 1). `iter_weights` draws them again in the
same order, one leaf at a time, so a caller can compare with the
initial weights without keeping a copy. Token batches come from a
second generator (seed + 2**62): uniform ids, one packed sequence of
``seq_len`` + 1 tokens a step, inputs and next-token labels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Tuple

import torch

from bench.gen import graphs
from bench.work import lm as work

TOKEN_SEED_OFFSET = 1 << 62


def _matches(cfg, config: Dict[str, Any]) -> bool:
    from repro_torch.configs.layers import layer_plan

    plan = layer_plan(cfg)
    kinds = ["sliding_attention" if a.window is not None else "full_attention" for a in plan]
    mine = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab, cfg.norm_eps,
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert, cfg.moe.n_shared,
            cfg.tie_embeddings, kinds, plan[0].window)
    theirs = (config["hidden_size"], config["num_attention_heads"],
              config["num_key_value_heads"], config["head_dim"], config["vocab_size"],
              config["rms_norm_eps"], config["num_experts"], config["num_experts_per_tok"],
              config["moe_intermediate_size"], 0, config["tie_word_embeddings"],
              work.layer_kinds(config), config["sliding_window"])
    return mine == theirs


def program_config(config: Dict[str, Any]):
    """The port's `ArchConfig` of the configuration: Mellum2's (or, at the
    CPU tests' widths, its reduced twin's) at the configuration's layer
    count; its layer plan repeats by name. A configuration the port's
    Mellum2 does not match is refused."""
    from repro_torch.configs import mellum2

    for base in (mellum2.CONFIG, mellum2.REDUCED):
        cfg = dataclasses.replace(base, n_layers=config["num_hidden_layers"])
        if _matches(cfg, config):
            return cfg
    raise ValueError("the configuration matches neither the port's Mellum2 config nor its "
                     "reduced twin")


def weight_shapes(config: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight, in the port's parameter order."""
    d, v, dh = config["hidden_size"], config["vocab_size"], config["head_dim"]
    h, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    e, fe = config["num_experts"], config["moe_intermediate_size"]
    out: List[Tuple[str, Tuple[int, ...]]] = [("embed", (v, d)), ("final_norm", (d,)),
                                               ("unembed", (d, v))]
    for i in range(config["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1", (d,)), (p + "ln2", (d,)),
                (p + "attn.wq", (d, h * dh)), (p + "attn.wk", (d, hkv * dh)),
                (p + "attn.wv", (d, hkv * dh)), (p + "attn.wo", (h * dh, d)),
                (p + "ffn.router", (d, e)), (p + "ffn.w_gate", (e, d, fe)),
                (p + "ffn.w_up", (e, d, fe)), (p + "ffn.w_down", (e, fe, d))]
    return out


def _std(name: str, shape: Tuple[int, ...]) -> float:
    return 0.02 if name == "embed" else shape[-2] ** -0.5


def iter_weights(config: Dict[str, Any], seed: int, device: torch.device
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, initial weight) of every weight, drawn one at a time."""
    gen = graphs.device_generator(seed, device)
    for name, shape in weight_shapes(config):
        if len(shape) == 1:
            yield name, torch.zeros(shape, device=device)
        else:
            yield name, torch.randn(shape, generator=gen, device=device) * _std(name, shape)


def weights(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return dict(iter_weights(config, seed, device))


def token_generator(seed: int, device: torch.device) -> torch.Generator:
    return graphs.device_generator(seed + TOKEN_SEED_OFFSET, device)


def next_batch(config: Dict[str, Any], mix: Dict[str, Any], gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """tokens and labels (batch, seq_len): one draw of seq_len + 1 ids a row."""
    ids = torch.randint(0, config["vocab_size"], (int(mix["batch"]), int(mix["seq_len"]) + 1),
                        generator=gen, device=gen.device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def step_flops(config: Dict[str, Any], mix: Dict[str, Any]) -> float:
    return work.step_flops(config, int(mix["seq_len"]), int(mix["batch"]))
