"""Meta-tensor stand-ins for every model input and state (the port's twin
of repro/launch/specs.py): the right shapes and dtypes on the meta
device, so nothing is allocated. The dry run costs the step factories
against these.

dtypes follow JAX's: bf16 weights, caches and patch / frame embeddings,
fp32 AdamW moments. Token ids are int64 where JAX's are int32, because
the port's entry points take them as long (`models.api._inputs`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import api
from repro_torch.train.step import TrainState, init_train_state

META = torch.device("meta")
TOKEN_DTYPE = torch.long


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _inputs(cfg: ArchConfig, b: int, s: int) -> Dict[str, torch.Tensor]:
    out = {"tokens": _empty((b, s), TOKEN_DTYPE)}
    if cfg.family == "vlm":
        p = cfg.vlm_patches
        out["tokens"] = _empty((b, s - p), TOKEN_DTYPE)
        out["patch_embeds"] = _empty((b, p, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = _empty((b, cfg.enc_dec.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def train_batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {**_inputs(cfg, b, s), "labels": _empty((b, s), TOKEN_DTYPE)}


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, torch.Tensor]:
    return _inputs(cfg, shape.global_batch, shape.seq_len)


def state_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> TrainState:
    return init_train_state(cfg, 0, dtype, device=META)


def params_specs(cfg: ArchConfig, dtype=torch.bfloat16):
    return api.init_model(cfg, 0, dtype, device=META)


def cache_specs_abstract(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    return api.init_cache(cfg, batch, max_len, dtype, device=META)


def decode_token_specs(batch: int) -> torch.Tensor:
    return _empty((batch, 1), TOKEN_DTYPE)
