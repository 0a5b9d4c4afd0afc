"""Family dispatch: one entry point per model operation, covering every
architecture of `repro_torch.configs` (port of repro/models/api.py).

Each entry point runs on ``device``, the card unless the caller asks for
the CPU (``device="cpu"``): the model must already live there, and
numpy inputs (tokens, patch embeddings, frames) are moved there. There
is no fallback from the card to the CPU. `prefill` and `decode_step`
write the cache in place and return it with its positions advanced.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.modules import Key


def _is_audio(cfg: ArchConfig) -> bool:
    return cfg.family == "audio"


def _on(model, device) -> torch.device:
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have != dev:
        raise ValueError(f"the model lives on {have}, not on {dev}; move it or pass device=")
    return dev


def _inputs(batch, dev: torch.device):
    """Tokens and embeddings on ``dev`` (token ids as int64)."""
    def one(v):
        t = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else torch.as_tensor(v)
        return t.to(dev) if t.is_floating_point() else t.to(dev, torch.long)
    return {k: one(v) for k, v in batch.items()} if isinstance(batch, dict) else one(batch)


def init_model(cfg: ArchConfig, key: Key = 0, dtype=torch.float32, device=None):
    """The model's weights drawn from a torch.Generator (``key``: a seed
    or a generator) on ``device``."""
    if _is_audio(cfg):
        return encdec.init_encdec(cfg, key, dtype, device)
    return transformer.init_lm(cfg, key, dtype, device)


def forward(model, batch: Dict, cfg: ArchConfig, device=None) -> torch.Tensor:
    """Teacher-forcing logits (B, S, V), fp32."""
    batch = _inputs(batch, _on(model, device))
    if _is_audio(cfg):
        return encdec.encdec_forward(model, batch, cfg)
    return transformer.lm_forward(model, batch, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> Dict:
    dev = resolve_device(device)
    if _is_audio(cfg):
        return encdec.init_encdec_cache(cfg, batch, max_len, dtype, dev)
    return transformer.init_lm_cache(cfg, batch, max_len, dtype, dev)


def prefill(model, batch: Dict, cfg: ArchConfig, cache: Dict, device=None):
    """The prompt through the model, filling ``cache``: (last position's
    logits (B, 1, V), cache)."""
    batch = _inputs(batch, _on(model, device))
    with torch.no_grad():
        if _is_audio(cfg):
            return encdec.encdec_prefill(model, batch, cfg, cache)
        return transformer.lm_prefill(model, batch, cfg, cache)


def decode_step(model, tokens, cfg: ArchConfig, cache: Dict, long_ctx: bool = False,
                device=None):
    """One token per row (B, 1): (logits (B, 1, V), cache). ``long_ctx``
    routes GQA layers through the CSR window + sink attention."""
    tokens = _inputs(tokens, _on(model, device))
    with torch.no_grad():
        if _is_audio(cfg):
            return encdec.encdec_decode_step(model, tokens, cfg, cache)
        return transformer.lm_decode_step(model, tokens, cfg, cache, long_ctx)


# ------------------------------------------------------------ carry-over
def params_from_jax(cfg: ArchConfig, params_np: Dict, device=None):
    """The port's model holding `repro.models.api.init_model`'s weights
    (numpy arrays), on ``device``."""
    dev = resolve_device(device)
    if _is_audio(cfg):
        return encdec.encdec_params_from_jax(cfg, params_np, dev)
    return transformer.lm_params_from_jax(cfg, params_np, dev)


def cache_from_jax(cfg: ArchConfig, cache_np: Dict, device=None) -> Dict:
    """The port's cache from a JAX cache (numpy arrays), e.g. to decode
    in the port after a prefill in the JAX package."""
    dev = resolve_device(device)
    if _is_audio(cfg):
        return encdec.encdec_cache_from_jax(cache_np, dev)
    return transformer.lm_cache_from_jax(cfg, cache_np, dev)


def cache_to_numpy(cfg: ArchConfig, cache: Dict) -> Dict:
    """A port cache in the JAX package's layout, as numpy arrays."""
    if _is_audio(cfg):
        return encdec.encdec_cache_to_numpy(cache)
    return transformer.lm_cache_to_numpy(cfg, cache)
