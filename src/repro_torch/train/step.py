"""Serve step factories (port of the serving half of repro/train/step.py):
the functions `demo-lm` calls for prefill and decode. The train step,
`TrainState` and the eval step belong to the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api


def make_prefill_step(cfg: ArchConfig, device=None):
    def prefill_step(model, batch, cache):
        return api.prefill(model, batch, cfg, cache, device=device)

    return prefill_step


def make_decode_step(cfg: ArchConfig, long_ctx: bool = False, device=None):
    def decode_step(model, tokens, cache):
        return api.decode_step(model, tokens, cfg, cache, long_ctx=long_ctx, device=device)

    return decode_step
