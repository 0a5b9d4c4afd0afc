"""Train, eval and serve step factories (port of repro/train/step.py).

The JAX package's train step is functional and jitted with the state
donated; here it takes one step in eager mode and updates the state in
place (the weights and AdamW's moments; ``step`` and ``count`` are new
tensors), then returns it: callers that need the state before a step
clone it first. Metrics stay tensors on the device, so a step does not
wait for the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update, init_opt_state
from repro_torch.train.loss import cross_entropy


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: nn.Module
    opt: OptState


def init_train_state(cfg: ArchConfig, key=0, dtype=torch.bfloat16, device=None) -> TrainState:
    """A fresh state: weights drawn from ``key`` (a seed or a generator)
    in ``dtype`` (bf16 by default, as in JAX), zero fp32 moments, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    params = api.init_model(cfg, key, dtype, dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                      opt=init_opt_state(params))


def _labels(batch: Dict, dev: torch.device) -> torch.Tensor:
    lab = batch["labels"]
    lab = torch.from_numpy(np.asarray(lab)) if not isinstance(lab, torch.Tensor) else lab
    return lab.to(dev, torch.long)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, device=None):
    dev = resolve_device(device)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = dict(state.params.named_parameters())
        logits = api.forward(state.params, batch, cfg, device=dev)
        loss, aux = cross_entropy(logits, _labels(batch, dev))
        # a weight the forward never reads (a recurrent block's ln2) has a
        # zero gradient, as in JAX
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        _, new_opt, opt_aux = adamw_update(opt_cfg, grads, params, state.opt)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   **opt_aux}
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, device=None):
    dev = resolve_device(device)

    def eval_step(model: nn.Module, batch: Dict) -> Dict:
        with torch.no_grad():
            logits = api.forward(model, batch, cfg, device=dev)
            loss, aux = cross_entropy(logits, _labels(batch, dev), z_loss=0.0)
        return {"loss": loss, **aux}

    return eval_step


def make_prefill_step(cfg: ArchConfig, device=None):
    def prefill_step(model, batch, cache):
        return api.prefill(model, batch, cfg, cache, device=device)

    return prefill_step


def make_decode_step(cfg: ArchConfig, long_ctx: bool = False, device=None):
    def decode_step(model, tokens, cache):
        return api.decode_step(model, tokens, cfg, cache, long_ctx=long_ctx, device=device)

    return decode_step
