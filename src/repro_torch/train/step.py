"""Train, eval and serve step factories (port of repro/train/step.py).

The JAX package's train step is functional and jitted with the state
donated; here it takes one step in eager mode and updates the state in
place (the weights and AdamW's moments; ``step`` and ``count`` are new
tensors), then returns it: callers that need the state before a step
clone it first. Metrics stay tensors on the device, so a step does not
wait for the host.

On a mesh (``mesh=``, a process mesh of `launch.mesh`) the steps give
the values of the global batch, which JAX gets from GSPMD, by explicit
data parallelism: each rank takes the batch rows `batch_axes_for` gives
it (all rows where the batch does not divide, as JAX replicates it);
the loss and its parts are summed over the batch axes before dividing
by the global ``max(mask.sum(), 1)``. The state is kept as
`shard_state` leaves it: expert tensors sliced for expert parallelism
(`sharding.storage_specs`), everything else whole on every rank (JAX
keeps dense weights sharded by `param_specs`). Gradients of whole
weights are summed over the batch axes; an expert slice's gradient
already holds every token's share (the all-to-all's backward), is
summed over the batch axes it is replicated on, and is divided by the
'data' size where the rows are replicated over 'data'. The clip reads
the global norm: whole weights once, expert slices summed over their
axes. AdamW updates each rank's own slices.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    Spec,
    batch_axes_for,
    entry_axes,
    local_block,
    localize,
    mesh_shape,
    sharded_names,
    storage_specs,
)
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update, init_opt_state
from repro_torch.train.loss import cross_entropy, cross_entropy_sums


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


def shard_state(state: TrainState, cfg: ArchConfig, mesh,
                specs: Optional[Mapping[str, Spec]] = None) -> TrainState:
    """``state`` (whole on this rank) in the layout ``specs`` gives on
    ``mesh`` (default: `storage_specs`, the layout the steps keep): each
    tensor it shards, the weight and its moments, replaced by this
    rank's block, in place."""
    specs = storage_specs(state.params, cfg, mesh) if specs is None else specs
    localize(state.params, specs, mesh)
    for moments in (state.opt.m, state.opt.v):
        for name in sharded_names(specs):
            moments[name] = local_block(moments[name], specs[name], mesh).clone()
    return state


def _labels(batch: Dict, dev: torch.device) -> torch.Tensor:
    lab = batch["labels"]
    lab = torch.from_numpy(np.asarray(lab)) if not isinstance(lab, torch.Tensor) else lab
    return lab.to(dev, torch.long)


def _local_batch(batch: Dict, mesh) -> Tuple[Dict, Optional[Tuple[str, ...]]]:
    """This rank's rows of every array of ``batch``, and the batch axes."""
    ba = batch_axes_for(batch["tokens"].shape[0], mesh)
    rows = collectives.rows(batch["tokens"].shape[0], mesh, ba)
    return {k: v[rows] for k, v in batch.items()}, ba


def _sums(model, batch: Dict, cfg: ArchConfig, dev, mesh, z_loss: float = 1e-4):
    """(this rank's loss sum, the global denominator, the global sums
    [loss, nll, z_loss, tokens]) of the batch's loss on ``mesh``."""
    local, ba = _local_batch(batch, mesh)
    logits = api.forward(model, local, cfg, device=dev, mesh=mesh)
    parts = cross_entropy_sums(logits, _labels(local, dev), z_loss)
    sums = collectives.psum(torch.stack(parts).detach(), mesh, ba)
    return parts[0], torch.clamp_min(sums[3], 1.0), sums, ba


def _metrics(sums: torch.Tensor, denom: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"loss": sums[0] / denom, "nll": sums[1] / denom, "z_loss": sums[2] / denom,
            "tokens": sums[3]}


def _mesh_grads(grads: Dict[str, torch.Tensor], specs: Mapping[str, Spec], mesh,
                ba: Optional[Tuple[str, ...]]) -> Dict[str, torch.Tensor]:
    """The global batch's gradients from this rank's (see the module
    docstring); whole weights are summed in one buffer per dtype. Every
    rank issues the same collectives in the same order (names in
    parameter order, never a set's)."""
    sharded = sharded_names(specs)
    whole = [n for n in grads if n not in sharded]
    for dtype in dict.fromkeys(grads[n].dtype for n in whole):
        names = [n for n in whole if grads[n].dtype == dtype]
        flat = collectives.psum(torch.cat([grads[n].reshape(-1) for n in names]), mesh, ba)
        for n, part in zip(names, torch.split(flat, [grads[n].numel() for n in names])):
            grads[n] = part.view_as(grads[n])
    n_data = mesh_shape(mesh).get("data", 1)
    for n in sharded:
        axes = {a for e in specs[n] for a in entry_axes(e)}
        g = collectives.psum(grads[n], mesh, tuple(a for a in ba or () if a not in axes))
        if "data" in axes and "data" not in (ba or ()):
            g = g / n_data  # every data rank sent the same rows
        grads[n] = g
    return grads


def _global_sq(specs: Mapping[str, Spec], mesh):
    """`adamw.clip_by_global_norm`'s ``reduce_sq`` on ``mesh``: whole
    weights count once, expert slices are summed over their axes."""
    names = sharded_names(specs)  # in parameter order: the ranks' collectives match
    axes = tuple(dict.fromkeys(a for n in names for e in specs[n] for a in entry_axes(e)))
    sharded = set(names)

    def reduce_sq(sq: Dict[str, torch.Tensor]) -> torch.Tensor:
        zero = torch.zeros((), device=next(iter(sq.values())).device)
        whole = torch.stack([v for n, v in sq.items() if n not in sharded] + [zero]).sum()
        split = torch.stack([v for n, v in sq.items() if n in sharded] + [zero]).sum()
        return whole + collectives.psum(split, mesh, axes)

    return reduce_sq


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # a weight the forward never reads (a recurrent block's ln2) has a
    # zero gradient, as in JAX
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, device=None, mesh=None):
    dev = resolve_device(device)
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, dev, mesh)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = dict(state.params.named_parameters())
        logits = api.forward(state.params, batch, cfg, device=dev)
        loss, aux = cross_entropy(logits, _labels(batch, dev))
        grads = _grads(loss, params)
        _, new_opt, opt_aux = adamw_update(opt_cfg, grads, params, state.opt)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   **opt_aux}
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step


def _mesh_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, dev, mesh):
    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = dict(state.params.named_parameters())
        specs = storage_specs(state.params, cfg, mesh)
        own, denom, sums, ba = _sums(state.params, batch, cfg, dev, mesh)
        grads = _mesh_grads(_grads(own / denom, params), specs, mesh, ba)
        _, new_opt, opt_aux = adamw_update(opt_cfg, grads, params, state.opt,
                                           reduce_sq=_global_sq(specs, mesh))
        return TrainState(state.step + 1, state.params, new_opt), {**_metrics(sums, denom),
                                                                    **opt_aux}

    return train_step


def make_eval_step(cfg: ArchConfig, device=None, mesh=None):
    dev = resolve_device(device)

    def eval_step(model: nn.Module, batch: Dict) -> Dict:
        if mesh is not None:
            with torch.no_grad():
                _, denom, sums, _ = _sums(model, batch, cfg, dev, mesh, 0.0)
            return _metrics(sums, denom)
        with torch.no_grad():
            logits = api.forward(model, batch, cfg, device=dev)
            loss, aux = cross_entropy(logits, _labels(batch, dev), z_loss=0.0)
        return {"loss": loss, **aux}

    return eval_step


def make_prefill_step(cfg: ArchConfig, device=None, mesh=None):
    """On a mesh, the batch and cache are this rank's own."""
    def prefill_step(model, batch, cache):
        return api.prefill(model, batch, cfg, cache, device=device, mesh=mesh)

    return prefill_step


def make_decode_step(cfg: ArchConfig, long_ctx: bool = False, device=None, mesh=None):
    """On a mesh, the tokens and cache are this rank's own (with
    ``REPRO_LONG_ATTN=sharded`` and ``long_ctx``: every row, and this
    rank's slice of the cache's sequence)."""
    def decode_step(model, tokens, cache):
        return api.decode_step(model, tokens, cfg, cache, long_ctx=long_ctx, device=device,
                               mesh=mesh)

    return decode_step
