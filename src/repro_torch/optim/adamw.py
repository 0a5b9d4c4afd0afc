"""AdamW with decoupled weight decay, global-norm clipping, and a cosine
schedule with linear warmup (port of repro/optim/adamw.py).

Plain functions over a model's named parameters (a module or a dict of
name -> tensor). Optimizer moments are fp32 whatever the parameter
dtype, as in the JAX package: each update runs in fp32 and casts back
(`torch.optim.AdamW` would keep bf16 moments for bf16 weights). Where
JAX returns new arrays, `adamw_update` writes the parameters and moments
in place; the step count and learning rate stay tensors on the
parameters' device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

Named = Union[nn.Module, Mapping[str, torch.Tensor]]


class OptState(NamedTuple):
    count: torch.Tensor  # int32 scalar: updates taken
    m: Dict[str, torch.Tensor]  # fp32, one per parameter name
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named(params: Named) -> Dict[str, torch.Tensor]:
    """The parameters by name: a module's `named_parameters()`, or the dict."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warmup to
    ``cfg.lr``, then a cosine down to ``min_lr_frac`` of it at
    ``total_steps``, flat after."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Named) -> OptState:
    params = named(params)
    device = next(iter(params.values())).device if params else None
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return OptState(count=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                    v={n: z.clone() for n, z in zeros.items()})


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        reduce_sq: Optional[Callable] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every gradient scaled by min(1, max_norm / global norm), in place;
    returns (grads, the global fp32 norm before clipping). ``reduce_sq``
    maps {name: the sum of the gradient's squares} to the global sum
    where the gradients are split over ranks (default: their sum)."""
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    total = torch.stack(list(sq.values())).sum() if reduce_sq is None else reduce_sq(sq)
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return dict(grads), gn


_NO_DECAY = ("norm", "bias", "ln", "b_", "lam", "a_log", "dt_bias", "d_skip")


def _decay_mask(name: str) -> bool:
    """Decay matrices, not norms/biases/scalars: JAX's substring test on
    the last key of the pytree path, here the last component of the
    parameter name (so Whisper's LayerNorm ``w`` and ``b`` and the conv
    ``conv_w`` / ``conv_b`` decay, as they do in JAX)."""
    last = name.rsplit(".", 1)[-1].lower()
    return not any(s in last for s in _NO_DECAY)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], params: Named,
                 state: OptState, reduce_sq: Optional[Callable] = None
                 ) -> Tuple[Dict[str, torch.Tensor], OptState, Dict]:
    """One AdamW update from ``grads`` (by parameter name; clipped in place,
    ``reduce_sq`` as in `clip_by_global_norm`). The parameters and
    ``state``'s moments are updated in place; returns (params, the new
    OptState, {grad_norm, lr})."""
    params = named(params)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, reduce_sq)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for name, p in params.items():
        g32, m, v = grads[name].float(), state.m[name], state.v[name]
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        step = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if _decay_mask(name):
            step.add_(p.float(), alpha=cfg.weight_decay)
        step.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float().sub_(step))
    return params, OptState(count, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
