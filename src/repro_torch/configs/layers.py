"""Per-layer attention plans of the port-only configurations.

`ArchConfig` is held field for field equal to the JAX package's, so a
model whose layers differ in their attention (Mellum2: three
sliding-window layers, then one full layer, repeated) keeps that plan
here, beside its config, keyed by the config's name. Every config of
`ARCH_IDS` has no plan, and its layers run as they always did.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig

WINDOW, FULL = "window", "full"


@dataclasses.dataclass(frozen=True)
class Rope:
    """Rotary embedding of one kind of layer: ``default`` (inverse
    frequencies theta^(-2i/d)) or ``yarn`` (Hugging Face's
    ``_compute_yarn_parameters``: the frequencies blended between
    theta's and theta's over ``factor`` by a ramp between the dims
    where ``beta_fast`` and ``beta_slow`` rotations fit the original
    context, cos and sin scaled by ``attention_factor``)."""

    theta: float
    kind: str = "default"
    factor: float = 1.0
    original_max_positions: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    """A repeating period of layer kinds (``window`` or ``full``), the
    window's length and the rope of each kind."""

    period: Tuple[str, ...]
    window: int
    window_rope: Rope
    full_rope: Rope


@dataclasses.dataclass(frozen=True)
class LayerAttn:
    """The attention of one layer: ``window`` is None on a full layer;
    on a window layer, row t attends to positions t - window + 1 .. t."""

    kind: str
    window: Optional[int]
    rope: Rope


def _patterns() -> Dict[str, LayerPattern]:
    from repro_torch.configs import mellum2

    return mellum2.PATTERNS


def layer_plan(cfg: ArchConfig) -> Optional[List[LayerAttn]]:
    """The attention of each of ``cfg``'s layers, or None for a config
    without a plan (every config of `ARCH_IDS`)."""
    pattern = _patterns().get(cfg.name)
    if pattern is None:
        return None
    out = []
    for i in range(cfg.n_layers):
        kind = pattern.period[i % len(pattern.period)]
        out.append(LayerAttn(kind, pattern.window, pattern.window_rope) if kind == WINDOW
                   else LayerAttn(kind, None, pattern.full_rope))
    return out
