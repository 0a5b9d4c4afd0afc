"""Shared building blocks of the LLM stack: plain functions over torch
tensors, the weight initialisers, and `Params`, the container every
model part keeps its weights in.

Port of repro/models/modules.py. Weights keep the JAX package's names
and layout: a linear weight is (d_in, d_out) and ``linear(x, w)`` is
``x @ w``, so weights carried over from JAX need no transpose. The
initialisers draw from an explicit `torch.Generator` (their values
differ from `jax.random`'s; parity tests carry JAX's weights over).
Weights require grad; the serving entry points run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.features import resolve_device

Key = Union[int, torch.Generator]
NEG_INF = -1e30  # the additive mask value of the JAX package (not -inf)


class _Shapes:
    """A generator stand-in on the meta device: initialisers given it make
    tensors of the right shapes and dtypes, and allocate and draw
    nothing (full-width shapes for the sharding rules)."""

    device = torch.device("meta")


def make_generator(key: Key = 0, device=None) -> torch.Generator:
    """A generator on ``device`` (the card unless the caller asks for the
    CPU, or the meta device, where nothing is drawn) seeded with ``key``;
    a generator passes through unchanged."""
    if isinstance(key, torch.Generator):
        return key
    dev = resolve_device(device)
    if dev.type == "meta":
        return _Shapes()
    return torch.Generator(device=dev).manual_seed(int(key))


def normal(gen: torch.Generator, shape, std: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return (torch.randn(tuple(shape), generator=gen, device=gen.device) * std).to(dtype)


def zeros(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return normal(gen, (d_in, d_out), scale, dtype)


class Params(nn.Module):
    """Named weights as parameters, under the JAX package's pytree keys;
    a ``None`` leaves the name unset (reads as ``None``). Sub-dicts of
    the JAX pytree are sub-modules assigned as attributes."""

    def __init__(self, **tensors: Optional[torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, None if t is None else nn.Parameter(t))


# ------------------------------------------------------------ carry-over
def torch_dtype(a) -> torch.dtype:
    """The torch dtype of a JAX array given as numpy (bf16 arrives as
    ml_dtypes' bfloat16, which torch cannot read directly)."""
    name = np.asarray(a).dtype.name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def to_tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.asarray(a)
    dt = dtype or torch_dtype(a)
    a = np.array(a, np.float32 if a.dtype.name == "bfloat16" else a.dtype)  # a writable copy
    return torch.from_numpy(a).to(device=device, dtype=dt)


def to_numpy(v) -> np.ndarray:
    """A cache leaf as numpy: a tensor (bf16 as float32), or an int
    position as an int32 scalar."""
    if isinstance(v, int):
        return np.asarray(v, np.int32)
    v = v.detach().cpu()
    return np.array((v.float() if v.dtype == torch.bfloat16 else v).numpy())  # a copy


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a.b": x}; lists index by position."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: tree}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def unstack(tree, n: int) -> List:
    """Split the leading (stacked, scanned-over) axis of every leaf."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return [np.asarray(tree)[i] for i in range(n)]


def load_tree(module: nn.Module, tree) -> None:
    """Copy a JAX parameter (sub)tree into ``module``: the names must be
    the module's parameter names exactly, and every shape must match.
    Each parameter keeps its own dtype."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names differ: JAX only {sorted(set(flat) - set(params))}, "
                         f"port only {sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(flat[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
            p.copy_(to_tensor(a, p.device, p.dtype))


# ------------------------------------------------------------ functions
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S). Rotates the two halves of
    the head dimension (not interleaved pairs), as the JAX package does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (Dh/2,)
    ang = positions[..., None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ FFN
def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return Params(
        w_gate=dense_init(gen, d_model, d_ff, dtype),
        w_up=dense_init(gen, d_model, d_ff, dtype),
        w_down=dense_init(gen, d_ff, d_model, dtype),
    )


def swiglu(params, x):
    g = F.silu(linear(x, params.w_gate).float())
    u = linear(x, params.w_up).float()
    return linear((g * u).to(x.dtype), params.w_down)


def init_gelu_mlp(gen, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return Params(
        w_up=dense_init(gen, d_model, d_ff, dtype),
        b_up=zeros(gen, (d_ff,), dtype),
        w_down=dense_init(gen, d_ff, d_model, dtype),
        b_down=zeros(gen, (d_model,), dtype),
    )


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(params, x):
    h = gelu(linear(x, params.w_up, params.b_up).float())
    return linear(h.to(x.dtype), params.w_down, params.b_down)


def write_along_seq(buf: torch.Tensor, new: torch.Tensor, pos: int, axis: int = 1) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice`` of ``new`` into ``buf`` at ``pos``
    along ``axis``, in place: XLA clamps the start so that the update
    fits, and so does this. ``new`` is cast to the buffer's dtype."""
    s, length = new.shape[axis], buf.shape[axis]
    if s > length:
        raise ValueError(f"an update of {s} positions does not fit a cache of {length}")
    start = min(max(int(pos), 0), length - s)
    buf.narrow(axis, start, s).copy_(new)
    return buf


def additive_mask(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, NEG_INF (-1e30, not -inf) elsewhere, fp32."""
    return torch.zeros(ok.shape, dtype=torch.float32, device=ok.device).masked_fill_(~ok, NEG_INF)
