"""Family dispatch: one entry point per model operation, covering every
architecture of `repro_torch.configs` (port of repro/models/api.py).

Each entry point runs on ``device``, the card unless the caller asks for
the CPU (``device="cpu"``): the model must already live there, and
numpy inputs (tokens, patch embeddings, frames) are moved there. There
is no fallback from the card to the CPU. `prefill` and `decode_step`
write the cache in place and return it with its positions advanced.
``mesh`` (a process mesh, `launch.mesh`) is threaded as JAX threads
it: the inputs are this rank's own, MoE layers take the expert-parallel
path, and with ``REPRO_LONG_ATTN=sharded`` a long-context decode step
takes the sharded CSR window attention. Whisper ignores it, as in JAX.

The carry-over functions convert weights, caches and train states
between the port (one flat list of layers, tensors keyed by parameter
name) and the JAX package's pytrees (head list, stacked tail, hybrid
`sub_i` units; numpy arrays): `jax_path` maps a parameter name to its
pytree path and stack index.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.modules import Key, to_numpy, to_tensor


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


def forward(model, batch: Dict, cfg: ArchConfig, device=None, mesh=None,
            sage=None) -> torch.Tensor:
    """Teacher-forcing logits (B, S, V), fp32. ``sage`` schedules the
    window attention of a config with a layer plan (Mellum2)."""
    batch = _inputs(batch, _on(model, device))
    if _is_audio(cfg):
        return encdec.encdec_forward(model, batch, cfg)
    return transformer.lm_forward(model, batch, cfg, mesh, sage)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> Dict:
    dev = resolve_device(device)
    if _is_audio(cfg):
        return encdec.init_encdec_cache(cfg, batch, max_len, dtype, dev)
    return transformer.init_lm_cache(cfg, batch, max_len, dtype, dev)


def prefill(model, batch: Dict, cfg: ArchConfig, cache: Dict, device=None, mesh=None):
    """The prompt through the model, filling ``cache``: (last position's
    logits (B, 1, V), cache)."""
    batch = _inputs(batch, _on(model, device))
    with torch.no_grad():
        if _is_audio(cfg):
            return encdec.encdec_prefill(model, batch, cfg, cache)
        return transformer.lm_prefill(model, batch, cfg, cache, mesh)


def decode_step(model, tokens, cfg: ArchConfig, cache: Dict, long_ctx: bool = False,
                device=None, mesh=None):
    """One token per row (B, 1): (logits (B, 1, V), cache). ``long_ctx``
    routes GQA layers through the CSR window + sink attention."""
    tokens = _inputs(tokens, _on(model, device))
    with torch.no_grad():
        if _is_audio(cfg):
            return encdec.encdec_decode_step(model, tokens, cfg, cache)
        return transformer.lm_decode_step(model, tokens, cfg, cache, long_ctx, mesh)


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


def jax_path(cfg: ArchConfig, name: str) -> Tuple[Tuple, Optional[int]]:
    """(JAX pytree path, index along the stacked layer axis or None) of
    the port parameter ``name``."""
    if _is_audio(cfg):
        return encdec.encdec_jax_path(name)
    return transformer.lm_jax_path(cfg, name)


def to_jax_layout(cfg: ArchConfig, tensors: Mapping[str, torch.Tensor],
                  convert: Callable = to_numpy) -> Dict[Tuple, np.ndarray]:
    """Tensors keyed by parameter name (weights, or moments of the same
    names) as ``convert``-ed arrays keyed by JAX pytree path, the layers
    of each stacked leaf stacked along a leading axis."""
    groups: Dict[Tuple, Dict] = {}
    for name, t in tensors.items():
        path, idx = jax_path(cfg, name)
        groups.setdefault(path, {})[idx] = convert(t)
    return {path: by[None] if None in by else np.stack([by[i] for i in range(len(by))])
            for path, by in groups.items()}


def _nest(flat: Mapping[Tuple, Any]) -> Dict:
    """{("a", 0, "b"): x} -> {"a": [{"b": x}]}: int keys index lists."""
    root: Dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(root)


def tree_to_numpy(cfg: ArchConfig, tensors: Mapping[str, torch.Tensor]) -> Dict:
    """Tensors keyed by parameter name as the JAX package's pytree of
    numpy arrays (bf16 as float32)."""
    tree = _nest(to_jax_layout(cfg, tensors))
    if not _is_audio(cfg):
        tree.setdefault("head_blocks", [])
    return tree


def params_to_numpy(cfg: ArchConfig, model) -> Dict:
    """The model's weights as `repro.models.api.init_model`'s pytree (the
    inverse of `params_from_jax`), numpy arrays."""
    return tree_to_numpy(cfg, dict(model.named_parameters()))


def tensors_from_jax(cfg: ArchConfig, tree_np, like: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The leaves of a JAX pytree (numpy arrays) as new tensors keyed by
    parameter name, each with the device and dtype of ``like[name]``."""
    out = {}
    for name, t in like.items():
        path, idx = jax_path(cfg, name)
        a = tree_np
        for k in path:
            a = a[k]
        a = np.asarray(a)
        out[name] = to_tensor(a if idx is None else a[idx], t.device, t.dtype)
    return out


def train_state_to_numpy(cfg: ArchConfig, state):
    """A port `TrainState` in the JAX package's layout: step and count as
    int32 scalars, weights and moments as its pytrees of numpy arrays."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.step import TrainState  # train.step imports this module

    return TrainState(
        step=np.asarray(int(state.step), np.int32),
        params=params_to_numpy(cfg, state.params),
        opt=OptState(count=np.asarray(int(state.opt.count), np.int32),
                     m=tree_to_numpy(cfg, state.opt.m), v=tree_to_numpy(cfg, state.opt.v)),
    )


def train_state_from_jax(cfg: ArchConfig, state_np, device=None):
    """The port's `TrainState` from `repro.train.step.TrainState`'s leaves
    as numpy arrays (or `train_state_to_numpy`'s output), on ``device``."""
    from repro_torch.optim.adamw import OptState, init_opt_state
    from repro_torch.train.step import TrainState  # train.step imports this module

    dev = resolve_device(device)
    model = params_from_jax(cfg, state_np.params, dev)
    zeros = init_opt_state(model)

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=dev)

    return TrainState(
        step=scalar(state_np.step), params=model,
        opt=OptState(count=scalar(state_np.opt.count),
                     m=tensors_from_jax(cfg, state_np.opt.m, zeros.m),
                     v=tensors_from_jax(cfg, state_np.opt.v, zeros.v)),
    )
