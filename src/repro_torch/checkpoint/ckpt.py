"""Fault-tolerant checkpoints of the LLM train state (port of
repro/checkpoint/ckpt.py), on the JAX package's on-disk layout:

  <dir>/step_<n:08d>/
    arrays.npz      the state's leaves in JAX's pytree layout (head list,
                    stacked tail, hybrid `sub_i` units), keyed by JAX's
                    path strings: ".step", ".params/embed",
                    ".params/tail_blocks/attn/wq", ".opt/.count",
                    ".opt/.m/...", ".opt/.v/..."
    manifest.json   keys, shapes, dtypes and the caller's extra (the
                    data pipeline's state)
    COMMITTED       written last, then the directory renamed into place:
                    a crash mid-write leaves no marker, and restore skips
                    the partial checkpoint.

So a checkpoint written by either package restores in both. bf16 leaves
are stored as their 2-byte patterns (numpy's ``V2``), as the JAX package
stores them. `restore` loads into an existing port state in place.

Over a process mesh (``mesh=``; ``specs``: parameter name -> spec, by
default `sharding.storage_specs`, the layout the step factories keep)
every rank calls `save`: the sharded leaves are gathered, rank 0 writes
whole arrays and commits, and the others wait at a barrier until it has.
`restore` then gives each rank its block of every saved array (elastic
restore: the checkpoint may come from any number of ranks, or from the
JAX package's one device), and `as_dtensors` views a state's blocks as
DTensors placed by `sharding.to_placements`.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.features import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    Spec,
    local_block,
    sharded_names,
    storage_specs,
    to_placements,
)
from repro_torch.models import api
from repro_torch.optim.adamw import OptState
from repro_torch.train.step import TrainState

_PARTS = (("params", ".params"), ("m", ".opt/.m"), ("v", ".opt/.v"))


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # no numpy bf16: the bit pattern, as JAX's npz holds it
        return t.view(torch.int16).numpy().view("V2").copy()
    return t.numpy().copy()


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _key(prefix: str, path: Tuple) -> str:
    return "/".join([prefix] + [str(k) for k in path])


def _parts(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"params": dict(state.params.named_parameters()), "m": dict(state.opt.m),
            "v": dict(state.opt.v)}


def _specs(state: TrainState, mesh, specs: Optional[Mapping[str, Spec]]) -> Mapping[str, Spec]:
    return storage_specs(state.params, state.params.cfg, mesh) if specs is None else specs


def _flatten(state: TrainState, mesh=None, specs=None) -> Dict[str, np.ndarray]:
    cfg = state.params.cfg
    out = {".step": np.asarray(int(state.step), np.int32),
           ".opt/.count": np.asarray(int(state.opt.count), np.int32)}
    parts = _parts(state)
    if mesh is not None:
        specs = _specs(state, mesh, specs)
        for tensors in parts.values():
            for name in sharded_names(specs):
                tensors[name] = collectives.gather_full(tensors[name], specs[name], mesh)
    for part, prefix in _PARTS:
        for path, a in api.to_jax_layout(cfg, parts[part], _array).items():
            out[_key(prefix, path)] = a
    return out


def save(state: TrainState, ckpt_dir: str, step: int, extra: Optional[Dict] = None,
         mesh=None, specs: Optional[Mapping[str, Spec]] = None) -> str:
    """Atomic checkpoint write of a port `TrainState`; returns the
    committed directory. On a mesh every rank calls it (see the module
    docstring)."""
    final = Path(ckpt_dir) / f"step_{step:08d}"
    if mesh is None:
        return _write(_flatten(state), ckpt_dir, step, extra)
    arrays = _flatten(state, mesh, specs)
    if collectives.rank() == 0:
        _write(arrays, ckpt_dir, step, extra)
    collectives.barrier()
    return str(final)


def _write(arrays: Dict[str, np.ndarray], ckpt_dir: str, step: int,
           extra: Optional[Dict]) -> str:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "treedef": "TrainState(step, params, OptState(count, m, v)), JAX pytree layout",
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "extra": extra or {},
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
        (tmp / "COMMITTED").touch()
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


def _committed(ckpt_dir: str):
    base = Path(ckpt_dir)
    if not base.exists():
        return []
    return sorted(d for d in base.iterdir()
                  if d.name.startswith("step_") and (d / "COMMITTED").exists())


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = [int(d.name.split("_")[1]) for d in _committed(ckpt_dir)]
    return max(steps) if steps else None


def restore(state_like: TrainState, ckpt_dir: str, step: Optional[int] = None,
            device=None, mesh=None, specs: Optional[Mapping[str, Spec]] = None
            ) -> Tuple[TrainState, Dict]:
    """Load the checkpoint at ``step`` (default: the latest committed) into
    ``state_like``, a port `TrainState` of the same config living on
    ``device`` (the card unless the caller asks for the CPU): its weights
    and moments are overwritten in place, each leaf keeping its dtype.
    On a mesh, ``state_like`` holds this rank's blocks under ``specs``
    and each gets its block of the saved array. Returns (the state with
    the checkpoint's step and count, extra)."""
    dev = resolve_device(device)
    have = next(state_like.params.parameters()).device
    if have != dev:
        raise ValueError(f"the state lives on {have}, not on {dev}; move it or pass device=")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    cfg = state_like.params.cfg
    with np.load(d / "arrays.npz") as data:
        loaded: Dict[str, np.ndarray] = {}

        def read(key):
            if key not in loaded:
                loaded[key] = data[key]
            return loaded[key]

        parts = _parts(state_like)
        specs = _specs(state_like, mesh, specs) if mesh is not None else {}
        with torch.no_grad():
            for part, prefix in _PARTS:
                for name, t in parts[part].items():
                    path, idx = api.jax_path(cfg, name)
                    key = _key(prefix, path)
                    a = read(key)
                    a = a if idx is None else a[idx]
                    if name in specs:
                        a = local_block(a, specs[name], mesh)
                    if tuple(a.shape) != tuple(t.shape):
                        raise ValueError(f"{key}: shape {a.shape} != {tuple(t.shape)}")
                    t.copy_(_tensor(a))  # cast to the leaf's dtype

        def scalar(key):
            return torch.tensor(int(read(key)), dtype=torch.int32, device=dev)

        state = TrainState(scalar(".step"), state_like.params,
                           OptState(scalar(".opt/.count"), state_like.opt.m, state_like.opt.v))
    return state, manifest["extra"]


def as_dtensors(state: TrainState, mesh, specs: Optional[Mapping[str, Spec]] = None
               ) -> Dict[str, Dict[str, "torch.distributed.tensor.DTensor"]]:
    """{"params" | "m" | "v": {name: DTensor}}: each of the state's tensors
    (this rank's block, not copied) placed on ``mesh`` by its spec."""
    from torch.distributed.tensor import DTensor

    specs = _specs(state, mesh, specs)
    out = {}
    for part, tensors in _parts(state).items():
        out[part] = {}
        for name, t in tensors.items():
            spec = specs.get(name, (None,) * t.ndim)
            out[part][name] = DTensor.from_local(t.detach(), mesh, to_placements(spec, mesh),
                                                 run_check=False)
    return out


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    for d in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
