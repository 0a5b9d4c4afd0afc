"""Partition-spec rules (port of repro/distributed/sharding.py): DP/FSDP
over 'data', TP over 'model', EP for MoE experts, SP (sequence/context
parallel) for long-context KV caches, pure DP over 'pod'.

A spec is a plain tuple with one entry per dimension: ``None``, an axis
name, or a tuple of axis names (the first one major), JAX's
`PartitionSpec` without JAX. Every rule takes anything whose ``.shape``
gives the axis sizes: a dict (a stand-in mesh, as the JAX package's
tests use) or a `DeviceMesh` (its ``mesh_dim_names`` and shape tuple).

Rules are by JAX pytree path: each port parameter name is mapped
through `models.api.jax_path`. The port keeps one flat list of layers
where JAX stacks the tail, so a layer's tensor gets JAX's *inner* spec,
without the stacked dimension's leading ``None``; divisibility is the
same per dimension. `cache_specs` reads the port's flat cache layout
the same way. `to_placements` turns a spec into DTensor placements,
`local_block` cuts a rank's block out of a whole tensor, and
`storage_specs` / `localize` give the layout the step factories keep
on each rank (experts sliced for EP, everything else replicated).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig

Spec = Tuple  # per dimension: None, an axis name, or a tuple of axis names


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh` or of anything whose ``.shape``
    is such a dict."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, the major one first."""
    if not entry:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes) -> int:
    """The number of ranks over ``axes`` (a name, a tuple of names or None)."""
    sizes = mesh_shape(mesh)
    return int(np.prod([sizes[a] for a in entry_axes(axes)], dtype=np.int64))


def _entry(axis):
    """A one-axis tuple as the axis name, as `PartitionSpec` stores it."""
    return axis[0] if isinstance(axis, (tuple, list)) and len(axis) == 1 else axis


def sanitize(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop axis assignments that do not divide the dimension."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts[: len(shape)]):
        out.append(_entry(axis) if axis and dim % axis_size(mesh, axis) == 0 else None)
    return tuple(out)


# --------------------------------------------------------------- params
def _rule_for(path_names, shape, cfg: ArchConfig) -> Spec:
    name = path_names[-1]
    nd = len(shape)

    # MoE expert tensors: EP over data, TP over expert-hidden
    if "ffn" in path_names and name in ("w_gate", "w_up", "w_down") and nd == 3:
        if name == "w_down":
            return ("data", "model", None)
        return ("data", None, "model")
    if name == "router":
        return (None, None)

    if name in ("embed", "enc_pos", "dec_pos"):
        return ("model", None) if nd == 2 else (None,)
    if name == "unembed":
        return ("data", "model")
    # attention / generic matmuls: FSDP in-dim over data, TP out-dim over model
    if nd == 2:
        if name in ("wo", "w_down", "w_out"):  # row-parallel side
            return ("model", "data")
        return ("data", "model")
    if nd == 3:  # JAX's stacked-scan versions get a leading layer dim
        if name in ("wo", "w_down", "w_out"):
            return (None, "model", "data")
        return (None, "data", "model")
    return (None,) * nd


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape of a module (its named parameters, meta
    tensors included) or of a mapping of name -> tensor or shape."""
    items = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    return {n: tuple(getattr(t, "shape", t)) for n, t in items}


def param_specs(params, cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """Parameter name -> spec of a model (or a mapping of name -> tensor or
    shape): JAX's spec of the leaf the name maps to, without the leading
    ``None`` of a stacked layer axis."""
    from repro_torch.models import api  # the models import this module's users

    out = {}
    for name, shape in _named_shapes(params).items():
        path, _ = api.jax_path(cfg, name)
        names = [str(k) for k in path]
        out[name] = sanitize(_rule_for(names, shape, cfg), shape, mesh)
    return out


# ---------------------------------------------------------------- batch
def batch_axes_for(global_batch: int, mesh) -> Optional[Tuple[str, ...]]:
    """The axes of ('pod', 'data') whose product divides the batch, each
    taken in turn while it still divides (JAX's rule)."""
    sizes = mesh_shape(mesh)
    chosen = []
    size = 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (size * sizes[a]) == 0:
            chosen.append(a)
            size *= sizes[a]
    return tuple(chosen) or None


def batch_specs(batch_shape: Mapping[str, Any], cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """Key -> spec of a batch (tensors or arrays): rows over the batch
    axes; where the batch does not divide, the sequence dimension over
    'data' (context parallel) when it divides."""
    gb = batch_shape["tokens"].shape[0]
    ba = batch_axes_for(gb, mesh)
    out = {}
    for key, leaf in batch_shape.items():
        shape = tuple(leaf.shape)
        s: list = [ba] + [None] * (len(shape) - 1)
        if ba is None and len(shape) >= 2:
            s[1] = "data" if shape[1] % axis_size(mesh, "data") == 0 else None
        out[key] = sanitize(tuple(s), shape, mesh)
    return out


# ---------------------------------------------------------------- cache
def _cache_leaf_spec(name: str, shape: Tuple[int, ...], ba, mesh) -> Spec:
    if name == "pos" or len(shape) == 0:
        return sanitize((None,) * len(shape), shape, mesh)
    inner: list = [None] * len(shape)
    if name in ("k", "v", "c_kv", "k_rope", "conv", "enc_out"):
        inner[0] = ba  # batch
        if len(shape) >= 2:
            if ba is None:
                inner[1] = ("data", "model")  # context parallel
            else:
                # sequence-parallel cache length for decode, the MLA
                # latent cache included
                inner[1] = "model" if name in ("k", "v", "c_kv", "k_rope") else None
    elif name == "h":  # recurrent states (B, H, N, P) or (B, W)
        inner[0] = ba
        if len(shape) >= 2:
            inner[1] = "model"
    return sanitize(tuple(inner), shape, mesh)


def _leaf_shape(v) -> Tuple[int, ...]:
    return () if isinstance(v, int) else tuple(v.shape)


def cache_specs(cache: Mapping, cfg: ArchConfig, mesh, global_batch: int) -> Dict:
    """Specs in the structure of a port cache (``{"layers": [{name: leaf}]}``,
    or Whisper's flat dict): KV caches by batch over ('pod', 'data') when
    it divides, else by length over ('data', 'model') (context
    parallelism, the long_500k path); SSM / recurrent states by batch,
    then heads. An int ``pos`` gets ``()``."""
    ba = batch_axes_for(global_batch, mesh)

    def one(layer: Mapping) -> Dict[str, Spec]:
        return {n: _cache_leaf_spec(n, _leaf_shape(v), ba, mesh) for n, v in layer.items()}

    if "layers" in cache:
        return {"layers": [one(c) for c in cache["layers"]]}
    return one(cache)


# ------------------------------------------------------------ placement
def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where the mesh axis shards tensor dimension d, else
    ``Replicate()``. Axes that share a dimension nest in mesh order, so
    a tuple entry must list them in mesh order (the major one first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    placements = []
    for axis in names:
        dims = [d for d, e in enumerate(spec) if axis in entry_axes(e)]
        if len(dims) > 1:
            raise ValueError(f"axis {axis!r} shards more than one dimension of {spec}")
        placements.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        order = [names.index(a) for a in entry_axes(e)]
        if order != sorted(order):
            raise ValueError(f"{e}: axes sharing a dimension must follow the mesh order {names}")
    return placements


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a `DeviceMesh`."""
    return {a: mesh.get_local_rank(a) for a in mesh_shape(mesh)}


def block_index(entry, mesh, coords: Mapping[str, int]) -> Tuple[int, int]:
    """(block index, number of blocks) along a dimension whose spec entry
    is ``entry``, at mesh coordinates ``coords``: the axes' coordinates
    as one number, the first axis major."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_block(t, spec: Spec, mesh, coords: Optional[Mapping[str, int]] = None):
    """The block of ``t`` (a tensor or array) that the rank at ``coords``
    (default: this rank) holds under ``spec``: a view."""
    coords = mesh_coords(mesh) if coords is None else coords
    index = []
    for dim, entry in zip(t.shape, tuple(spec) + (None,) * (t.ndim - len(spec))):
        i, n = block_index(entry, mesh, coords)
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide into {n} blocks ({spec})")
        size = dim // n
        index.append(slice(i * size, (i + 1) * size))
    return t[tuple(index)]


# -------------------------------------------------- the steps' storage
def storage_specs(params, cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """Parameter name -> the spec the step factories keep it in on a
    mesh: expert tensors by `moe.moe_param_specs` where the expert-
    parallel path runs (`moe.ep_active`), everything else replicated.
    (JAX stores dense weights sharded by `param_specs`; the port keeps
    them whole on every rank.)"""
    from repro_torch.models import moe

    ep = moe.moe_param_specs(cfg) if cfg.moe and moe.ep_active(cfg, mesh) else {}
    out = {}
    for name, shape in _named_shapes(params).items():
        leaf = name.rsplit(".", 1)[-1]
        expert = ".ffn." in f".{name}" and len(shape) == 3  # a shared expert's are 2-d
        out[name] = ep[leaf] if expert and leaf in ep else (None,) * len(shape)
    return out


def sharded_names(specs: Mapping[str, Spec]) -> Tuple[str, ...]:
    """The names whose spec shards some dimension."""
    return tuple(n for n, s in specs.items() if any(entry_axes(e) for e in s))


def localize(model, specs: Mapping[str, Spec], mesh) -> None:
    """Replace each parameter of ``model`` whose spec shards it by this
    rank's block of it (a copy), in place."""
    import torch
    from torch import nn

    for name in sharded_names(specs):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        block = local_block(getattr(mod, leaf).detach(), specs[name], mesh)
        setattr(mod, leaf, nn.Parameter(block.clone(memory_format=torch.contiguous_format)))
