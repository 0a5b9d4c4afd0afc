"""The collectives of the JAX package's shard_map bodies as torch
functions over the process groups of a mesh's axes.

The JAX package writes ``psum``, ``pmax``, ``all_to_all`` and
``axis_index`` inline in its shard_map bodies; here they take a mesh
(a `DeviceMesh`, see `launch.mesh`) and an axis name or a tuple of
names, and each has the gradient JAX gives it where a model
differentiates through it:

* `all_to_all`: the backward is the reverse all-to-all;
* `psum`: the forward sums each rank's partial result over the axes and
  the backward is the identity. Every use reads the sum replicated over
  the axes (the expert-parallel MoE's partial outputs over 'model'), so
  the gradient of each partial is the gradient of the sum;
* `psum_grad`: the identity forward, a sum of the gradient over the
  axes backward: where a tensor replicated over the axes feeds work
  that each rank does on its slice of the weights (JAX's transpose of a
  replicated shard_map input);
* `pmax`, `all_gather`, `gather_full`: no gradient (decode, checkpoints).

`init` joins the process group that ``python -m torch.distributed.run``
describes in the environment. The backend follows the topology only:
``nccl`` where the node has at least as many cards as local ranks,
``gloo`` otherwise (several ranks on one card, or the CPU). A failed
init raises; nothing retries on another backend. Gloo ran every one of
these collectives on CUDA tensors on the card (all-reduce SUM and MAX in
fp32 and bf16, all-gather, all-to-all in fp32 and int32, on 4 ranks of
one H100), so no wrapper stages a tensor through host memory itself
(gloo copies CUDA tensors through the host inside). DTensor's own collectives on CUDA tensors
over gloo crashed the ranks there (``full_tensor``), so nothing here
goes through them: `gather_full` is this module's.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (
    axis_size,
    block_index,
    entry_axes,
    mesh_coords,
    mesh_shape,
)

Axes = Union[None, str, Tuple[str, ...]]


# ------------------------------------------------------------ the group
def launched() -> bool:
    """Whether this process is a rank that torch.distributed.run started."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU if the caller asks for it, else
    ``cuda:{LOCAL_RANK % device_count}``; no card raises."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init(device=None) -> torch.device:
    """Join the process group described by the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) unless this process already
    has; returns this rank's device. Rank 0 prints the backend."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend_for(dev)
        dist.init_process_group(backend, init_method="env://")
        if dist.get_rank() == 0:
            print(f"[dist] backend {backend}: {dist.get_world_size()} ranks on {dev.type}",
                  flush=True)
    return dev


def finish() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# ------------------------------------------------------------- plumbing
def _axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The named axes of size > 1."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in entry_axes(axes) if sizes[a] > 1)


def _all_reduce(x: torch.Tensor, mesh, axes: Axes, op) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    for a in _axes(mesh, axes):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index over ``axes`` as one number, the first axis major
    (JAX's ``axis_index`` summed over the axes with their strides)."""
    return block_index(axes, mesh, mesh_coords(mesh))[0]


# ----------------------------------------------------------- reductions
class _PsumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, None


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a new tensor); its
    gradient is the identity (see the module docstring)."""
    if not _axes(mesh, axes):
        return x
    return _PsumPartials.apply(x, mesh, axes)


def psum_grad(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over the ranks of ``axes``."""
    if not _axes(mesh, axes) or not x.requires_grad:
        return x
    return _PsumGrad.apply(x, mesh, axes)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes`` (no gradient)."""
    if not _axes(mesh, axes):
        return x.detach()
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


# ---------------------------------------------------------- all-to-all
def _a2a(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``: x's leading
    dimension is cut into one block per rank of ``axis``; block j goes to
    rank j, and the block from rank j lands at position j. Differentiable
    (the backward is the same exchange)."""
    if not _axes(mesh, axis):
        return x
    if x.shape[0] % axis_size(mesh, axis):
        raise ValueError(f"leading dimension {x.shape[0]} does not split over {axis!r}")
    if x.requires_grad:
        return _AllToAll.apply(x, mesh, axis)
    return _a2a(x, mesh, axis)


# ------------------------------------------------------------- gathers
def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of ``axes`` concatenated along ``dim`` in
    axis order, the first axis major (no gradient)."""
    out = x.detach()
    for a in reversed(_axes(mesh, axes)):  # minor axis first
        n = axis_size(mesh, a)
        src = out.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.get_group(a))
        out = torch.cat(parts, dim=dim)
    return out


def gather_full(x: torch.Tensor, spec: Iterable, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (a
    collective: every rank of the mesh calls it)."""
    out = x.detach()
    for d, entry in enumerate(spec):
        if entry_axes(entry):
            out = all_gather(out, mesh, entry, dim=d)
    return out


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def rows(batch_size: int, mesh, axes: Optional[Tuple[str, ...]]) -> slice:
    """This rank's rows of a batch whose leading dimension is sharded over
    ``axes`` (all rows where ``axes`` is None)."""
    if not axes:
        return slice(0, batch_size)
    n = axis_size(mesh, axes)
    i = axis_index(mesh, axes)
    return slice(i * batch_size // n, (i + 1) * batch_size // n)
