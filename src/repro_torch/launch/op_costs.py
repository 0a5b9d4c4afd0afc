"""Costs of one rank's eager step, counted op by op (the port's twin of
repro/launch/hlo_costs.py; there is no HLO here, hence the name).

`CostMode` is a `TorchDispatchMode`: every aten and c10d op the step
dispatches passes through it once, on meta tensors in the dry run, and
it adds to a `Costs(flops, bytes, coll)` as JAX's HLO pass does:

  flops: the formulas of `torch.utils.flop_counter`'s registry (mm,
         bmm, addmm, baddbmm, convolution, SDPA), 2·|out|·K per product,
         as JAX counts a dot
  bytes: operand plus result bytes of every op that moves data. Views
         and metadata ops (`view`, `_unsafe_view`, `expand`, `t`,
         `transpose`, `permute`, `as_strided`, `slice`, `select`,
         `alias`, `detach`, and every op whose schema says it returns a
         view) and allocations that write nothing (`empty*`) cost
         nothing, as JAX's `_SKIP` does. Eager torch launches one kernel
         per op, so this counts the port's HBM traffic op by op, not at
         fusion boundaries as JAX does: byte counts are not compared
         across the packages.
  coll:  result bytes per kind of every c10d collective (and its
         `_c10d_functional` form), under JAX's five names; the port
         issues no collective-permute, so that kind stays 0.

Loops need no special handling: JAX's pass multiplies a while body by
its trip count because XLA keeps the loop, while eager execution
dispatches every op each time it runs, so each executed op is counted.

The mode also tracks memory: ``peak_bytes`` is the peak of the live
bytes of the storages the step allocates (a storage is live from the op
that makes it to its last reference; arguments and their views are not
counted), and it raises `HostAllocation` if an op yields a tensor that
is not on the meta device and is larger than 1 MiB, so a dry-run cell
cannot quietly compute on the host.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
HOST_LIMIT_BYTES = 1 << 20

# ops that move no data (JAX's _SKIP): views, metadata, allocations
_FREE = {
    "view", "_unsafe_view", "expand", "t", "transpose", "permute", "as_strided", "slice",
    "select", "alias", "detach", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "resize_", "_reshape_alias", "unsqueeze", "squeeze",
}
# c10d op (in-place form or functional form) -> JAX's collective kind
_C10D_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# the c10d in-place forms write their result into their first argument
_C10D_INPLACE = {"allreduce_", "allreduce_coalesced_", "allgather_", "_allgather_base_",
                 "allgather_into_tensor_coalesced_", "reduce_scatter_", "_reduce_scatter_base_",
                 "reduce_scatter_tensor_coalesced_", "alltoall_", "alltoall_base_"}


class HostAllocation(RuntimeError):
    """An op of a dry-run cell made a tensor off the meta device."""


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})


def _tensors(tree, out=None) -> list:
    """The tensors in ``tree`` (nested lists, tuples and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (nested lists, tuples, dicts)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _name(func) -> str:
    return func._overloadpacket.__name__


def _free(func) -> bool:
    return _name(func) in _FREE or func.is_view


class CostMode(TorchDispatchMode):
    """Counts `Costs` and peak memory of the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def _dead(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        have = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if not t.is_meta and t.numel() * t.element_size() > HOST_LIMIT_BYTES:
                raise HostAllocation(f"an op made a {tuple(t.shape)} {t.dtype} tensor on "
                                     f"{t.device}; the dry run allocates nothing")
            s = t.untyped_storage()
            key = s._cdata
            if key in have or key in self._live:
                continue
            self._live[key] = s.nbytes()
            self.live_bytes += s.nbytes()
            weakref.finalize(s, self._dead, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = _name(func)
        kind = _C10D_KIND.get(name)
        if kind is not None:
            result = _tensors(args[0]) if name in _C10D_INPLACE else outs
            # operands: the inputs that are not result buffers (an
            # all-reduce in place reads its result buffer)
            operands = [t for t in ins if not any(t is r for r in result)] or result
            self.costs.coll[kind] += tensor_bytes(result)
            self.costs.bytes += tensor_bytes(operands) + tensor_bytes(result)
        else:
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.costs.flops += count(*args, **kwargs, out_val=out)
            if not _free(func):
                self.costs.bytes += tensor_bytes(ins) + tensor_bytes(outs)
        self._track(outs, ins)
        return out


def op_costs(fn, *args, **kwargs) -> Costs:
    """`Costs` of one call of ``fn(*args, **kwargs)``."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.costs
