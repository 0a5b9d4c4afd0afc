"""Graphs and node data made on the device from a seed.

`Graph` is the CSR that every generator returns; a configuration names
its generator under ``graph_generator`` (``gen/<generator>.py``, whose
``make(config, gen)`` draws the graph from the configuration's fixed
``graph_seed``). The graph is the dataset: every run trains on the same
graph, as a user trains on the same Reddit or Products graph; the run's
seed draws the features, labels and weights here. (An arrangement of the
degrees drawn from the run's seed changed the scheduler's decisions from
seed to seed: its probe subgraph samples fixed row ids, so some
arrangements put a hub there and the step took twice as long. PERF.md
keeps the readings.)
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """A CSR graph on the device (int64 rowptr, int64 colind) and the
    same arrays on the host as int32 numpy, the layout the port reads."""

    rowptr: torch.Tensor
    colind: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.colind.shape[0])

    def host_arrays(self) -> tuple:
        return (self.rowptr.to(torch.int32).cpu().numpy(),
                self.colind.to(torch.int32).cpu().numpy())


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device``; seeds are taken modulo 2**63 so any
    whole number up to 2**64 works."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def normal_weights(shapes: Sequence[tuple], gen: torch.Generator) -> List[torch.Tensor]:
    """One normal draw for all matrices, split and scaled by
    1/sqrt(fan_in) (the port's GAT initialisation rule)."""
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out, o = [], 0
    for s, k in zip(shapes, sizes):
        out.append((flat[o:o + k].view(s) * s[0] ** -0.5).contiguous())
        o += k
    return out


def node_data(n: int, in_dim: int, n_classes: int, gen: torch.Generator) -> tuple:
    """Features (n, in_dim) standard normal and, with classes, labels
    uniform in [0, n_classes) (None without classes)."""
    x = torch.randn(n, in_dim, generator=gen, device=gen.device)
    y = (torch.randint(0, n_classes, (n,), generator=gen, device=gen.device)
         if n_classes else None)
    return x, y
