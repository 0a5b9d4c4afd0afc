"""Roofline terms of a dry-run cell for NVIDIA H100 SXM5 ranks (the
port's twin of repro/launch/roofline.py):

  compute term    = per-rank FLOPs / peak FLOP/s
  memory term     = per-rank bytes / HBM bandwidth
  collective term = per-rank collective bytes / link bandwidth

The counts come from `launch.op_costs` over rank 0's eager step, so
they are already per rank. The constants are the H100 SXM5 datasheet's;
the terms are datasheet bounds, not measurements:

* ``PEAK_FLOPS``: 989.4 TFLOP/s, dense bf16 on the tensor cores (the dry
  run's states are bf16, as in JAX's);
* ``HBM_BW``: 3.35 TB/s of HBM3;
* ``LINK_BW``: 50 GB/s, one 400 Gb/s NIC per card. A node holds 8
  cards, and every axis of the production meshes crosses nodes
  ('model' is ranks 16·i .. 16·i + 15, two nodes; 'data' and 'pod'
  stride further), so NVLink's 450 GB/s per direction bounds no axis.

JAX's `analyze_raw` (XLA's once-per-loop-body count) has no
counterpart: eager execution has no loop body to count once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989.4e12  # H100 SXM5, dense bf16 tensor cores
HBM_BW = 3.35e12  # H100 SXM5 HBM3
LINK_BW = 50e9  # one 400 Gb/s NIC per card: every mesh axis leaves the node


@dataclasses.dataclass
class Roofline:
    flops: float  # per rank
    hbm_bytes: float  # per rank
    coll_bytes: Dict[str, float]  # per rank, by kind
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = sum(self.coll_bytes.values()) / LINK_BW

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower-bound step time if the three terms overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": dict(self.coll_bytes),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
        }


def analyze(costs) -> Roofline:
    """The roofline of a `launch.op_costs.Costs`."""
    return Roofline(flops=costs.flops, hbm_bytes=costs.bytes, coll_bytes=dict(costs.coll))


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference steps."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
