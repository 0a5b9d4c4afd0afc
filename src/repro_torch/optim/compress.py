"""Gradient compression for the slow cross-pod link (port of
repro/optim/compress.py).

int8 symmetric quantization with error feedback (EF-SGD style): each pod
keeps a residual state; the quantization error is added back into the
next step's gradient, so the compression bias vanishes over time.
Applied as a compressed psum over the 'pod' axis of a mesh: the
intra-pod reduction stays full precision, only the inter-pod traffic is
compressed 4x (f32 -> i8). The scale is max|x| / 127 + 1e-12 in fp32
and the rounding half to even, as in JAX, so ``q`` and the dequantized
values are JAX's bit for bit; only the order of the sum over the pods
may differ.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.distributed import collectives


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, mesh, axis_name: str, ef: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 psum over ``axis_name`` of ``mesh``. Returns
    (the mean over the axis' ranks, approximated; the new error-feedback
    state)."""
    n = collectives.axis_size(mesh, axis_name)
    xf = x.float() + ef
    q, scale = _quant(xf)
    # the sum of the dequantized int8 values across pods: scales differ
    # per pod, so the dequantized values are summed (wire format int8 +
    # an f32 scalar per tensor)
    deq = q.float() * scale
    total = collectives.psum(deq, mesh, axis_name)
    new_ef = xf - deq  # local quantization residual
    return (total / n).to(x.dtype), new_ef


def compressed_psum_tree(tree: Mapping[str, torch.Tensor], mesh, axis_name: str,
                         ef_tree: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """`compressed_psum` of every tensor of ``tree`` (by name) with its
    error-feedback state in ``ef_tree``: (outputs, new states)."""
    outs, new_efs = {}, {}
    for name, x in tree.items():
        outs[name], new_efs[name] = compressed_psum(x, mesh, axis_name, ef_tree[name])
    return outs, new_efs


def init_ef(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for n, x in tree.items()}
