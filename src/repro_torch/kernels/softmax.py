"""Block-ELL row softmax: a hand-written CUDA kernel for Hopper, its
plain-torch version, and the wrapper that picks between them.

Port of repro/kernels/softmax_pallas.py. The kernel lives in
``csrc/softmax.cu`` (built and loaded by kernels/build.py); its header
says what bounds it on an H100 and what the design does about it.

  row_softmax_block_ell  <- row_softmax_block_ell

Both compute, for every padded row of a dense-W logits table
(nrb, W, rb, bc), the masked, stable softmax over the row's W * bc cells
as the Pallas kernel does: masked cells (mask <= 0) read as
finfo(float32).min, the row max m is replaced by 0 unless it exceeds
that value, live cells get exp(v - m) and masked cells +0.0, and the
row is divided by max(sum, 1e-30). So a live row whose logits are all
finfo.min comes out all zeros, where the CSR oracle and the port's
``ref.row_softmax_block_ell_ref`` (``m = 0`` only when m is not finite)
give 1/deg.

The wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel on the current stream or raises.
``LAUNCHES`` counts the kernel's launches (one per wrapper call).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, LL, P
from repro_torch.kernels.ref import CHUNK_ELEMS, chunk_ranges

LAUNCHES: Dict[str, int] = {"row_softmax_block_ell": 0}

BLOCKINGS = ((8, 8), (16, 8), (8, 16))  # (rb, bc) the registry offers


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# csrc/softmax.cu, built at first use, with its C signature declared
_lib = functools.partial(build.load, "softmax", {
    "autosage_row_softmax": [P, P, P, LL, LL, I, I, P],
})


def row_softmax_block_ell_plain(
    vals: torch.Tensor,  # f32 (nrb, W, rb, bc) logits
    mask: torch.Tensor,  # f32 same shape, structural (> 0 is live)
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """Plain version of `row_softmax_block_ell`, in chunks of row blocks
    (one slab is 1.86 MB at Reddit-0.25, the table 13.6 GB)."""
    neg = torch.finfo(torch.float32).min
    out = torch.empty(vals.shape, dtype=torch.float32, device=vals.device)
    nrb, w, rb, bc = vals.shape
    for lo, hi in chunk_ranges(nrb, w * rb * bc, chunk_elems):
        on = mask[lo:hi] > 0
        masked = torch.where(on, vals[lo:hi], neg)
        m = masked.amax(dim=(1, 3), keepdim=True)
        m = torch.where(m > neg, m, 0.0)
        e = torch.exp(masked - m) * on
        out[lo:hi] = e / torch.clamp(e.sum(dim=(1, 3), keepdim=True), min=1e-30)
    return out


def row_softmax_block_ell(
    vals: torch.Tensor,  # f32 (nrb, W, rb, bc) logits
    mask: torch.Tensor,  # f32 same shape, structural (> 0 is live)
) -> torch.Tensor:
    """Softmax per padded row over each row block's (W, rb, bc) slab;
    masked cells +0.0. One CUDA block per row block; two launches give
    the same bits."""
    if vals.device.type == "cpu":
        return row_softmax_block_ell_plain(vals, mask)
    name = "row_softmax_block_ell"
    build.check_operands(name, vals.device, vals=vals, mask=mask)
    if vals.dim() != 4 or mask.shape != vals.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and mask "
                         f"{tuple(mask.shape)} must be one (nrb, W, rb, bc) shape")
    nrb, w, rb, bc = vals.shape
    if (rb, bc) not in BLOCKINGS:
        raise ValueError(f"{name}: {rb}x{bc} tiles; the kernel takes {BLOCKINGS}")
    out = torch.empty(vals.shape, dtype=torch.float32, device=vals.device)
    if nrb * w == 0:
        return out
    rc = _lib().autosage_row_softmax(vals.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                     nrb, w, rb, bc, build.stream_of(vals.device))
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
