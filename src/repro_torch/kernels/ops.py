"""The kernel-level entry points: one function per op, pinned to one
implementation by an ``impl`` string.

Port of repro/kernels/ops.py, with the same signatures and defaults.
Oracles live in ref.py, the kernels' wrappers in spmm.py, sddmm.py,
attention.py and softmax.py, the CSR -> block-ELL conversion in
sparse/bsr.py. ``impl`` names follow the port's variant rule (layout
plus backend):

  ======== ============= =============================================
  port     repro (JAX)   runs
  ======== ============= =============================================
  "cuda"   "pallas"      the dense-W kernel
  "ragged" "ragged"      the ragged (slot-compacted) kernel
  "ref"    "xla"         the kernels/ref.py oracle
  "auto"   "auto"        "cuda" when the operands lie on a CUDA device,
                         else "ref" (input-oblivious, as JAX's "pallas
                         on TPU else xla"; the device is read from the
                         operands, never probed)
  ======== ============= =============================================

On CPU tensors "cuda" and "ragged" run the kernels' plain versions: the
role the JAX package's interpret mode plays. ``sddmm`` has no ragged
branch in the JAX package (its "ragged" runs the dense-W Pallas kernel);
here too "ragged" returns the dense-W kernel's tiles. The fused
attention kernels take 8x8 tiles only. ``f_tile`` is accepted and
ignored: the CUDA SpMM kernels take any F.

DEPRECATED as a call surface, as in the JAX package: the string dispatch
bypasses the scheduler. Use `repro_torch.api.spmm/sddmm/attention`.
`spmm`, `sddmm` and `csr_attention` warn once per call site;
`row_softmax`, which has no counterpart in the api, does not (as in the
JAX package).
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import attention as ka
from repro_torch.kernels import ref
from repro_torch.kernels import sddmm as ksd
from repro_torch.kernels import softmax as ksm
from repro_torch.kernels import spmm as ks
from repro_torch.sparse.bsr import csr_to_block_ell
from repro_torch.sparse.csr import CSR

IMPLS = ("auto", "cuda", "ragged", "ref")


def _warn_deprecated(old: str, new: str) -> None:
    # one-time per call site (Python's default filter dedups by location)
    warnings.warn(
        f"{old} is deprecated; use {new} (see repro_torch.api)",
        DeprecationWarning,
        stacklevel=3,
    )


def _impl(impl: str, operand: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if operand.device.type == "cuda" else "ref"
    return impl


def _up(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _index(csr: CSR, device: torch.device) -> tuple:
    return _up(csr.rowptr, device), _up(csr.colind, device)


def _mask(tiles: np.ndarray) -> np.ndarray:
    """The structural 0/1 mask of block-ELL tiles (nonzero values)."""
    return (tiles != 0).astype(np.float32)


def spmm(csr: CSR, b: torch.Tensor, impl: str = "auto", rb: int = 8, bc: int = 8,
         f_tile: int = 128) -> torch.Tensor:
    """C = A @ B. impl: auto|cuda|ragged|ref.

    Deprecated; use `repro_torch.api.spmm(csr, b, sage=...)`."""
    _warn_deprecated("kernels.ops.spmm", "repro_torch.api.spmm(csr, b, sage=...)")
    impl = _impl(impl, b)
    dev = b.device
    if impl == "ref":
        val = None if csr.val is None else _up(csr.val, dev)
        return ref.spmm_ref(*_index(csr, dev), val, b)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    if impl == "ragged":
        rag = bell.to_ragged()
        return ks.spmm_ragged_ell(_up(rag.blkptr, dev), _up(rag.slot_colblk, dev),
                                  _up(rag.slot_vals, dev), b, n_rows=csr.n_rows)
    return ks.spmm_block_ell(_up(bell.colblk, dev), _up(bell.vals, dev), b,
                             n_rows=csr.n_rows)


def sddmm(csr: CSR, x: torch.Tensor, y: torch.Tensor, impl: str = "auto",
          rb: int = 8, bc: int = 8) -> torch.Tensor:
    """A~_ij = <X_i, Y_j> on S(A); returns CSR-ordered nnz values (ref)
    or dense-W block-ELL tiles (nrb, W, rb, bc) (cuda, ragged).

    Deprecated; use `repro_torch.api.sddmm(csr, x, y, sage=...)`."""
    _warn_deprecated("kernels.ops.sddmm", "repro_torch.api.sddmm(csr, x, y, sage=...)")
    impl = _impl(impl, x)
    dev = x.device
    if impl == "ref":
        return ref.sddmm_ref(*_index(csr, dev), x, y)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    return ksd.sddmm_block_ell(_up(bell.colblk, dev), _up(_mask(bell.vals), dev), x, y)


def csr_attention(
    csr: CSR, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    impl: str = "auto", rb: int = 8, bc: int = 8,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The paper's pipeline (SDDMM -> row-softmax -> SpMM). impl=cuda runs
    the fused dense-W kernel (one pass over the layout), impl=ragged the
    fused kernel over live slots only.

    Deprecated; use `repro_torch.api.attention(csr, q, k, v, sage=...)`."""
    _warn_deprecated(
        "kernels.ops.csr_attention",
        "repro_torch.api.attention(csr, q, k, v, sage=...)",
    )
    impl = _impl(impl, q)
    dev = q.device
    if impl == "ref":
        return ref.csr_attention_ref(*_index(csr, dev), q, k, v, scale)
    if (rb, bc) != (ka.RB, ka.BC):
        raise ValueError(f"csr_attention: the fused kernels take {ka.RB}x{ka.BC} tiles, "
                         f"not {rb}x{bc}")
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    if impl == "ragged":
        rag = bell.to_ragged()
        return ka.fused_ragged_attention(
            _up(rag.blkptr, dev), _up(rag.slot_colblk, dev),
            _up(_mask(rag.slot_vals), dev), q, k, v, n_rows=csr.n_rows, scale=scale,
        )
    return ka.fused_csr_attention(_up(bell.colblk, dev), _up(_mask(bell.vals), dev),
                                  q, k, v, n_rows=csr.n_rows, scale=scale)


def row_softmax(bell_logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Block-ELL row softmax (the CUDA kernel; its plain version on CPU)."""
    return ksm.row_softmax_block_ell(bell_logits, mask)
