"""Library-op SpMM variants: the guardrail baseline and the other
candidates that run on any device.

Port of the SpMM half of repro/kernels/xla.py. The JAX package runs these
in plain XLA outside any Pallas kernel, so the port runs them as plain
torch ops. Each variant is a host-side ``prepare`` (format conversion,
done once and amortized) plus a ``run`` on device tensors. The gathers
work in row chunks (see kernels/ref.py) to keep memory bounded.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import CHUNK_ELEMS
from repro_torch.sparse.bsr import hub_split
from repro_torch.sparse.csr import CSR


def prepare_csr(csr: CSR) -> Dict[str, np.ndarray]:
    return {
        "rowptr": np.asarray(csr.rowptr, np.int32),
        "colind": np.asarray(csr.colind, np.int32),
        "val": csr.values_or_ones(np.float32),
    }


def spmm_gather_segsum(aux: Dict, b: torch.Tensor) -> torch.Tensor:
    """Baseline SpMM: gather + deterministic segment-sum (cuSPARSE
    stand-in)."""
    return ref.spmm_ref(aux["rowptr"], aux["colind"], aux["val"], b)


def prepare_dense(csr: CSR) -> Dict[str, np.ndarray]:
    return {"a": csr.to_dense()}


def spmm_dense(aux: Dict, b: torch.Tensor) -> torch.Tensor:
    """Densified matmul — wins only for tiny/dense A; estimate gates it."""
    return aux["a"] @ b.to(aux["a"].dtype)


def prepare_row_ell(csr: CSR) -> Dict[str, np.ndarray]:
    """Pad every row to K = max degree slots (row-ELL). Padded slots:
    col 0, val 0."""
    deg = csr.degrees
    k = max(int(deg.max()) if deg.size else 1, 1)
    n = csr.n_rows
    colind = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    rows = np.repeat(np.arange(n), deg)
    slot = np.arange(csr.nnz) - np.repeat(csr.rowptr[:-1].astype(np.int64), deg)
    colind[rows, slot] = csr.colind
    val[rows, slot] = csr.values_or_ones(np.float32)
    return {"colind": colind, "val": val}


def spmm_row_ell(aux: Dict, b: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: uniform-width gather + dense reduce, in row chunks."""
    colind, val = aux["colind"], aux["val"]
    n, k = colind.shape
    out = torch.empty((n, b.shape[1]), dtype=torch.float32, device=b.device)
    step = max(1, CHUNK_ELEMS // max(k * b.shape[1], 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        gathered = b[colind[lo:hi].long()]  # (rows, K, F)
        out[lo:hi] = torch.einsum("nk,nkf->nf", val[lo:hi], gathered.to(val.dtype))
    return out


def prepare_hub_split_ell(csr: CSR, hub_threshold: int) -> Dict[str, np.ndarray]:
    """Two ELL partitions split by degree (CTA-per-hub analogue)."""
    hub_rows, light_rows = hub_split(csr, hub_threshold)
    aux: Dict[str, np.ndarray] = {"n_rows": csr.n_rows}
    for tag, rows in (("hub", hub_rows), ("light", light_rows)):
        if rows.size:
            part = prepare_row_ell(csr.row_slice(rows))
            aux[f"{tag}_rows"] = rows.astype(np.int64)
            aux[f"{tag}_colind"], aux[f"{tag}_val"] = part["colind"], part["val"]
    return aux


def spmm_hub_split_ell(aux: Dict, b: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((int(aux["n_rows"]), b.shape[1]), dtype=torch.float32,
                      device=b.device)
    for tag in ("hub", "light"):
        if f"{tag}_colind" in aux:
            part = spmm_row_ell(
                {"colind": aux[f"{tag}_colind"], "val": aux[f"{tag}_val"]}, b
            )
            out.index_copy_(0, aux[f"{tag}_rows"], part)
    return out
