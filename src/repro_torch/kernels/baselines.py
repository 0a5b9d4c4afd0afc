"""Library-op variants: the guardrail baselines and the other candidates
that run on any device — SpMM, the SDDMM and softmax stages, and the
composed SDDMM -> row-softmax -> SpMM attention pipelines.

Port of repro/kernels/xla.py. The JAX package runs these in plain XLA
outside any Pallas kernel, so the port runs them as plain torch ops.
Each variant is a host-side ``prepare`` (format conversion, done once
and amortized) plus a ``run`` on device tensors. The gathers work in row
chunks (see kernels/ref.py) to keep memory bounded: the row-ELL
(n, K, D) gather alone would be 235 GB at n = 58,241, K = 3,936,
D = 256.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import CHUNK_ELEMS, chunk_ranges
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
    for lo, hi in chunk_ranges(n, k * b.shape[1]):
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


# --------------------------------------------------------------- SDDMM
def sddmm_gather_dot(aux: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Paper's SDDMM baseline: gather both sides, dot."""
    return ref.sddmm_ref(aux["rowptr"], aux["colind"], x, y)


def sddmm_row_ell(aux: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-ELL SDDMM: (n, K) uniform gather; returns the padded (n, K)
    values (ELL layout, converted back where CSR layout is needed)."""
    colind, val = aux["colind"], aux["val"]
    n, k = colind.shape
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    for lo, hi in chunk_ranges(n, k * x.shape[1]):
        gathered = y[colind[lo:hi].long()]  # (rows, K, F)
        out[lo:hi] = torch.einsum("nf,nkf->nk", x[lo:hi].to(gathered.dtype), gathered)
    return out * (val != 0)


def sddmm_row_ell_csr(aux: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-ELL SDDMM gathered back to the CSR-ordered nnz vector (the
    registry's ``row_ell`` SDDMM variant: ``ell_colind``/``ell_val``
    beside the CSR arrays)."""
    ell = sddmm_row_ell({"colind": aux["ell_colind"], "val": aux["ell_val"]}, x, y)
    return ell[aux["edge_row"].long(), aux["edge_slot"].long()]


# ------------------------------------------ dynamic-values SpMM (grads)
# Runtime-valued SpMM for the backward ops (core/autodiff.py): the sparse
# values are a cotangent that changes every step, so prepare converts the
# structure once and each call places the nnz-vector into the layout.
def prepare_csr_structural(csr: CSR) -> Dict[str, np.ndarray]:
    return {
        "rowptr": np.asarray(csr.rowptr, np.int32),
        "colind": np.asarray(csr.colind, np.int32),
    }


def spmm_gather_dyn(aux: Dict, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Baseline: gather + deterministic segment-sum with runtime values."""
    return ref.spmm_ref(aux["rowptr"], aux["colind"], vals, b)


def prepare_row_ell_dyn(csr: CSR) -> Dict[str, np.ndarray]:
    s = csr.structural()
    return {"colind": prepare_row_ell(s)["colind"], **prepare_edge_slots(s)}


def spmm_row_ell_dyn(aux: Dict, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-ELL SpMM with a per-call scatter: each edge owns one (row,
    slot) cell, so duplicates keep distinct cells and a plain assignment
    keeps accumulate-on-duplicate SpMM semantics."""
    table = vals.new_zeros(aux["colind"].shape, dtype=torch.float32)
    table[aux["edge_row"].long(), aux["edge_slot"].long()] = vals.to(torch.float32)
    return spmm_row_ell({"colind": aux["colind"], "val": table}, b)


def row_softmax(aux: Dict, val: torch.Tensor) -> torch.Tensor:
    return ref.row_softmax_ref(aux["rowptr"], aux["colind"], val)


# ------------------------------------------- composed attention pipelines
# The joint "attention" decide (core/pipeline.py) selects among these whole
# SDDMM -> row-softmax -> SpMM compositions; each stays in one sparse
# layout per stage, with explicit layout conversion for mixed pairs.
def prepare_edge_slots(csr: CSR) -> Dict[str, np.ndarray]:
    """(row, slot-within-row) of every nnz entry — the scatter/gather
    indices that convert per-edge CSR values to/from the (n, K) ELL table."""
    deg = csr.degrees
    rows = np.repeat(np.arange(csr.n_rows), deg).astype(np.int32)
    slot = (np.arange(csr.nnz) - np.repeat(csr.rowptr[:-1], deg)).astype(np.int32)
    return {"edge_row": rows, "edge_slot": slot}


def ell_masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row softmax over the (n, K) ELL table; padded slots -> 0."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, neg)
    m = masked.amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(masked - m) * mask
    return e / torch.clamp(e.sum(dim=1, keepdim=True), min=1e-30)


def _ell_probs(colind, val, q, k, lo, hi):
    """Row-ELL SDDMM + ELL softmax for rows lo:hi (rows are independent)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    gathered = k[colind[lo:hi].long()]  # (rows, K, D)
    logits = torch.einsum("nf,nkf->nk", q[lo:hi].to(gathered.dtype), gathered) * scale
    return ell_masked_softmax(logits, val[lo:hi] != 0)


def _edge_range(aux: Dict, lo: int, hi: int) -> tuple:
    """CSR edge range of rows lo:hi (edge_row is sorted)."""
    return int(aux["rowptr"][lo]), int(aux["rowptr"][hi])


def attention_csr(aux: Dict, q, k, v, chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """gather_dot SDDMM -> CSR softmax -> gather_segsum SpMM (baseline)."""
    return ref.csr_attention_ref(aux["rowptr"], aux["colind"], q, k, v,
                                 chunk_elems=chunk_elems)


def attention_ell(aux: Dict, q, k, v, chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """row_ell SDDMM -> ELL softmax -> row_ell SpMM; uniform-width gathers
    throughout (wins when degree variance is low, as with spmm row_ell)."""
    colind, val = aux["colind"], aux["val"]
    n, kk = colind.shape
    out = torch.empty((n, v.shape[1]), dtype=torch.float32, device=q.device)
    for lo, hi in chunk_ranges(n, kk * q.shape[1], chunk_elems):
        probs = _ell_probs(colind, val, q, k, lo, hi)
        out[lo:hi] = torch.einsum("nk,nkf->nf", probs,
                                  v[colind[lo:hi].long()].to(probs.dtype))
    return out


def attention_ell_to_csr(aux: Dict, q, k, v, chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """row_ell SDDMM/softmax -> (ELL->CSR gather) -> gather_segsum SpMM."""
    colind, val = aux["ell_colind"], aux["ell_val"]
    n, kk = colind.shape
    probs_csr = torch.empty(aux["colind"].shape[0], dtype=torch.float32, device=q.device)
    for lo, hi in chunk_ranges(n, kk * q.shape[1], chunk_elems):
        probs = _ell_probs(colind, val, q, k, lo, hi)
        e_lo, e_hi = _edge_range(aux, lo, hi)
        er = aux["edge_row"][e_lo:e_hi].long() - lo
        probs_csr[e_lo:e_hi] = probs[er, aux["edge_slot"][e_lo:e_hi].long()]
    return ref.spmm_ref(aux["rowptr"], aux["colind"], probs_csr, v, chunk_elems)


def attention_csr_to_ell(aux: Dict, q, k, v, chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """gather_dot SDDMM/softmax -> (CSR->ELL scatter) -> row_ell SpMM."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = ref.sddmm_ref(aux["rowptr"], aux["colind"], q, k, chunk_elems) * scale
    probs = ref.row_softmax_ref(aux["rowptr"], aux["colind"], logits)
    colind = aux["ell_colind"]  # (n, K)
    n, kk = colind.shape
    out = torch.empty((n, v.shape[1]), dtype=torch.float32, device=q.device)
    for lo, hi in chunk_ranges(n, kk * v.shape[1], chunk_elems):
        e_lo, e_hi = _edge_range(aux, lo, hi)
        table = probs.new_zeros((hi - lo, kk))
        table[aux["edge_row"][e_lo:e_hi].long() - lo,
              aux["edge_slot"][e_lo:e_hi].long()] = probs[e_lo:e_hi]
        out[lo:hi] = torch.einsum("nk,nkf->nf", table,
                                  v[colind[lo:hi].long()].to(table.dtype))
    return out
