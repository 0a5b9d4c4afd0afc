"""Operations and bytes of the GNN cells, counted from shapes.

The work of a call is what its inputs need, whatever implements it: a
sparse call reads its CSR (rowptr, colind and, where it has them, the
edge values) once and each dense operand once, and writes its output
once, all fp32 / int32. The layout a kernel builds (padded tiles, slot
tables) is the kernel's business and is not counted, so a layout that
reads more shows as a lower roofline share. FLOPs: 2·nnz·F for an SpMM
or SDDMM, 4·nnz·D for CSR attention; the row softmax's few operations
per edge are left out.
"""
from __future__ import annotations

from typing import Dict, Tuple

WORD = 4  # bytes of an fp32 value or an int32 index

# op string -> compute kind, as the port names its scheduled ops
# (core/features.py); a backward op on the transpose has the same kind
OP_KIND: Dict[str, str] = {
    "spmm": "spmm", "spmm_bwd_b": "spmm", "spmm_dyn": "spmm", "spmm_bwd_b_dyn": "spmm",
    "sddmm_bwd_x": "spmm", "sddmm_bwd_y": "spmm",
    "attention_bwd_q": "spmm", "attention_bwd_k": "spmm", "attention_bwd_v": "spmm",
    "sddmm": "sddmm", "spmm_bwd_vals": "sddmm",
    "attention_bwd_e": "sddmm", "attention_bwd_p": "sddmm",
    "attention": "attention",
}


def call_work(op: str, f: int, n_rows: int, n_cols: int, nnz: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one scheduled call of ``op`` at width ``f`` on
    an (n_rows x n_cols) pattern with ``nnz`` edges."""
    kind = OP_KIND[op]
    csr = WORD * (n_rows + 1) + WORD * nnz
    if kind == "spmm":  # values read once, B (n_cols x f) in, C (n_rows x f) out
        return 2.0 * nnz * f, csr + WORD * nnz + WORD * f * (n_cols + n_rows)
    if kind == "sddmm":  # X (n_rows x f), Y (n_cols x f) in, one value per edge out
        return 2.0 * nnz * f, csr + WORD * f * (n_rows + n_cols) + WORD * nnz
    # attention: q (n_rows x d), k and v (n_cols x d) in, (n_rows x d) out
    return 4.0 * nnz * f, csr + WORD * f * (2 * n_rows + 2 * n_cols)


def roofline_s(flops: float, nbytes: float, peak_flops: float, peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)


def gat_step_flops(n: int, nnz: int, in_dim: int, d: int) -> float:
    """Model FLOPs of one full-graph training step of one CSR-attention
    layer: the q, k, v projections and their weight gradients (the
    features need none), attention forward (4·nnz·d) and its gradients
    (dP = g V^T, dV = P^T g, dQ = dS K, dK = dS^T Q: 8·nnz·d). The
    backward's recompute of the logits is not model work."""
    proj = 3 * 2.0 * n * in_dim * d
    return 2 * proj + 12.0 * nnz * d
