"""Fused CSR attention (SDDMM -> row softmax -> SpMM in one pass over the
block layout): hand-written CUDA kernels for Hopper, their plain-torch
versions, and the wrappers that pick between them.

Port of repro/kernels/attention_pallas.py. The kernels live in
``csrc/attention.cu`` (built and loaded by kernels/build.py); its header
says what bounds them on an H100 and what the design does about it.

  fused_csr_attention     <- fused_csr_attention     (dense-W: every row
                                                      block walks all W
                                                      slots)
  fused_ragged_attention  <- fused_ragged_attention  (live slots only)

Both compute, per row, softmax(q·kᵀ·scale over the row's edges)·v with
an online softmax over the row block's slots: masked logits are -inf,
a row with no edge (and a row block with only the ragged dummy slot)
outputs 0, and out = acc / max(l, 1e-30). rb = bc = 8, the blocking the
registry offers.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the current stream or raises.
``LAUNCHES`` counts the launches of each kernel (one per wrapper call).
Unlike the Pallas kernels the wrappers take q, k and v unpadded: rows
past their ends read as zero, and ``n_rows`` cuts the padded last row
block off the output.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import CHUNK_ELEMS, chunk_ranges

LAUNCHES: Dict[str, int] = {
    "fused_csr_attention": 0,
    "fused_ragged_attention": 0,
}

RB = BC = 8
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90
# the block keeps the q tile and the accumulator (RB x D each) in shared
# memory, plus the mask, logits and probabilities of one slot and the
# per-row m, l and alpha
SMEM_FLOATS_FIXED = 3 * RB * BC + 3 * RB
MAX_D = (SMEM_LIMIT // 4 - SMEM_FLOATS_FIXED) // (2 * RB)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """csrc/attention.cu, built at first use, with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = build.load("attention")
        lib.autosage_attention.argtypes = [
            _P, _I, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _LL, _F, _P,
        ]
        lib.autosage_attention.restype = _I
        _LIB = lib
    return _LIB


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[1] ** 0.5) if scale is None else float(scale)


# -------------------------------------------------------------- plain
def _tiles(x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """x as (n_blocks, 8, D): rows past x's end read as zero."""
    pad = n_blocks * RB - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return x[: n_blocks * RB].reshape(n_blocks, RB, x.shape[1])


def attention_slots_plain(
    slot_rowblk: torch.Tensor,  # int (S,)
    slot_colblk: torch.Tensor,  # int (S,)
    mask: torch.Tensor,  # f32 (S, 8, 8)
    q: torch.Tensor,  # (n_q, D)
    k: torch.Tensor,  # (n_kv, D)
    v: torch.Tensor,  # (n_kv, D)
    n_row_blocks: int,
    scale: float,
    chunk_elems: int = CHUNK_ELEMS,
) -> torch.Tensor:
    """The fused kernels' function over a slot list, in chunks of slots:
    the exact softmax of each row over its masked logits in two passes
    (row max, then exp-sums and p·v), where the kernels carry an online
    softmax; the two agree up to rounding. Returns (n_row_blocks*8, D)."""
    d = q.shape[1]
    qb = _tiles(q, n_row_blocks)
    n_col_blocks = -(-k.shape[0] // BC)
    kb, vb = _tiles(k, n_col_blocks), _tiles(v, n_col_blocks)
    m = torch.full((n_row_blocks, RB), float("-inf"), device=q.device)
    rows = torch.arange(RB, device=q.device)
    n_slots = slot_colblk.shape[0]

    def logits(lo, hi):
        rb_, cb_ = slot_rowblk[lo:hi].long(), slot_colblk[lo:hi].long()
        lg = torch.bmm(qb[rb_], kb[cb_].transpose(1, 2)) * scale
        return rb_, cb_, torch.where(mask[lo:hi] > 0, lg, float("-inf"))

    for lo, hi in chunk_ranges(n_slots, RB * d, chunk_elems):
        rb_, _, lg = logits(lo, hi)
        idx = (rb_[:, None] * RB + rows).reshape(-1)
        m.view(-1).scatter_reduce_(0, idx, lg.amax(-1).reshape(-1), "amax")
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    l = torch.zeros((n_row_blocks, RB), device=q.device)
    acc = torch.zeros((n_row_blocks, RB, d), device=q.device)
    for lo, hi in chunk_ranges(n_slots, RB * d, chunk_elems):
        rb_, cb_, lg = logits(lo, hi)
        p = torch.exp(lg - m_safe[rb_][:, :, None]) * (mask[lo:hi] > 0)
        l.index_add_(0, rb_, p.sum(-1))
        acc.index_add_(0, rb_, torch.bmm(p, vb[cb_]))
    out = acc / torch.clamp(l, min=1e-30)[:, :, None]
    return out.reshape(n_row_blocks * RB, d)


def fused_ragged_attention_plain(blkptr, slot_colblk, mask, q, k, v, n_rows=None,
                                 scale=None, chunk_elems=CHUNK_ELEMS):
    """Plain version of `fused_ragged_attention`."""
    nrb = blkptr.shape[0] - 1
    slot_rowblk = torch.repeat_interleave(
        torch.arange(nrb, device=blkptr.device), torch.diff(blkptr.long())
    )
    out = attention_slots_plain(slot_rowblk, slot_colblk, mask, q, k, v, nrb,
                                _scale(q, scale), chunk_elems)
    return out[: nrb * RB if n_rows is None else n_rows]


def fused_csr_attention_plain(colblk, mask, q, k, v, n_rows=None, scale=None,
                              chunk_elems=CHUNK_ELEMS):
    """Plain version of `fused_csr_attention`: the dense-W grid is a slot
    list whose padded slots have all-zero masks."""
    nrb, w = colblk.shape
    slot_rowblk = torch.arange(nrb, device=colblk.device).repeat_interleave(w)
    out = attention_slots_plain(slot_rowblk, colblk.reshape(-1),
                                mask.reshape(nrb * w, RB, BC), q, k, v, nrb,
                                _scale(q, scale), chunk_elems)
    return out[: nrb * RB if n_rows is None else n_rows]


# ------------------------------------------------------------ kernels
def _launch(name, blkptr, width, colblk, mask, q, k, v, nrb, n_rows, scale):
    """Shared checks and launch of csrc/attention.cu's kernel."""
    d = q.shape[1]
    n_rows = nrb * RB if n_rows is None else n_rows
    if not 0 <= n_rows <= nrb * RB:
        raise ValueError(f"{name}: n_rows={n_rows} outside [0, {nrb * RB}]")
    if tuple(mask.shape[-2:]) != (RB, BC):
        raise ValueError(f"{name}: mask tiles must be {RB}x{BC}, got {tuple(mask.shape)}")
    if k.shape != v.shape or k.shape[1] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on D")
    if d > MAX_D:
        raise ValueError(f"{name}: D={d} exceeds the {MAX_D} the block's shared "
                         "memory holds")
    out = torch.empty((n_rows, d), dtype=torch.float32, device=q.device)
    if nrb == 0 or d == 0 or n_rows == 0:
        return out
    rc = _lib().autosage_attention(
        None if blkptr is None else blkptr.data_ptr(), width, colblk.data_ptr(),
        mask.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        nrb, q.shape[0], k.shape[0], d, n_rows, _scale(q, scale),
        build.stream_of(q.device),
    )
    build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def fused_ragged_attention(
    blkptr: torch.Tensor,  # int32 (nrb + 1,)
    slot_colblk: torch.Tensor,  # int32 (n_slots,)
    mask: torch.Tensor,  # f32 (n_slots, 8, 8) structural 0/1
    q: torch.Tensor,  # f32 (n_rows, D)
    k: torch.Tensor,  # f32 (n_cols, D)
    v: torch.Tensor,  # f32 (n_cols, D)
    n_rows: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Slot-compacted fused attention over a RaggedBlockELL: returns
    (n_rows, D). One CUDA block per row block walks blkptr[i]..blkptr[i+1]
    in slot order; scale defaults to 1/sqrt(D)."""
    if q.device.type == "cpu":
        return fused_ragged_attention_plain(blkptr, slot_colblk, mask, q, k, v,
                                            n_rows, scale)
    name = "fused_ragged_attention"
    build.check_operands(name, q.device, blkptr=blkptr, slot_colblk=slot_colblk,
                         mask=mask, q=q, k=k, v=v)
    if mask.shape[0] != slot_colblk.shape[0]:
        raise ValueError(f"{name}: {mask.shape[0]} mask tiles for "
                         f"{slot_colblk.shape[0]} slots")
    return _launch(name, blkptr, 0, slot_colblk, mask, q, k, v,
                   blkptr.shape[0] - 1, n_rows, scale)


def fused_csr_attention(
    colblk: torch.Tensor,  # int32 (nrb, W)
    mask: torch.Tensor,  # f32 (nrb, W, 8, 8) structural 0/1, padding 0
    q: torch.Tensor,  # f32 (n_rows, D)
    k: torch.Tensor,  # f32 (n_cols, D)
    v: torch.Tensor,  # f32 (n_cols, D)
    n_rows: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense-W fused attention: every row block walks all W slots with the
    ragged kernel's code, and a slot whose mask is all zero (every padded
    slot) is skipped, so its output equals the ragged kernel's bit for
    bit."""
    if q.device.type == "cpu":
        return fused_csr_attention_plain(colblk, mask, q, k, v, n_rows, scale)
    name = "fused_csr_attention"
    build.check_operands(name, q.device, colblk=colblk, mask=mask, q=q, k=k, v=v)
    nrb, w = colblk.shape
    if tuple(mask.shape[:2]) != (nrb, w):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not match colblk "
                         f"{tuple(colblk.shape)}")
    return _launch(name, None, w, colblk, mask, q, k, v, nrb, n_rows, scale)
