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

The kernels split each row block into chunks of ``chunk_slots(D)`` slots
(or the wrappers' ``cs``) counted from its first slot (``chunk_bounds``); a row block of several
chunks has its chunks' partial states folded in chunk order by a second
kernel over a workspace the wrapper allocates (``attention_chunks_plain``
is that computation in plain torch).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel on the current stream or raises.
``LAUNCHES`` counts the launches of each kernel (one per wrapper call).
Unlike the Pallas kernels the wrappers take q, k and v unpadded: rows
past their ends read as zero, and ``n_rows`` cuts the padded last row
block off the output.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import CHUNK_ELEMS, chunk_ranges

LAUNCHES: Dict[str, int] = {
    "fused_csr_attention": 0,
    "fused_ragged_attention": 0,
}

RB = BC = 8
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on sm_90
# each of a block's 8 warps keeps its q row and accumulator row (D floats
# each) in shared memory
MAX_D = SMEM_LIMIT // (2 * RB * 4)
# slots per chunk of a row block, the unit one block of 8 warps walks
# (csrc/attention.cu's header: why chunks, and why this length)
CHUNK_SLOTS = 256
STATE_FLOATS = 4  # per row and chunk: m, l, a live flag, padding

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
            _P, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P,
            _LL, _LL, _I, _LL, _LL, _I, _LL, _F, _P,
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


def _slot_partials(slot_rowblk, slot_group, slot_colblk, mask, q, k, v, n_row_blocks,
                   n_groups, scale, chunk_elems):
    """Per group of slots (``slot_group``, n_groups of them) and row: the
    max m of its masked logits, l = sum exp(logit - m_safe) and acc = sum
    p·v, in two passes over the slots in chunks; slot s's q tile is row
    block slot_rowblk[s]'s. Returns (m, l, acc) of shapes (n_groups, 8)
    and (n_groups, 8, D)."""
    d = q.shape[1]
    qb = _tiles(q, n_row_blocks)
    n_col_blocks = -(-k.shape[0] // BC)
    kb, vb = _tiles(k, n_col_blocks), _tiles(v, n_col_blocks)
    m = torch.full((n_groups, RB), float("-inf"), device=q.device)
    rows = torch.arange(RB, device=q.device)
    n_slots = slot_colblk.shape[0]

    def logits(lo, hi):
        rb_, cb_ = slot_rowblk[lo:hi].long(), slot_colblk[lo:hi].long()
        lg = torch.bmm(qb[rb_], kb[cb_].transpose(1, 2)) * scale
        return slot_group[lo:hi].long(), cb_, torch.where(mask[lo:hi] > 0, lg, float("-inf"))

    for lo, hi in chunk_ranges(n_slots, RB * d, chunk_elems):
        g_, _, lg = logits(lo, hi)
        idx = (g_[:, None] * RB + rows).reshape(-1)
        m.view(-1).scatter_reduce_(0, idx, lg.amax(-1).reshape(-1), "amax")
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    l = torch.zeros((n_groups, RB), device=q.device)
    acc = torch.zeros((n_groups, RB, d), device=q.device)
    for lo, hi in chunk_ranges(n_slots, RB * d, chunk_elems):
        g_, cb_, lg = logits(lo, hi)
        p = torch.exp(lg - m_safe[g_][:, :, None]) * (mask[lo:hi] > 0)
        l.index_add_(0, g_, p.sum(-1))
        acc.index_add_(0, g_, torch.bmm(p, vb[cb_]))
    return m, l, acc


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
    _, l, acc = _slot_partials(slot_rowblk, slot_rowblk, slot_colblk, mask, q, k, v,
                               n_row_blocks, n_row_blocks, scale, chunk_elems)
    out = acc / torch.clamp(l, min=1e-30)[:, :, None]
    return out.reshape(n_row_blocks * RB, q.shape[1])


# ------------------------------------------------------------- chunks
def chunk_slots(d: int) -> int:
    """Slots per chunk at width d: CHUNK_SLOTS, or d rounded up to a
    multiple of 32 where that is more, so a chunk's partial states
    (8 * (d + 4) floats) stay within about an eighth of the mask tiles (64
    floats a slot) it walks."""
    return max(CHUNK_SLOTS, -(-d // 32) * 32)


def _dense_chunks(width: int, cs: int) -> int:
    """Chunks per row block of a dense-W layout of width ``width``."""
    return max(1, -(-width // cs))


def ragged_chunk_table(blkptr: torch.Tensor, cs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chunk_ptr, ws_ptr), int32 (nrb + 1,), on blkptr's device and
    without reading it back: row block i owns chunks chunk_ptr[i] ..
    chunk_ptr[i + 1] - 1, max(1, ceil(slots / cs)) of them, and, when it
    has more than one, the workspace entries from ws_ptr[i] on (a row
    block of one chunk writes its output directly)."""
    nch = torch.clamp(torch.div(torch.diff(blkptr.long()) + (cs - 1), cs,
                                rounding_mode="floor"), min=1)
    ptrs = torch.zeros((2, nch.shape[0] + 1), dtype=torch.int64, device=blkptr.device)
    torch.cumsum(nch, 0, out=ptrs[0, 1:])
    torch.cumsum(torch.where(nch > 1, nch, 0), 0, out=ptrs[1, 1:])
    return ptrs[0].int(), ptrs[1].int()


def chunk_bounds(blkptr: Optional[torch.Tensor], width: int, n_row_blocks: int, cs: int,
                 device: Optional[torch.device] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row block, first slot, end slot) of every chunk, int64, in the
    order the kernel numbers its blocks: chunk c of row block i covers
    slots c*cs .. (c+1)*cs - 1 counted from the row block's first slot,
    cut at its last. Ragged when blkptr is given, else dense-W of width
    ``width`` (row block i's slots start at i*width) on ``device``."""
    if blkptr is not None:
        chunk_ptr = ragged_chunk_table(blkptr, cs)[0].long()
        b = torch.arange(int(chunk_ptr[-1]), device=blkptr.device)
        i = torch.searchsorted(chunk_ptr, b, right=True) - 1
        s_row, s_end = blkptr.long()[i], blkptr.long()[i + 1]
        c = b - chunk_ptr[i]
    else:
        n_ch = _dense_chunks(width, cs)
        b = torch.arange(n_row_blocks * n_ch, device=device)
        i, c = b // n_ch, b % n_ch
        s_row = i * width
        s_end = s_row + width
    s0 = s_row + c * cs
    return i, s0, torch.minimum(s0 + cs, s_end)


def attention_chunks_plain(blkptr, width, colblk, mask, q, k, v, n_rows=None, scale=None,
                           cs=None, chunk_elems=CHUNK_ELEMS):
    """The kernels' chunked computation in plain torch: each chunk's
    partial (m, l, acc) per row (two-pass within the chunk, where the
    kernel's is online), then, per row, its chunks folded in chunk order
    as attention_combine_kernel folds them (the first live chunk as it
    is, each later live one rescaled; chunks without a live cell left
    out) and out = acc / max(l, 1e-30). Ragged when blkptr is given
    (colblk and mask per slot), else dense-W (colblk (nrb, W), mask (nrb,
    W, 8, 8)). ``cs`` defaults to chunk_slots(D)."""
    cs = chunk_slots(q.shape[1]) if cs is None else cs
    if blkptr is None:
        nrb = colblk.shape[0]
        colblk, mask = colblk.reshape(-1), mask.reshape(-1, RB, BC)
    else:
        nrb = blkptr.shape[0] - 1
    dev = q.device
    rowblk, s0, s1 = chunk_bounds(blkptr, width, nrb, cs, dev)
    n_ch, size = rowblk.shape[0], s1 - s0
    slot_chunk = torch.repeat_interleave(torch.arange(n_ch, device=dev), size)
    # each chunk's slots s0 .. s1 - 1, the chunks in order
    first_pos = torch.cumsum(size, 0) - size
    slots = torch.arange(int(size.sum()), device=dev) - torch.repeat_interleave(
        first_pos - s0, size)
    mk = mask[slots]
    m, l, acc = _slot_partials(rowblk[slot_chunk], slot_chunk, colblk[slots], mk, q, k, v,
                               nrb, n_ch, _scale(q, scale), chunk_elems)
    live = torch.zeros((n_ch, RB), dtype=torch.int32, device=dev).index_add_(
        0, slot_chunk, (mk > 0).any(-1).int()) > 0
    first = torch.searchsorted(rowblk, torch.arange(nrb, device=dev))  # chunk 0 of each
    n_of = torch.bincount(rowblk, minlength=nrb)
    fm = torch.full((nrb, RB), float("-inf"), device=dev)
    fl = torch.zeros((nrb, RB), device=dev)
    fa = torch.zeros((nrb, RB, q.shape[1]), device=dev)
    started = torch.zeros((nrb, RB), dtype=torch.bool, device=dev)
    for c in range(int(n_of.max()) if nrb else 0):
        has = c < n_of
        e = torch.where(has, first + c, 0)
        on = live[e] & has[:, None]
        mc, lc, ac = m[e], l[e], acc[e]
        m_new = torch.maximum(fm, mc)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        ea = torch.where(torch.isfinite(fm), torch.exp(fm - m_safe), 0.0)
        eb = torch.where(torch.isfinite(mc), torch.exp(mc - m_safe), 0.0)
        take, fold = on & ~started, on & started
        fl = torch.where(take, lc, torch.where(fold, ea * fl + eb * lc, fl))
        fa = torch.where(take[..., None], ac,
                         torch.where(fold[..., None], ea[..., None] * fa + eb[..., None] * ac,
                                     fa))
        fm = torch.where(take, mc, torch.where(fold, m_new, fm))
        started |= on
    out = (fa / torch.clamp(fl, min=1e-30)[:, :, None]).reshape(nrb * RB, q.shape[1])
    return out[: nrb * RB if n_rows is None else n_rows]


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
def _launch(name, blkptr, width, colblk, mask, q, k, v, nrb, n_rows, scale, cs):
    """Shared checks, chunk tables, workspace and launch of
    csrc/attention.cu's kernels."""
    d = q.shape[1]
    cs = chunk_slots(d) if cs is None else cs
    if not 1 <= cs < 2 ** 31:
        raise ValueError(f"{name}: cs={cs} slots per chunk outside [1, 2**31)")
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
    chunk_ptr = ws_ptr = None
    if blkptr is None:
        n_ch = _dense_chunks(width, cs)
        n_blocks = nrb * n_ch
        n_ws = n_blocks if n_ch > 1 else 0
    else:
        # bounds that need no read-back of blkptr: sum max(1, ceil(n/cs))
        # <= nrb + n_slots // cs chunks, and the row blocks of more than
        # one chunk hold at most 2 * (n_slots // cs) of them
        n_slots = mask.shape[0]
        chunk_ptr, ws_ptr = ragged_chunk_table(blkptr, cs)
        n_blocks = nrb + n_slots // cs
        n_ws = 2 * (n_slots // cs) if n_slots > cs else 0
    ws_state = ws_acc = None
    if n_ws:
        ws_state = torch.empty((n_ws, RB, STATE_FLOATS), dtype=torch.float32, device=q.device)
        ws_acc = torch.empty((n_ws, RB, d), dtype=torch.float32, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _lib().autosage_attention(
        ptr(blkptr), ptr(chunk_ptr), ptr(ws_ptr), width, colblk.data_ptr(),
        mask.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ptr(ws_state), ptr(ws_acc), nrb, n_blocks, cs, q.shape[0], k.shape[0], d, n_rows,
        _scale(q, scale), build.stream_of(q.device),
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
    cs: Optional[int] = None,
) -> torch.Tensor:
    """Slot-compacted fused attention over a RaggedBlockELL: returns
    (n_rows, D). One CUDA block of 8 warps per chunk of ``cs`` slots of a
    row block (default chunk_slots(D)), the chunks of split row blocks
    folded in chunk order; scale defaults to 1/sqrt(D). The plain version
    (CPU tensors) does not chunk."""
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
                   blkptr.shape[0] - 1, n_rows, scale, cs)


def fused_csr_attention(
    colblk: torch.Tensor,  # int32 (nrb, W)
    mask: torch.Tensor,  # f32 (nrb, W, 8, 8) structural 0/1, padding 0
    q: torch.Tensor,  # f32 (n_rows, D)
    k: torch.Tensor,  # f32 (n_cols, D)
    v: torch.Tensor,  # f32 (n_cols, D)
    n_rows: Optional[int] = None,
    scale: Optional[float] = None,
    cs: Optional[int] = None,
) -> torch.Tensor:
    """Dense-W fused attention: every row block walks all W slots, in the
    same chunks of ``cs`` slots as the ragged kernel and with its code; a
    slot without a live cell (every padded slot) is skipped, so its
    output equals the ragged kernel's at the same ``cs`` bit for bit."""
    if q.device.type == "cpu":
        return fused_csr_attention_plain(colblk, mask, q, k, v, n_rows, scale)
    name = "fused_csr_attention"
    build.check_operands(name, q.device, colblk=colblk, mask=mask, q=q, k=k, v=v)
    nrb, w = colblk.shape
    if tuple(mask.shape[:2]) != (nrb, w):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not match colblk "
                         f"{tuple(colblk.shape)}")
    return _launch(name, None, w, colblk, mask, q, k, v, nrb, n_rows, scale, cs)
