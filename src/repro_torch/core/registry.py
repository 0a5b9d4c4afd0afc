"""Kernel-variant registry: the candidate pools the scheduler picks
from, for SpMM, SDDMM, the runtime-valued SpMM of the backward ops and
CSR attention.

Port of repro/core/registry.py. A Variant bundles

  prepare(csr) -> aux dict             host-side format conversion
                                       (numpy), amortized
  build(aux, device) -> run(b)         uploads aux to ``device`` and
                                       returns the timed/chosen runner
  applicable(feat, hw) -> bool         hard constraints

The library-op variants (kernels/baselines.py) always join the pool;
``gather_segsum`` (SpMM, static or runtime values), ``gather_dot``
(SDDMM) and the composed ``pipe[sddmm=gather_dot, spmm=gather_segsum]``
(attention) are the guardrail baselines. The hand-written CUDA kernels
(kernels/spmm.py, kernels/sddmm.py, kernels/attention.py) join it on a
CUDA device, or on the CPU when AUTOSAGE_PROBE_PALLAS=1, where they run
their plain versions. Backward ops draw the pool of their compute kind
(features.op_kind): "spmm_bwd_b" SpMM candidates on the transpose,
"attention_bwd_e" SDDMM candidates, "attention_bwd_q" the runtime-valued
SpMM family, whose runners take (vals, b). The legacy per-op
"csr_attention" op draws the attention pool, as in the JAX package: its
keys predate the pipeline scheduler, so estimate.py costs none of its
candidates and `AutoSage.decide` serves the baseline through the
resilience rescue, while a cached legacy entry that pins a fused kernel
replays it.

The memory gates compare the JAX package's layout-size expressions
against ``HardwareSpec.layout_budget_bytes``: 512 MB on the CPU profiles
(so the CPU candidate lists equal the JAX package's) and half the card's
memory on an H100, where the JAX package's TPU-sized 512 MB would shut
every block kernel out of Reddit-scale graphs. The merge-path gates are
the int32 bound of the merge table (the Pallas gate, whole panels
resident in VMEM, has no counterpart in the CUDA design).

Ragged layouts come from a small process-level memo keyed by the graph's
structure, its values and the blocking (`ragged_layout`): a training
step prepares the same structure for several ops (the forward, two
SDDMMs and a runtime-valued SpMM of attention's backward), and the JAX
package converts it anew for each, about 20 s of host numpy per
conversion at Reddit-0.25. The memo changes no decision and no output.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faultinject, obs
from repro_torch.core.features import (
    HardwareSpec,
    InputFeatures,
    op_dynamic_vals,
    op_kind,
)
from repro_torch.kernels import attention as ka
from repro_torch.kernels import baselines as kb
from repro_torch.kernels import sddmm as ksd
from repro_torch.kernels import spmm as ks
from repro_torch.sparse.bsr import (
    RaggedBlockELL,
    block_ell_edge_index,
    csr_to_block_ell,
    csr_to_ragged,
    hub_split,
)
from repro_torch.sparse.csr import CSR, graph_signature
from repro_torch.sparse.merge import merge_tiling

# variant name -> the repro (JAX) family it ports; estimate.py costs each
# variant with its family's model, and the parity tests pair them up
PORTED_FROM = {
    "gather_segsum": "gather_segsum",
    "gather_dot": "gather_dot",
    "dense": "dense",
    "row_ell": "row_ell",
    "hub_split_ell": "hub_split_ell",
    "block_ell_cuda": "block_ell_pallas",
    "ragged_ell_cuda": "ragged_ell_pallas",
    "merge_path_cuda": "merge_path_pallas",
    "hub_ragged_cuda": "hub_ragged_pallas",
    "pipe": "pipe",
    "fused_attention_cuda": "fused_attention_pallas",
    "ragged_attention_cuda": "ragged_attention_pallas",
}

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class Variant:
    name: str
    op: str
    prepare: Callable[..., Dict]
    build: Callable[[Dict, torch.device], Callable]
    applicable: Callable[[InputFeatures, HardwareSpec], bool]
    knobs: Dict = dataclasses.field(default_factory=dict)
    is_baseline: bool = False

    def full_name(self) -> str:
        if not self.knobs:
            return self.name
        ks_ = ",".join(f"{k}={v}" for k, v in sorted(self.knobs.items()))
        return f"{self.name}[{ks_}]"

    def timed_prepare(self, csr: CSR) -> Dict:
        """prepare() with its host-side cost accounted to
        ``autosage_prepare_ms{op,variant}``."""
        faultinject.fault_point("prepare", name=self.full_name(), op=self.op)
        t0 = time.perf_counter()
        aux = self.prepare(csr)
        obs.REGISTRY.observe(
            "autosage_prepare_ms", (time.perf_counter() - t0) * 1e3,
            op=self.op, variant=self.name,
        )
        return aux


# ------------------------------------------------- host layout memo
_LAYOUTS: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
LAYOUT_MEMO_CAP = 4  # entries; one is ~5.4 GB at Reddit-0.25, 8x8
# smaller graphs convert in well under a second and stay out of the
# memo, so the probes' induced subgraphs never evict a full graph
LAYOUT_MEMO_MIN_NNZ = 4_000_000


def _values_key(csr: CSR) -> str:
    if csr.val is None:
        return "structural"
    return hashlib.sha256(np.ascontiguousarray(csr.val).tobytes()).hexdigest()[:16]


def ragged_layout(csr: CSR, rb: int, bc: int) -> Tuple[RaggedBlockELL, float, Dict]:
    """`csr_to_ragged(csr, rb, bc)`, memoized per (structure, values,
    blocking) for graphs of LAYOUT_MEMO_MIN_NNZ edges or more, LRU over
    LAYOUT_MEMO_CAP entries. Callers share the arrays and must not write
    to them."""
    if csr.nnz < LAYOUT_MEMO_MIN_NNZ:
        return csr_to_ragged(csr, rb, bc)
    key = (graph_signature(csr), _values_key(csr), rb, bc)
    hit = _LAYOUTS.pop(key, None)
    if hit is None:
        hit = csr_to_ragged(csr, rb, bc)
        while len(_LAYOUTS) >= max(LAYOUT_MEMO_CAP, 1):
            _LAYOUTS.popitem(last=False)
    _LAYOUTS[key] = hit
    return hit


def clear_layout_memo() -> None:
    _LAYOUTS.clear()


def _mask_of(tiles: np.ndarray) -> np.ndarray:
    """The structural 0/1 mask of a structural layout's tiles (which count
    edges per cell): the tiles themselves when no cell holds a duplicate
    edge (no second full-size host copy: the dense-W table is 13.6 GB at
    Reddit-0.25), else a clipped copy — never a write to a shared table."""
    if tiles.size == 0 or tiles.max() <= 1.0:
        return tiles
    return np.minimum(tiles, 1.0)


def _edge_flat(edges: Dict, rb: int, bc: int) -> np.ndarray:
    """int64 flat cell index of every CSR edge in a (slots, rb, bc) table."""
    return (edges["edge_slot"].astype(np.int64) * rb + edges["edge_r"]) * bc + edges["edge_c"]


def _dev(aux: Dict, device: torch.device) -> Dict:
    """Upload every numpy array of a prepared aux dict to ``device``."""
    return {
        k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
        for k, v in aux.items()
    }


def _ell_applicable(f: InputFeatures) -> bool:
    """Row-ELL gates: padding explodes under skew, and the padded table
    must fit memory."""
    return (f.deg_max <= max(32.0, 8 * max(f.avg_deg, 1.0))
            and f.n_rows * f.deg_max <= 512_000_000)


def _hub_threshold(feat: InputFeatures) -> int:
    return int(os.environ.get("AUTOSAGE_HUB_T", feat.hub_threshold()))


# --------------------------------------------------- library-op SpMM
def _spmm_variants(feat: InputFeatures) -> List[Variant]:
    hub_t = _hub_threshold(feat)

    def runner(fn):
        return lambda aux, device: (lambda b, a=_dev(aux, device): fn(a, b))

    return [
        Variant(
            name="gather_segsum",
            op="spmm",
            prepare=kb.prepare_csr,
            build=runner(kb.spmm_gather_segsum),
            applicable=lambda f, hw: True,
            is_baseline=True,
        ),
        Variant(
            name="dense",
            op="spmm",
            prepare=kb.prepare_dense,
            build=runner(kb.spmm_dense),
            # densify only small AND genuinely dense-ish A
            applicable=lambda f, hw: f.n_rows * f.n_cols <= 64_000_000
            and f.density > 0.02,
        ),
        Variant(
            name="row_ell",
            op="spmm",
            prepare=kb.prepare_row_ell,
            build=runner(kb.spmm_row_ell),
            applicable=lambda f, hw: _ell_applicable(f),
        ),
        Variant(
            name="hub_split_ell",
            op="spmm",
            prepare=lambda csr, t=hub_t: kb.prepare_hub_split_ell(csr, t),
            build=runner(kb.spmm_hub_split_ell),
            # heavy tail: a small set of rows dominates the work
            applicable=lambda f, hw: f.deg_max > 4 * max(f.avg_deg, 1.0)
            and f.deg_max > 2 * max(f.deg_p50, 1.0),
            knobs={"hub_threshold": hub_t},
        ),
    ]


# ------------------------------------------------- hand-kernel SpMM
def _prep_block_ell(csr: CSR, rb: int, bc: int, ragged: bool) -> Dict:
    if ragged:
        rag, padding_frac, _ = ragged_layout(csr, rb, bc)
        return {"n_rows": csr.n_rows, "padding_frac": padding_frac,
                "blkptr": rag.blkptr, "slot_colblk": rag.slot_colblk,
                "slot_vals": rag.slot_vals}
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    return {"n_rows": csr.n_rows, "padding_frac": bell.padding_frac,
            "colblk": bell.colblk, "vals": bell.vals}


def _build_block_ell(aux: Dict, device: torch.device, ragged: bool) -> Callable:
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    if ragged:
        return lambda b: ks.spmm_ragged_ell(
            dev["blkptr"], dev["slot_colblk"], dev["slot_vals"], b, n_rows=n
        )
    return lambda b: ks.spmm_block_ell(dev["colblk"], dev["vals"], b, n_rows=n)


def _pad_slots(a: np.ndarray, n_padded: int) -> np.ndarray:
    """a with zero slots appended up to n_padded (the merge tail)."""
    pad = n_padded - a.shape[0]
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) if pad else a


def _merge_aux(csr: CSR, tile_slots: int) -> Tuple[Dict, RaggedBlockELL, Dict]:
    """The merge-path tiling of csr's 8x8 ragged layout: blkptr, the
    tail-padded slot_colblk and the tile start coordinates."""
    rag, padding_frac, edges = ragged_layout(csr, 8, 8)
    tiling = merge_tiling(rag.blkptr, rag.n_slots, tile_slots)
    n_tiles = tiling["tile_rowblk"].shape[0]
    aux = {
        "n_rows": csr.n_rows, "n_slots": rag.n_slots, "n_tiles": n_tiles,
        "tile_slots": tile_slots, "padding_frac": padding_frac,
        "blkptr": rag.blkptr,
        "slot_colblk": _pad_slots(rag.slot_colblk, n_tiles * tile_slots),
        "tile_rowblk": tiling["tile_rowblk"], "tile_offset": tiling["tile_offset"],
    }
    return aux, rag, edges


def _prep_merge(csr: CSR, tile_slots: int) -> Dict:
    aux, rag, _ = _merge_aux(csr, tile_slots)
    aux["tile_vals"] = _pad_slots(rag.slot_vals, aux["n_tiles"] * tile_slots).reshape(
        aux["n_tiles"], tile_slots, 8, 8)
    return aux


def _build_merge(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    n, n_slots = int(aux["n_rows"]), int(aux["n_slots"])
    return lambda b: ks.spmm_merge_path(
        dev["blkptr"], dev["slot_colblk"], dev["tile_rowblk"],
        dev["tile_offset"], dev["tile_vals"], b, n_slots, n_rows=n,
    )


def _prep_hub_ragged(csr: CSR, hub_t: int) -> Dict:
    """Hub-split x ragged: each degree partition gets its own slot-
    compacted layout."""
    aux: Dict = {"n_rows": csr.n_rows}
    for tag, rows in zip(("hub", "light"), hub_split(csr, hub_t)):
        if rows.size == 0:
            continue
        bell = csr_to_block_ell(csr, rb=8, bc=8, rows=rows)
        rag = bell.to_ragged()
        aux.update({
            f"{tag}_blkptr": rag.blkptr,
            f"{tag}_slot_colblk": rag.slot_colblk,
            f"{tag}_slot_vals": rag.slot_vals,
            f"{tag}_rows": rows.astype(np.int64),
            f"{tag}_padding_frac": bell.padding_frac,
        })
    return aux


def _build_hub_ragged(aux: Dict, device: torch.device) -> Callable:
    """Two ragged launches, then one row index_copy_ per partition."""
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    tags = [t for t in ("hub", "light") if f"{t}_rows" in dev]

    def run(b):
        out = torch.empty((n, b.shape[1]), dtype=torch.float32, device=b.device)
        for tag in tags:
            rows = dev[f"{tag}_rows"]
            part = ks.spmm_ragged_ell(
                dev[f"{tag}_blkptr"], dev[f"{tag}_slot_colblk"],
                dev[f"{tag}_slot_vals"], b, n_rows=rows.shape[0],
            )
            out.index_copy_(0, rows, part)
        return out

    return run


def _cuda_spmm_variants(feat: InputFeatures) -> List[Variant]:
    """Dense-W, ragged, merge-path and hub-split x ragged SpMM on the
    hand-written kernels. The Pallas merge-path gate (whole panels
    resident in VMEM) does not apply: the CUDA design keeps no panel, so
    the gate is the int32 bound on the merge table's slot indices."""
    out = []
    for ragged in (False, True):
        rbcs = ((8, 8), (16, 8), (8, 16)) if ragged else ((8, 8), (16, 8))
        for rb, bc in rbcs:
            out.append(Variant(
                name="ragged_ell_cuda" if ragged else "block_ell_cuda",
                op="spmm",
                prepare=lambda csr, rb=rb, bc=bc, r=ragged: _prep_block_ell(csr, rb, bc, r),
                build=lambda aux, device, r=ragged: _build_block_ell(aux, device, r),
                applicable=lambda f, hw: f.f >= 32,
                knobs={"rb": rb, "bc": bc, **({"ragged": True} if ragged else {})},
            ))
    for tile_slots in (8, 16):
        out.append(Variant(
            name="merge_path_cuda",
            op="spmm",
            prepare=lambda csr, ts=tile_slots: _prep_merge(csr, ts),
            build=_build_merge,
            applicable=lambda f, hw, ts=tile_slots: f.f >= 32
            and f.nnz + f.n_row_blocks8() + ts <= _INT32_MAX,
            knobs={"rb": 8, "bc": 8, "tile_slots": tile_slots, "ragged": True},
        ))
    hub_t = _hub_threshold(feat)
    out.append(Variant(
        name="hub_ragged_cuda",
        op="spmm",
        prepare=lambda csr, t=hub_t: _prep_hub_ragged(csr, t),
        build=_build_hub_ragged,
        applicable=lambda f, hw: f.f >= 32 and f.deg_max > 4 * max(f.avg_deg, 1.0),
        knobs={"rb": 8, "bc": 8, "ragged": True, "hub_threshold": hub_t},
    ))
    return out


# ------------------------------------------------ dynamic-values SpMM
# Runtime-valued SpMM for the backward ops (core/autodiff.py): attention
# and SDDMM backwards scatter the cotangent through the sparsity pattern,
# so the sparse values change every step and cannot be baked into the
# prepared layout. These runners take (vals, b): prepare converts the
# structure once (memoized), and each call places the nnz-vector into
# the layout's value table on the device.
def _dyn_scatter(csr: CSR, edges: Dict, rb: int, bc: int) -> Dict:
    """Per-edge placement into a (slots, rb, bc) table: ``edge_flat`` (the
    cell of every edge) on a graph without duplicate edges; on a
    multigraph the edges sorted by cell (``dup_perm``), the distinct cells
    (``dup_cells``) and how many edges each holds (``dup_counts``), so the
    duplicates are summed by a segment sum in edge order and two runs
    give the same bits (an accumulating scatter would use atomics)."""
    flat = _edge_flat(edges, rb, bc)
    if not csr.has_duplicate_edges():
        return {"edge_flat": flat}
    perm = np.argsort(flat, kind="stable")
    cells, counts = np.unique(flat[perm], return_counts=True)
    return {"dup_perm": perm, "dup_cells": cells, "dup_counts": counts}


def _scatter_vals(dev: Dict, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The flat (n_cells,) value table of one call."""
    table = torch.zeros(n_cells, dtype=torch.float32, device=vals.device)
    vals = vals.to(torch.float32)
    if "edge_flat" in dev:
        table[dev["edge_flat"]] = vals
    elif dev["dup_cells"].numel():
        sums = torch.segment_reduce(vals[dev["dup_perm"]], "sum", lengths=dev["dup_counts"])
        table[dev["dup_cells"]] = sums
    return table


def _spmm_dyn_variants(feat: InputFeatures) -> List[Variant]:
    def runner(fn):
        return lambda aux, device: (lambda vals, b, a=_dev(aux, device): fn(a, vals, b))

    return [
        Variant(
            name="gather_segsum",
            op=feat.op,
            prepare=kb.prepare_csr_structural,
            build=runner(kb.spmm_gather_dyn),
            applicable=lambda f, hw: True,
            is_baseline=True,
        ),
        Variant(
            name="row_ell",
            op=feat.op,
            prepare=kb.prepare_row_ell_dyn,
            build=runner(kb.spmm_row_ell_dyn),
            applicable=lambda f, hw: _ell_applicable(f),
        ),
    ]


def _prep_ragged_dyn(csr: CSR, rb: int, bc: int) -> Dict:
    s_csr = csr.structural()
    rag, padding_frac, edges = ragged_layout(s_csr, rb, bc)
    return {
        "rb": rb, "bc": bc, "n_rows": csr.n_rows, "n_slots": rag.n_slots,
        "padding_frac": padding_frac, "blkptr": rag.blkptr,
        "slot_colblk": rag.slot_colblk, **_dyn_scatter(s_csr, edges, rb, bc),
    }


def _build_ragged_dyn(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    rb, bc, n, n_slots = aux["rb"], aux["bc"], int(aux["n_rows"]), int(aux["n_slots"])

    def run(vals, b):
        slot_vals = _scatter_vals(dev, vals, n_slots * rb * bc).reshape(n_slots, rb, bc)
        return ks.spmm_ragged_ell(dev["blkptr"], dev["slot_colblk"], slot_vals, b,
                                  n_rows=n)

    return run


def _prep_merge_dyn(csr: CSR) -> Dict:
    s_csr = csr.structural()
    aux, _, edges = _merge_aux(s_csr, 8)
    return {**aux, **_dyn_scatter(s_csr, edges, 8, 8)}


def _build_merge_dyn(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    n, n_slots = int(aux["n_rows"]), int(aux["n_slots"])
    n_tiles, ts = int(aux["n_tiles"]), int(aux["tile_slots"])

    def run(vals, b):
        tile_vals = _scatter_vals(dev, vals, n_tiles * ts * 64).reshape(n_tiles, ts, 8, 8)
        return ks.spmm_merge_path(dev["blkptr"], dev["slot_colblk"], dev["tile_rowblk"],
                                  dev["tile_offset"], tile_vals, b, n_slots, n_rows=n)

    return run


def _cuda_spmm_dyn_variants(feat: InputFeatures) -> List[Variant]:
    """Ragged (8x8, 16x8) and merge-path (tile_slots 8) SpMM on the
    hand-written kernels with a per-call value scatter; the block-ELL edge
    index maps each CSR edge to its (slot, r, c) cell, and duplicates add
    up as in the segment-sum baseline."""
    out = []
    for rb, bc in ((8, 8), (16, 8)):
        out.append(Variant(
            name="ragged_ell_cuda",
            op=feat.op,
            prepare=lambda csr, rb=rb, bc=bc: _prep_ragged_dyn(csr, rb, bc),
            build=_build_ragged_dyn,
            applicable=lambda f, hw, rb=rb, bc=bc: f.f >= 32
            and f.nnz * rb * bc * 4 <= hw.layout_budget_bytes,
            knobs={"rb": rb, "bc": bc, "ragged": True},
        ))
    out.append(Variant(
        name="merge_path_cuda",
        op=feat.op,
        prepare=_prep_merge_dyn,
        build=_build_merge_dyn,
        applicable=lambda f, hw: f.f >= 32
        and f.nnz * 8 * 8 * 4 <= hw.layout_budget_bytes
        and f.nnz + f.n_row_blocks8() + 8 <= _INT32_MAX,
        knobs={"rb": 8, "bc": 8, "tile_slots": 8, "ragged": True},
    ))
    return out


# --------------------------------------------------------------- SDDMM
# SDDMM variants return the baseline's CSR-ordered nnz vector: the block
# kernels emit (rb, bc) tiles and a per-edge flat cell index gathers each
# edge's cell back out. The mask comes from structure alone (values
# dropped), so explicitly zero-weighted edges still get <X_i, Y_j>,
# exactly as gather_dot computes.
def _sddmm_variants(feat: InputFeatures) -> List[Variant]:
    def runner(fn):
        return lambda aux, device: (lambda x, y, a=_dev(aux, device): fn(a, x, y))

    return [
        Variant(
            name="gather_dot",
            op=feat.op,
            prepare=kb.prepare_csr,
            build=runner(kb.sddmm_gather_dot),
            applicable=lambda f, hw: True,
            is_baseline=True,
        ),
        Variant(
            name="row_ell",
            op=feat.op,
            prepare=lambda csr: {
                **{f"ell_{k}": v for k, v in kb.prepare_row_ell(csr).items()},
                **kb.prepare_edge_slots(csr),
            },
            build=runner(kb.sddmm_row_ell_csr),
            applicable=lambda f, hw: _ell_applicable(f),
        ),
    ]


def _prep_sddmm_dense(csr: CSR, rb: int, bc: int) -> Dict:
    s_csr = csr.structural()
    bell = csr_to_block_ell(s_csr, rb=rb, bc=bc)
    idx = block_ell_edge_index(s_csr, bell)
    w = bell.width
    flat = (((idx["edge_blkrow"].astype(np.int64) * w + idx["edge_slot"]) * rb
             + idx["edge_r"]) * bc + idx["edge_c"])
    return {"colblk": bell.colblk, "mask": _mask_of(bell.vals),
            "padding_frac": bell.padding_frac, "edge_flat": flat}


def _prep_sddmm_ragged(csr: CSR, rb: int, bc: int) -> Dict:
    rag, padding_frac, edges = ragged_layout(csr.structural(), rb, bc)
    return {"slot_rowblk": rag.slot_rowblk, "slot_colblk": rag.slot_colblk,
            "mask": _mask_of(rag.slot_vals), "padding_frac": padding_frac,
            "edge_flat": _edge_flat(edges, rb, bc)}


def _prep_sddmm_merge(csr: CSR, tile_slots: int) -> Dict:
    aux, rag, edges = _merge_aux(csr.structural(), tile_slots)
    n_tiles = aux["n_tiles"]
    mask = _pad_slots(_mask_of(rag.slot_vals), n_tiles * tile_slots)
    return {"blkptr": aux["blkptr"], "slot_colblk": aux["slot_colblk"],
            "tile_rowblk": aux["tile_rowblk"],
            "tile_mask": mask.reshape(n_tiles, tile_slots, 8, 8),
            "padding_frac": aux["padding_frac"], "edge_flat": _edge_flat(edges, 8, 8)}


def _build_sddmm(kernel: Callable, keys: Tuple[str, ...]) -> Callable:
    """Runner factory: the kernel over the prepared ``keys``, then the
    per-edge gather back to CSR order."""
    def build(aux: Dict, device: torch.device) -> Callable:
        dev = _dev(aux, device)
        args = [dev[k] for k in keys]
        flat = dev["edge_flat"]
        return lambda x, y: kernel(*args, x, y).reshape(-1).index_select(0, flat)

    return build


def _cuda_sddmm_variants(feat: InputFeatures) -> List[Variant]:
    """Dense-W and ragged (8x8, 16x8) and merge-path (tile_slots 8, 16)
    SDDMM on the hand-written kernels. The kernels take any F, so the
    Pallas padding of F to a multiple of 32 has no counterpart."""
    out = []
    for ragged in (False, True):
        for rb, bc in ((8, 8), (16, 8)):
            if ragged:
                prep = lambda csr, rb=rb, bc=bc: _prep_sddmm_ragged(csr, rb, bc)
                build = _build_sddmm(ksd.sddmm_ragged_ell,
                                     ("slot_rowblk", "slot_colblk", "mask"))
                # the tile table holds <= nnz slots of rb*bc*4 bytes
                applicable = (lambda f, hw, rb=rb, bc=bc: f.f >= 16
                              and f.nnz * rb * bc * 4 <= hw.layout_budget_bytes)
            else:
                prep = lambda csr, rb=rb, bc=bc: _prep_sddmm_dense(csr, rb, bc)
                build = _build_sddmm(ksd.sddmm_block_ell, ("colblk", "mask"))
                # the JAX gate: ~n_rows * W * bc * 4 bytes, W up to deg_max
                applicable = (lambda f, hw, bc=bc: f.f >= 16
                              and f.n_rows * f.deg_max * bc * 4 <= hw.layout_budget_bytes)
            out.append(Variant(
                name="ragged_ell_cuda" if ragged else "block_ell_cuda",
                op=feat.op,
                prepare=prep,
                build=build,
                applicable=applicable,
                knobs={"rb": rb, "bc": bc, **({"ragged": True} if ragged else {})},
            ))
    for tile_slots in (8, 16):
        out.append(Variant(
            name="merge_path_cuda",
            op=feat.op,
            prepare=lambda csr, ts=tile_slots: _prep_sddmm_merge(csr, ts),
            build=_build_sddmm(ksd.sddmm_merge_path,
                               ("blkptr", "slot_colblk", "tile_rowblk", "tile_mask")),
            applicable=lambda f, hw, ts=tile_slots: f.f >= 16
            and f.nnz * 8 * 8 * 4 <= hw.layout_budget_bytes
            and f.nnz + f.n_row_blocks8() + ts <= _INT32_MAX,
            knobs={"rb": 8, "bc": 8, "tile_slots": tile_slots, "ragged": True},
        ))
    return out


# ------------------------------------------- pipeline-level attention
# Attention candidates are whole pipelines: each composed
# {sddmm layout x spmm layout} pair, plus the fused hand-written kernels.
# The pipeline scheduler (core/pipeline.py) probes these end to end; a
# per-op decide can never justify a fused kernel because its benefit (no
# logits/probs round-trip through device memory) lies *between* ops.
def _structural(csr: CSR) -> CSR:
    """Attention uses the sparsity pattern only. Drop stored values so the
    ELL/block-ELL masks (built from val != 0) keep explicitly zero-weighted
    edges — the CSR baseline ignores values and includes them."""
    return csr.structural()


def _prepare_attn_ell(csr: CSR) -> Dict:
    return kb.prepare_row_ell(_structural(csr))


def _prepare_attn_mixed(csr: CSR) -> Dict:
    return {
        **kb.prepare_csr(csr),
        **{f"ell_{k}": v for k, v in _prepare_attn_ell(csr).items()},
        **kb.prepare_edge_slots(csr),
    }


def _prepare_attn_fused(csr: CSR, rb: int, bc: int) -> Dict:
    bell = csr_to_block_ell(_structural(csr), rb=rb, bc=bc)
    return {"colblk": bell.colblk, "mask": _mask_of(bell.vals), "n_rows": bell.n_rows}


def _build_attn_fused(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    return lambda q, k, v: ka.fused_csr_attention(
        dev["colblk"], dev["mask"], q, k, v, n_rows=n
    )


def _prepare_attn_ragged(csr: CSR, rb: int, bc: int) -> Dict:
    rag, padding_frac, _ = ragged_layout(_structural(csr), rb, bc)
    return {
        "blkptr": rag.blkptr,
        "slot_colblk": rag.slot_colblk,
        "mask": _mask_of(rag.slot_vals),
        "n_rows": rag.n_rows,
        "padding_frac": padding_frac,
    }


def _build_attn_ragged(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    return lambda q, k, v: ka.fused_ragged_attention(
        dev["blkptr"], dev["slot_colblk"], dev["mask"], q, k, v, n_rows=n
    )


def _attention_variants(feat: InputFeatures, include_kernels: bool) -> List[Variant]:
    stage_impls = {
        ("gather_dot", "gather_segsum"): (kb.prepare_csr, kb.attention_csr),
        ("row_ell", "row_ell"): (_prepare_attn_ell, kb.attention_ell),
        ("row_ell", "gather_segsum"): (_prepare_attn_mixed, kb.attention_ell_to_csr),
        ("gather_dot", "row_ell"): (_prepare_attn_mixed, kb.attention_csr_to_ell),
    }
    vs = []
    for (s, m), (prep, fn) in stage_impls.items():
        needs_ell = "row_ell" in (s, m)
        vs.append(Variant(
            name="pipe",
            op="attention",
            prepare=prep,
            build=lambda aux, device, fn=fn: (
                lambda q, k, v, a=_dev(aux, device): fn(a, q, k, v)
            ),
            applicable=(
                (lambda f, hw: _ell_applicable(f)) if needs_ell
                else (lambda f, hw: True)
            ),
            knobs={"sddmm": s, "spmm": m},
            is_baseline=(s == "gather_dot" and m == "gather_segsum"),
        ))
    if include_kernels:
        rb, bc = 8, 8
        vs.append(Variant(
            name="fused_attention_cuda",
            op="attention",
            prepare=lambda csr: _prepare_attn_fused(csr, rb, bc),
            build=_build_attn_fused,
            # duplicate edges merge in block-ELL masking (a different
            # function than the pipeline computes); the mask table grows
            # with n_rows x deg_max under skew
            applicable=lambda f, hw: not f.dup_edges
            and f.n_rows * f.deg_max * bc <= hw.layout_budget_bytes,
            knobs={"rb": rb, "bc": bc},
        ))
        vs.append(Variant(
            name="ragged_attention_cuda",
            op="attention",
            prepare=lambda csr: _prepare_attn_ragged(csr, rb, bc),
            build=_build_attn_ragged,
            # same duplicate-edge gate; the mask table scales with live
            # slots (<= nnz tiles), not n_rows x deg_max
            applicable=lambda f, hw: not f.dup_edges
            and f.nnz * rb * bc * 4 <= hw.layout_budget_bytes,
            knobs={"rb": rb, "bc": bc, "ragged": True},
        ))
    return vs


def candidates(
    feat: InputFeatures,
    hw: HardwareSpec,
    device: torch.device,
    include_kernels: Optional[bool] = None,
) -> List[Variant]:
    kind = op_kind(feat.op)
    if include_kernels is None:
        include_kernels = (
            device.type == "cuda" or os.environ.get("AUTOSAGE_PROBE_PALLAS") == "1"
        )
    if kind == "attention":
        vs = _attention_variants(feat, include_kernels)
    elif kind == "sddmm":
        vs = _sddmm_variants(feat)
        if include_kernels:
            vs += _cuda_sddmm_variants(feat)
    elif op_dynamic_vals(feat.op):
        vs = _spmm_dyn_variants(feat)
        if include_kernels:
            vs += _cuda_spmm_dyn_variants(feat)
    else:
        vs = _spmm_variants(feat)
        if include_kernels:
            vs += _cuda_spmm_variants(feat)
    return [v for v in vs if v.applicable(feat, hw)]


def baseline(feat: InputFeatures, hw: HardwareSpec, device: torch.device) -> Variant:
    for v in candidates(feat, hw, device, include_kernels=False):
        if v.is_baseline:
            return v
    raise RuntimeError(f"no baseline for op {feat.op}")
