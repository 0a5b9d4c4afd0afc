"""Kernel-variant registry: the SpMM and CSR-attention candidate pools
the scheduler picks from.

Port of the SpMM and attention parts of repro/core/registry.py. A
Variant bundles

  prepare(csr) -> aux dict             host-side format conversion
                                       (numpy), amortized
  build(aux, device) -> run(b)         uploads aux to ``device`` and
                                       returns the timed/chosen runner
  applicable(feat, hw) -> bool         hard constraints

The library-op variants (kernels/baselines.py) always join the pool;
``gather_segsum`` (SpMM) and the composed ``pipe[sddmm=gather_dot,
spmm=gather_segsum]`` (attention) are the guardrail baselines. The
hand-written CUDA kernels (kernels/spmm.py, kernels/attention.py) join
it on a CUDA device, or on the CPU when AUTOSAGE_PROBE_PALLAS=1, where
they run their plain versions.

The fused-attention memory gates compare the JAX package's layout-size
expressions against ``HardwareSpec.layout_budget_bytes``: 512 MB on the
CPU profiles (so the CPU candidate lists equal the JAX package's) and
half the card's memory on an H100, where the JAX package's TPU-sized
512 MB would shut both fused kernels out of Reddit-scale graphs.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

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
from repro_torch.kernels import spmm as ks
from repro_torch.sparse.bsr import csr_to_block_ell, hub_split
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.merge import build_merge_path

# variant name -> the repro (JAX) family it ports; estimate.py costs each
# variant with its family's model, and the parity tests pair them up
PORTED_FROM = {
    "gather_segsum": "gather_segsum",
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
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    aux = {"n_rows": csr.n_rows, "padding_frac": bell.padding_frac}
    if ragged:
        rag = bell.to_ragged()
        aux.update(blkptr=rag.blkptr, slot_colblk=rag.slot_colblk,
                   slot_vals=rag.slot_vals)
    else:
        aux.update(colblk=bell.colblk, vals=bell.vals)
    return aux


def _build_block_ell(aux: Dict, device: torch.device, ragged: bool) -> Callable:
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    if ragged:
        return lambda b: ks.spmm_ragged_ell(
            dev["blkptr"], dev["slot_colblk"], dev["slot_vals"], b, n_rows=n
        )
    return lambda b: ks.spmm_block_ell(dev["colblk"], dev["vals"], b, n_rows=n)


def _prep_merge(csr: CSR, tile_slots: int) -> Dict:
    bell = csr_to_block_ell(csr, rb=8, bc=8)
    mp = build_merge_path(bell.to_ragged(), tile_slots=tile_slots)
    return {
        "n_rows": csr.n_rows,
        "n_slots": mp.n_slots,
        "padding_frac": bell.padding_frac,
        "blkptr": mp.blkptr,
        "slot_colblk": mp.slot_colblk,
        "tile_rowblk": mp.tile_rowblk,
        "tile_offset": mp.tile_offset,
        "tile_vals": mp.tile_vals,
    }


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


def _to_mask(tiles: np.ndarray) -> np.ndarray:
    """The 0/1 mask of a structural layout's value tiles, in place: the
    tiles count edges per cell (1 without duplicates), so clipping at 1
    is ``tiles != 0`` without a second full-size host copy (13.6 GB for
    dense-W at Reddit-0.25)."""
    return np.minimum(tiles, 1.0, out=tiles)


def _prepare_attn_fused(csr: CSR, rb: int, bc: int) -> Dict:
    bell = csr_to_block_ell(_structural(csr), rb=rb, bc=bc)
    return {"colblk": bell.colblk, "mask": _to_mask(bell.vals), "n_rows": bell.n_rows}


def _build_attn_fused(aux: Dict, device: torch.device) -> Callable:
    dev = _dev(aux, device)
    n = int(aux["n_rows"])
    return lambda q, k, v: ka.fused_csr_attention(
        dev["colblk"], dev["mask"], q, k, v, n_rows=n
    )


def _prepare_attn_ragged(csr: CSR, rb: int, bc: int) -> Dict:
    bell = csr_to_block_ell(_structural(csr), rb=rb, bc=bc)
    rag = bell.to_ragged()
    return {
        "blkptr": rag.blkptr,
        "slot_colblk": rag.slot_colblk,
        "mask": _to_mask(rag.slot_vals),
        "n_rows": rag.n_rows,
        "padding_frac": bell.padding_frac,
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
    if op_dynamic_vals(feat.op) or kind == "sddmm" or feat.op == "csr_attention":
        raise NotImplementedError(
            f"op {feat.op!r} is not ported to repro_torch yet (ROADMAP.md Queue 1)"
        )
    if include_kernels is None:
        include_kernels = (
            device.type == "cuda" or os.environ.get("AUTOSAGE_PROBE_PALLAS") == "1"
        )
    if kind == "attention":
        vs = _attention_variants(feat, include_kernels)
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
