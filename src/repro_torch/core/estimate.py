"""Roofline-style candidate estimates (paper §4.2 'shortlist candidates
with a roofline-style estimate').

Port of repro/core/estimate.py. Each variant is
modelled by the branch of the `repro` family it ports
(registry.PORTED_FROM), so ``ragged_ell_cuda`` is costed exactly like
``ragged_ell_pallas``. Two constants of the JAX model described a Pallas
grid on a TPU and now come from the device profile: the per-step charge
(``HardwareSpec.step_s``, fitted from the ragged kernel's measured time
per slot) and the slot-chain parallelism (``HardwareSpec.p_eff``, the SM
count on a GPU). The estimate only has to *rank* candidates well enough
that the true winner lands in the probed top-k; the guardrail absorbs
estimate error.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from repro_torch.core.features import (
    HardwareSpec,
    InputFeatures,
    op_dynamic_vals,
    op_kind,
)
from repro_torch.core.registry import PORTED_FROM
from repro_torch.kernels.spmm import f_tile as cuda_f_tile

BYTES_F32 = 4


def estimates_for(
    feat: InputFeatures, hw: HardwareSpec, variants: Iterable
) -> Dict[str, float]:
    """Roofline estimate (ms) per variant full name, on ``hw``; the one
    place estimates are derived."""
    return {
        v.full_name(): estimate(feat, hw, v.name, v.knobs) * 1e3
        for v in variants
    }


def _roofline(bytes_moved: float, flops: float, hw: HardwareSpec) -> float:
    return max(bytes_moved / hw.hbm_bw, flops / hw.peak_flops)


def _block_ell_elems(
    feat: InputFeatures, knobs: Dict, ragged: bool, variant: str = ""
) -> float:
    """Estimated padded *elements* a block-ELL kernel touches:
    n_row_blocks x W x rb x bc for dense-W, the actual slot mass for
    ragged, modelled at the canonical rb=bc=8 blocking. Features without
    degree data fall back to a ``padding_waste`` knob, then the feature's
    measured waste, then a counted nnz-multiplier guess."""
    if feat.ell_width_est > 0:
        tiles8 = feat.ragged_tiles_est() if ragged else feat.dense_tiles_est()
        elems = tiles8 * 64.0
    elif "padding_waste" in knobs:
        elems = feat.nnz * knobs["padding_waste"]
        if ragged:
            elems /= 4.0
    elif feat.padding_waste > 0.0:
        frac = min(feat.padding_waste, 0.98)
        elems = feat.nnz if ragged else feat.nnz / (1.0 - frac)
    else:
        from repro_torch.core import obs

        obs.REGISTRY.inc(
            "autosage_estimate_magic_fallback_total",
            op=feat.op,
            variant=variant or "?",
        )
        elems = feat.nnz * 8.0
        if ragged:
            elems /= 4.0
    return max(elems, 64.0)


def _block_ell_steps(elems: float, knobs: Dict) -> float:
    """Kernel steps = padded elements / tile size."""
    return elems / (knobs.get("rb", 8) * knobs.get("bc", 8))


def _row_serial_penalty(
    feat: InputFeatures, hw: HardwareSpec, knobs: Dict, weight: float = 1.0,
    step_s: Optional[float] = None,
) -> float:
    """Serialization tax of row-partitioned families under degree skew:
    the heaviest row's slot chain (deg_max/bc slots) runs in ONE block;
    whatever exceeds the fair share nnz/p_eff is critical-path extension,
    charged at the per-slot step time (``step_s``, by default
    ``hw.step_s``). Merge-path never pays it."""
    if feat.balance() < 8.0:
        return 0.0
    rb = knobs.get("rb", 8)
    bc = knobs.get("bc", 8)
    max_chain = feat.deg_max / bc
    fair = feat.nnz / hw.p_eff / (rb * bc)
    excess = max(0.0, max_chain - fair)
    step_t = 2.0 * rb * bc * feat.f / hw.peak_flops + (
        hw.step_s if step_s is None else step_s)
    return weight * excess * step_t


def _hub_row_frac(feat: InputFeatures, hub_t: float) -> float:
    """Fraction of rows whose degree exceeds ``hub_t``, by log-degree
    interpolation between the stored quantile anchors (p50, 0.50),
    (p90, 0.10), (p99, 0.01), (max, 0.0)."""
    anchors = (
        (max(feat.deg_p50, 1.0), 0.50),
        (max(feat.deg_p90, 1.0), 0.10),
        (max(feat.deg_p99, 1.0), 0.01),
        (max(feat.deg_max, 1.0), 0.0),
    )
    t = max(float(hub_t), 1.0)
    if t < anchors[0][0]:
        return 0.5
    for (d0, f0), (d1, f1) in zip(anchors, anchors[1:]):
        if d0 <= t < d1:
            w = (math.log(t) - math.log(d0)) / (math.log(d1) - math.log(d0))
            return f0 + (f1 - f0) * w
        if d0 == d1 == t:
            return min(f0, f1)
    return 0.0


def _hub_light_width(feat: InputFeatures, frac: float) -> float:
    """ELL width of the light partition: the largest degree quantile still
    below the hub cut."""
    if frac <= 0.01:
        return feat.deg_p99
    if frac <= 0.10:
        return feat.deg_p90
    return feat.deg_p50


def _f_tile(variant: str, knobs: Dict, f: int) -> int:
    """Feature tile of one kernel step: the Pallas knob, or the columns
    one warp of the CUDA kernels covers."""
    if variant.endswith("_cuda"):
        return cuda_f_tile(f)
    return knobs.get("f_tile", 128)


def estimate_spmm(feat: InputFeatures, hw: HardwareSpec, variant: str,
                  knobs: Dict) -> float:
    family = PORTED_FROM.get(variant, variant)
    n, f, nnz = feat.n_rows, feat.f, feat.nnz
    out_bytes = n * f * BYTES_F32
    if family == "gather_segsum":
        bytes_moved = nnz * (f * BYTES_F32 + 8) + out_bytes * 2.0
        flops = 2.0 * nnz * f
    elif family == "dense":
        bytes_moved = (feat.n_rows * feat.n_cols + feat.n_cols * f) * BYTES_F32 + out_bytes
        flops = 2.0 * feat.n_rows * feat.n_cols * f
    elif family == "row_ell":
        padded = n * max(feat.deg_max, 1.0)
        bytes_moved = padded * (f * BYTES_F32 + 8) + out_bytes
        flops = 2.0 * padded * f
        return _roofline(bytes_moved, flops, hw) + _row_serial_penalty(
            feat, hw, knobs
        )
    elif family == "hub_split_ell":
        hub_t = knobs.get("hub_threshold", feat.hub_threshold())
        frac = _hub_row_frac(feat, hub_t)
        light_pad = (feat.n_rows * (1.0 - frac)) * min(
            _hub_light_width(feat, frac), hub_t
        )
        hub_pad = (feat.n_rows * frac + 1) * feat.deg_max
        padded = light_pad + hub_pad
        bytes_moved = padded * (f * BYTES_F32 + 8) + out_bytes * 1.2
        flops = 2.0 * padded * f
        return _roofline(bytes_moved, flops, hw) + _row_serial_penalty(
            feat, hw, knobs, weight=0.5
        )
    elif family in ("block_ell_pallas", "ragged_ell_pallas", "hub_ragged_pallas"):
        ragged = family != "block_ell_pallas"
        bc = knobs.get("bc", 8)
        eff = _block_ell_elems(feat, knobs, ragged, variant)
        bytes_moved = eff * (f * BYTES_F32 / bc + BYTES_F32) + out_bytes
        if family == "hub_ragged_pallas":
            bytes_moved += out_bytes * 0.4  # two partitions + row scatter
        flops = 2.0 * eff * f
        n_steps = _block_ell_steps(eff, knobs) * max(f / _f_tile(variant, knobs, f), 1.0)
        penalty = _row_serial_penalty(
            feat, hw, knobs,
            weight=0.5 if family == "hub_ragged_pallas" else 1.0,
        )
        return _roofline(bytes_moved, flops, hw) + n_steps * hw.step_s + penalty
    elif family == "merge_path_pallas":
        # same slot mass as ragged plus per-tile bookkeeping, and no
        # _row_serial_penalty: the nnz split removes exactly that term
        bc = knobs.get("bc", 8)
        tile_slots = knobs.get("tile_slots", 8)
        eff = _block_ell_elems(feat, knobs, True, variant)
        bytes_moved = eff * (f * BYTES_F32 / bc + BYTES_F32) + out_bytes
        bytes_moved += feat.n_cols * f * BYTES_F32
        flops = 2.0 * eff * f
        slot_steps = _block_ell_steps(eff, knobs) * max(
            f / _f_tile(variant, knobs, f), 1.0
        )
        tile_steps = slot_steps / max(tile_slots, 1)
        return _roofline(bytes_moved, flops, hw) + (slot_steps + tile_steps) * hw.step_s
    else:
        raise KeyError(variant)
    return _roofline(bytes_moved, flops, hw)


def estimate_sddmm(feat: InputFeatures, hw: HardwareSpec, variant: str,
                   knobs: Dict) -> float:
    """SDDMM candidates, and the SDDMM stages of the composed attention
    pipelines. The block families charge one ``hw.sddmm_step_s`` per
    (slot, 128-column chunk), the Pallas grid's step; on the card it is
    fitted on the SDDMM kernel, and on the CPU profiles it equals
    ``step_s``, as in the JAX package."""
    family = PORTED_FROM.get(variant, variant)
    n, f, nnz = feat.n_rows, feat.f, feat.nnz
    if family in ("block_ell_pallas", "ragged_ell_pallas"):
        ragged = family == "ragged_ell_pallas"
        bc = knobs.get("bc", 8)
        f_chunk = knobs.get("f_chunk", 128)
        eff = _block_ell_elems(feat, knobs, ragged, variant)
        # x/y tile streams + tile output, plus the per-edge gather that
        # converts tiles back to the baseline's CSR-ordered nnz vector
        bytes_moved = eff * (2.0 * f * BYTES_F32 / bc + BYTES_F32)
        bytes_moved += nnz * (BYTES_F32 + 12)
        flops = 2.0 * eff * f
        n_steps = _block_ell_steps(eff, knobs) * max(f / f_chunk, 1.0)
        # a hub row block's slots all re-gather the same X rows: the same
        # serialization shape as the SpMM chain (merge-path does not pay it)
        penalty = _row_serial_penalty(feat, hw, knobs, step_s=hw.sddmm_step_s)
        return _roofline(bytes_moved, flops, hw) + n_steps * hw.sddmm_step_s + penalty
    if family == "merge_path_pallas":
        bc = knobs.get("bc", 8)
        f_chunk = knobs.get("f_chunk", 128)
        tile_slots = knobs.get("tile_slots", 8)
        eff = _block_ell_elems(feat, knobs, True, variant)
        bytes_moved = eff * (2.0 * f * BYTES_F32 / bc + BYTES_F32)
        bytes_moved += nnz * (BYTES_F32 + 12)
        bytes_moved += (n + feat.n_cols) * f * BYTES_F32  # resident X/Y
        flops = 2.0 * eff * f
        slot_steps = _block_ell_steps(eff, knobs) * max(f / f_chunk, 1.0)
        tile_steps = slot_steps / max(tile_slots, 1)
        return _roofline(bytes_moved, flops, hw) + (slot_steps + tile_steps) * hw.sddmm_step_s
    if variant == "gather_dot":
        bytes_moved = nnz * (2 * f * BYTES_F32 + 8 + BYTES_F32)
        flops = 2.0 * nnz * f
    elif variant == "row_ell":
        padded = n * max(feat.deg_max, 1.0)
        bytes_moved = padded * (f * BYTES_F32 + 8) + n * f * BYTES_F32
        flops = 2.0 * padded * f
        return _roofline(bytes_moved, flops, hw) + _row_serial_penalty(
            feat, hw, knobs
        )
    else:
        raise KeyError(variant)
    return _roofline(bytes_moved, flops, hw)


# layout each attention stage works in; a mismatch inside a composed
# pipeline costs an extra nnz-sized scatter/gather between stages
_ATTN_STAGE_LAYOUT = {
    "gather_dot": "csr",
    "gather_segsum": "csr",
    "row_ell": "ell",
}


def estimate_attention(feat: InputFeatures, hw: HardwareSpec, variant: str,
                       knobs: Dict) -> float:
    """Pipeline-granularity roofline for CSR attention (core/pipeline.py).

    Composed "pipe" candidates pay two inter-stage round-trips through
    device memory that a per-op estimate never sees: SDDMM writes logits
    which softmax reads back, and softmax writes probs which the
    value-SpMM reads back (4 * nnz * 4 B of traffic). The fused kernels
    keep logits/probs on chip, so their estimate has no inter-stage term;
    they pay ``hw.attn_step_s`` per slot (``step_s`` in the JAX package,
    the same value on the CPU profiles). The JAX package's model gathers
    a k and a v tile and multiplies the whole tile per stored slot; with
    ``hw.attn_live_gathers`` (the port's CUDA kernels) one k and one v row
    are gathered, and one logit and one p·v row computed, per live cell.
    """
    nnz, f = feat.nnz, feat.f
    family = PORTED_FROM.get(variant, variant)
    if family == "pipe":
        s, m = knobs["sddmm"], knobs["spmm"]
        t = estimate_sddmm(feat, hw, s, {})
        # softmax: read logits + mask bookkeeping, write probs; few flops
        t += 2.0 * nnz * BYTES_F32 / hw.hbm_bw + 6.0 * nnz / hw.peak_flops
        t += estimate_spmm(feat, hw, m, {})
        # the two inter-stage round-trips (logits w+r, probs w+r)
        t += 4.0 * nnz * BYTES_F32 / hw.hbm_bw
        if _ATTN_STAGE_LAYOUT[s] != _ATTN_STAGE_LAYOUT[m]:
            # CSR<->ELL conversion: one nnz-sized gather/scatter + indices
            t += nnz * (BYTES_F32 + 8) / hw.hbm_bw
        return t
    if family in ("fused_attention_pallas", "ragged_attention_pallas"):
        ragged = family == "ragged_attention_pallas"
        bc = knobs.get("bc", 8)
        eff = _block_ell_elems(feat, knobs, ragged, variant)  # padded tile work
        # q/k/v/out streamed once; structural mask read once; k and v
        # gathered as below; no logits/probs round-trips
        bytes_moved = (feat.n_rows * 2 + feat.n_cols * 2) * f * BYTES_F32
        bytes_moved += eff * BYTES_F32  # mask tiles
        if hw.attn_live_gathers:  # a k and a v row per live cell
            cells, gather_bytes = nnz, 2.0 * f * BYTES_F32
        else:  # a k and a v tile per stored slot, over its cells
            cells, gather_bytes = eff, 2.0 * f * BYTES_F32 / bc
        bytes_moved += cells * gather_bytes
        flops = 4.0 * cells * f + 8.0 * cells  # sddmm + spmm + online softmax
        n_steps = _block_ell_steps(eff, knobs)
        return _roofline(bytes_moved, flops, hw) + n_steps * hw.attn_step_s
    raise KeyError(variant)


def estimate(feat: InputFeatures, hw: HardwareSpec, variant: str,
             knobs: Dict) -> float:
    """Seconds for ``variant`` on ``feat``, dispatched on the op's compute
    kind: grad ops reuse the forward models ("spmm_bwd_b" is an SpMM
    roofline over the transposed features, "attention_bwd_e" an SDDMM
    one), and dynamic-values ops pay one extra nnz-sized scatter. The
    legacy "csr_attention" op keeps the JAX package's branch, which
    costs a pipeline as an SDDMM plus an SpMM by the variant's name: no
    name of the attention pool is an SDDMM or SpMM family, so every one
    raises KeyError (estimate.py's "unknown variant" signal)."""
    kind = op_kind(feat.op)
    if kind == "spmm":
        t = estimate_spmm(feat, hw, variant, knobs)
        if op_dynamic_vals(feat.op):
            t += feat.nnz * (BYTES_F32 + 8) / hw.hbm_bw
        return t
    if kind == "sddmm":
        return estimate_sddmm(feat, hw, variant, knobs)
    if feat.op == "attention":
        return estimate_attention(feat, hw, variant, knobs)
    if feat.op == "csr_attention":
        # legacy per-op path (pre-pipeline-scheduler); kept for old keys
        t = estimate_sddmm(feat, hw, variant, knobs)
        t += feat.nnz * 3 * BYTES_F32 / hw.hbm_bw
        t += estimate_spmm(feat, hw, variant if variant != "gather_dot" else "gather_segsum",
                           knobs)
        return t
    raise KeyError(feat.op)
