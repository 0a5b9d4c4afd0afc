"""Input feature extraction (paper §4.2: "#rows/nnz, degree quantiles, F,
device caps") and the device's roofline profile.

Port of repro/core/features.py. `InputFeatures` is the same dataclass
with the same values, so the device-neutral half of a cache entry reads
the same in both packages, and `ScheduleBucket.sig()` gives the JAX
package's string for the same graph, F and op, so bucket keys read the
same too. `HardwareSpec.current()` and `device_sig()` read torch's CUDA
device instead of `jax.devices()`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.sparse.csr import CSR, graph_signature


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Device capability summary for the roofline estimate.

    ``step_s`` is the fixed charge per kernel step (one slot of one
    feature tile) and ``p_eff`` the number of row blocks the card works
    on at once; both feed estimate.py's block-ELL models.
    ``sddmm_step_s`` is the same charge for the SDDMM block families and
    ``attn_step_s`` the charge per slot for the fused attention kernels;
    on the CPU profiles both equal ``step_s``, as the JAX package charges.
    ``attn_live_gathers`` says the fused attention kernels gather k and v
    rows and compute per live cell (the port's CUDA kernels), not per
    stored tile (the Pallas kernels, which the CPU profiles model as the
    JAX package does).
    ``layout_budget_bytes`` is the most one prepared layout table may
    take: the registry's fused-attention gates compare the JAX package's
    layout-size expressions against it (512 MB there, sized for a TPU).
    """

    name: str
    peak_flops: float  # FLOP/s
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per link
    step_s: float = 2e-7
    sddmm_step_s: float = 2e-7
    attn_step_s: float = 2e-7
    attn_live_gathers: bool = False
    p_eff: float = 16.0
    layout_budget_bytes: float = 512e6

    @staticmethod
    def cpu() -> "HardwareSpec":
        return HardwareSpec("cpu", 5e10, 2e10, 1e9)

    @staticmethod
    def cpu_wide() -> "HardwareSpec":
        """The `cpu` roofline with 4x the memory bandwidth: bandwidth-bound
        candidates rank relatively cheaper."""
        return HardwareSpec("cpu_wide", 5e10, 8e10, 1e9)

    @staticmethod
    def h100() -> "HardwareSpec":
        """NVIDIA H100 SXM from the data sheet: 67 TFLOP/s fp32 outside the
        tensor cores (the hand kernels run fp32 FMA), 3.35 TB/s HBM3,
        450 GB/s NVLink each way, 132 SMs (one row block per CUDA block,
        so ``p_eff`` = 132 chains run at once; `current` reads the card's
        own SM count). ``step_s`` is the ragged kernel's time per (slot,
        feature chunk) beyond its bound (the bytes of its layout, B and C
        at the HBM rate): (20.58 ms - 1.58 ms) / (19,884,395 slots x 2
        chunks) for the 8x8 ragged layout of Reddit-0.25 at F = 256,
        measured by chip_smoke.py's phase 2 (printed as
        ``ragged_s_per_step``) on an NVIDIA H100 80GB HBM3 at a 700 W
        power limit. ``sddmm_step_s`` is the same fit for the ragged
        SDDMM kernel: (ms - bound ms) / (slots x chunks) for the 8x8
        ragged layout of deduplicated Reddit-0.25 at D = 256 (19,884,395
        slots, 2 chunks), measured by chip_smoke.py's phase 7 (printed as
        ``HardwareSpec.sddmm_step_s``) on an NVIDIA H100 80GB HBM3 at a
        700 W power limit. ``attn_step_s`` is the ragged fused attention
        kernel's time per slot beyond the roofline of estimate.py's own
        live-cell terms (``attn_live_gathers``): (ms - roofline) / slots,
        both as the estimate counts them, for the 8x8 ragged layout of
        deduplicated Reddit-0.25 at D = 256, measured by chip_smoke.py's
        phase 5 (printed as ``HardwareSpec.attn_step_s``) on an NVIDIA
        H100 80GB HBM3 at a 700 W power limit. ``layout_budget_bytes`` is half
        the card's 80 GB (`current` reads the card's own total): one
        layout table may take half, the features, the outputs, a second
        candidate's table and the allocator's slack the rest."""
        return HardwareSpec("h100", 67e12, 3.35e12, 450e9, step_s=4.7774e-10,
                            sddmm_step_s=1.8655e-10, attn_step_s=7.7567e-11,
                            attn_live_gathers=True, p_eff=132.0, layout_budget_bytes=40e9)

    @staticmethod
    def from_profile(name: str) -> "HardwareSpec":
        profiles: Dict[str, HardwareSpec] = {
            "cpu": HardwareSpec.cpu(),
            "cpu_wide": HardwareSpec.cpu_wide(),
            "h100": HardwareSpec.h100(),
        }
        try:
            return profiles[name]
        except KeyError:
            raise KeyError(
                f"unknown hardware profile {name!r}; known: {sorted(profiles)}"
            ) from None

    @staticmethod
    def current(device: torch.device) -> "HardwareSpec":
        """Roofline profile of ``device``. AUTOSAGE_HW_PROFILE pins a named
        profile regardless of the physical device."""
        override = os.environ.get("AUTOSAGE_HW_PROFILE")
        if override:
            return HardwareSpec.from_profile(override)
        if device.type != "cuda":
            return HardwareSpec.cpu()
        name = torch.cuda.get_device_name(device)
        if "H100" in name:
            props = torch.cuda.get_device_properties(device)
            return dataclasses.replace(
                HardwareSpec.h100(), p_eff=float(props.multi_processor_count),
                layout_budget_bytes=props.total_memory / 2,
            )
        raise KeyError(
            f"no roofline profile for {name!r}; set AUTOSAGE_HW_PROFILE to one of "
            "cpu, cpu_wide, h100"
        )


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means CUDA, and without a card
    that raises unless the caller asked for the CPU explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_sig(device: torch.device) -> str:
    """Device identity embedded in every cache key, e.g.
    ``cuda:NVIDIA H100 80GB HBM3:torch2.11.0+cu128``. The env override
    AUTOSAGE_DEVICE_SIG_OVERRIDE exists for heterogeneous-fleet
    simulation: two processes on one box act as two device classes
    (pair it with AUTOSAGE_HW_PROFILE so their rooflines differ too)."""
    override = os.environ.get("AUTOSAGE_DEVICE_SIG_OVERRIDE")
    if override:
        return override
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return f"{device.type}:{kind}:torch{torch.__version__}"


# Op taxonomy (copy of repro/core/features.py): every op string is its own
# cache-key dimension, while candidates, estimates and probe operands come
# from the op's structural compute kind. ``dynamic_vals`` marks ops whose
# sparse values are a runtime operand.
_OP_TAXONOMY = {
    # op                  (kind,        dynamic_vals)
    "spmm": ("spmm", False),
    "sddmm": ("sddmm", False),
    "attention": ("attention", False),
    "csr_attention": ("attention", False),
    "spmm_bwd_b": ("spmm", False),
    "spmm_bwd_b_dyn": ("spmm", True),
    "spmm_bwd_vals": ("sddmm", False),
    "spmm_dyn": ("spmm", True),
    "sddmm_bwd_x": ("spmm", True),
    "sddmm_bwd_y": ("spmm", True),
    "attention_bwd_e": ("sddmm", False),
    "attention_bwd_p": ("sddmm", False),
    "attention_bwd_q": ("spmm", True),
    "attention_bwd_k": ("spmm", True),
    "attention_bwd_v": ("spmm", True),
}


def op_kind(op: str) -> str:
    """Structural compute family of ``op`` ("spmm"|"sddmm"|"attention")."""
    try:
        return _OP_TAXONOMY[op][0]
    except KeyError:
        raise KeyError(f"unknown op {op!r}") from None


def op_dynamic_vals(op: str) -> bool:
    """True if the op's sparse values arrive per call."""
    try:
        return _OP_TAXONOMY[op][1]
    except KeyError:
        raise KeyError(f"unknown op {op!r}") from None


@dataclasses.dataclass(frozen=True)
class InputFeatures:
    """Everything the scheduler is allowed to look at."""

    n_rows: int
    n_cols: int
    nnz: int
    avg_deg: float
    deg_p50: float
    deg_p90: float
    deg_p99: float
    deg_max: float
    skew: float  # p99 / max(p50, 1) — heavy-tail indicator
    density: float
    f: int  # feature width F
    op: str  # any key of _OP_TAXONOMY
    graph_sig: str
    f_mod_4: bool  # paper's vec4 applicability bit
    dup_edges: bool = False
    # fraction of the dense-W slot grid at rb=bc=8 that would be padding,
    # estimated from degrees alone, in [0, 1)
    padding_waste: float = 0.0
    # estimated dense-W ELL width at rb=bc=8 (0 = unknown)
    ell_width_est: float = 0.0

    @staticmethod
    def from_csr(csr: CSR, f: int, op: str) -> "InputFeatures":
        return InputFeatures(
            **_structure_stats(csr),
            f=f,
            op=op,
            f_mod_4=(f % 4 == 0),
            dup_edges=(csr.has_duplicate_edges() if op == "attention" else False),
        )

    def hub_threshold(self) -> int:
        """Default hubT: degrees beyond p99 are 'hubs' (AUTOSAGE_HUB_T
        overrides)."""
        return int(max(self.deg_p99, 4 * max(self.avg_deg, 1.0)))

    def balance(self) -> float:
        """Load-imbalance ratio deg_max / deg_mean (>= 1)."""
        return self.deg_max / max(self.avg_deg, 1.0)

    def n_row_blocks8(self) -> int:
        return -(-self.n_rows // 8)

    def dense_tiles_est(self) -> float:
        """Estimated slot-grid size n_row_blocks x W a dense-W kernel runs."""
        return self.n_row_blocks8() * max(self.ell_width_est, 1.0)

    def ragged_tiles_est(self) -> float:
        """Estimated slot count a ragged kernel runs (>= one dummy slot per
        row block)."""
        return max(
            self.dense_tiles_est() * (1.0 - self.padding_waste),
            float(self.n_row_blocks8()),
        )

    def to_neutral(self) -> Dict[str, object]:
        """The device-free half of a schedule-cache entry."""
        return dataclasses.asdict(self)


def features_from_neutral(neutral: Dict[str, object]) -> InputFeatures:
    """Inverse of InputFeatures.to_neutral(); unknown fields from newer
    writers are dropped, missing ones take the dataclass defaults."""
    known = {f.name: f for f in dataclasses.fields(InputFeatures)}
    kwargs = {k: v for k, v in neutral.items() if k in known}
    missing = [
        n for n, f in known.items()
        if n not in kwargs and f.default is dataclasses.MISSING
    ]
    if missing:
        raise ValueError(f"neutral features missing required fields: {missing}")
    return InputFeatures(**kwargs)


def _structure_stats(csr: CSR) -> Dict[str, object]:
    """The fields of `InputFeatures` that read the structure alone (sizes,
    degree quantiles, padding estimate, signature), memoized on the CSR
    object as `graph_signature` is: a training loop decides several ops
    on the same graph objects every step, and the two O(n_rows) passes
    over the degrees would otherwise run in each decide. The memo dies
    with the object and assumes its arrays are not mutated in place;
    a transpose or a `structural()` view is an object of its own and
    computes its own. Counted in ``autosage_features_total{event}``."""
    memo = getattr(csr, "_features_memo", None)
    if memo is not None:
        obs.REGISTRY.inc(obs.FEATURES_TOTAL, event="hits")
        return memo
    qs = csr.degree_quantiles((0.5, 0.9, 0.99, 1.0))
    nnz = csr.nnz
    waste, w_est = _block_padding_estimate(csr)
    memo = dict(
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        nnz=nnz,
        avg_deg=nnz / max(csr.n_rows, 1),
        deg_p50=float(qs[0]),
        deg_p90=float(qs[1]),
        deg_p99=float(qs[2]),
        deg_max=float(qs[3]),
        skew=float(qs[2] / max(qs[0], 1.0)),
        density=nnz / max(csr.n_rows * csr.n_cols, 1),
        graph_sig=graph_signature(csr),
        padding_waste=waste,
        ell_width_est=w_est,
    )
    object.__setattr__(csr, "_features_memo", memo)
    obs.REGISTRY.inc(obs.FEATURES_TOTAL, event="built")
    return memo


def _block_padding_estimate(csr: CSR) -> tuple:
    """(padding_waste, ell_width_est) at rb=bc=8, from degrees alone: each
    8-row block's slot count is bounded by its summed degree, capped at
    n_col_blocks."""
    n = csr.n_rows
    if n == 0 or csr.nnz == 0:
        return 0.0, 0.0
    deg = csr.degrees.astype(np.int64)
    nrb = -(-n // 8)
    ncb = max(1, -(-csr.n_cols // 8))
    block_deg = np.add.reduceat(deg, np.arange(0, n, 8))
    slots = np.minimum(np.maximum(block_deg, 1), ncb).astype(np.float64)
    w_est = float(slots.max())
    waste = 1.0 - float(slots.sum()) / (nrb * w_est)
    return waste, w_est


def waste_bin(waste: float) -> int:
    """Monotone 3-level quantization of padding_waste: 0 (< 0.5),
    1 (< 0.75), 2 (>= 0.75). The drift detector (core/batch.py) compares
    live inputs' waste against the bin a bucket was probed under."""
    if waste >= 0.75:
        return 2
    if waste >= 0.5:
        return 1
    return 0


def balance_bin(balance: float) -> int:
    """Monotone 3-level quantization of deg_max/deg_mean: 0 (< 32),
    1 (< 256), 2 (>= 256): hub-dominated inputs (merge-path territory)
    land in a bucket apart from uniform ones."""
    if balance >= 256.0:
        return 2
    if balance >= 32.0:
        return 1
    return 0


# ---------------------------------------------------------------------
# Schedule buckets: coarse feature canonicalization for batched decide.
# Minibatched training serves thousands of induced subgraphs per epoch
# that differ only in which rows got sampled, and the best mapping is
# stable across coarse feature regimes; a bucket keeps the features that
# flip decisions (op, F, device and binned shape statistics), so
# near-identical subgraphs share one probed decision.

def _log2_bin(x: float) -> int:
    """floor(log2(x)) with x <= 1 clamped to bin 0; monotone in x."""
    return int(math.floor(math.log2(x))) if x > 1.0 else 0


def _log10_bin(x: float) -> int:
    """floor(log10(x)) for densities in (0, 1]; 0 maps below every real
    density; monotone in x."""
    if x <= 0.0:
        return -99
    return max(-12, int(math.floor(math.log10(x))))


@dataclasses.dataclass(frozen=True)
class ScheduleBucket:
    """Canonical coarse regime of one (graph, F, op) on one device.

    Hashable and order-free: equal buckets (and only equal buckets) share
    a batch-scheduler decision and a bucket-level cache entry."""

    op: str
    f: int
    device: str  # device_sig()
    rows_bin: int  # floor(log2(n_rows))
    nnz_bin: int  # floor(log2(nnz))
    skew_bin: int  # floor(log2(skew))
    density_bin: int  # floor(log10(density))
    dup_edges: bool  # flips fused-attention applicability
    waste_bin: int = 0  # waste_bin(padding_waste)
    balance_bin: int = 0  # balance_bin(deg_max / deg_mean)

    @staticmethod
    def from_features(feat: InputFeatures, device: str) -> "ScheduleBucket":
        return ScheduleBucket(
            op=feat.op,
            f=feat.f,
            device=device,
            rows_bin=_log2_bin(feat.n_rows),
            nnz_bin=_log2_bin(feat.nnz),
            skew_bin=_log2_bin(feat.skew),
            density_bin=_log10_bin(feat.density),
            dup_edges=feat.dup_edges,
            waste_bin=waste_bin(feat.padding_waste),
            balance_bin=balance_bin(feat.balance()),
        )

    def sig(self) -> str:
        """The binned shape regime, as it stands inside bucket-level cache
        keys (the key carries device, F, op and alpha as fields of their
        own)."""
        dup = "dup" if self.dup_edges else "simple"
        return (
            f"r{self.rows_bin}.z{self.nnz_bin}.s{self.skew_bin}"
            f".d{self.density_bin}.w{self.waste_bin}.b{self.balance_bin}.{dup}"
        )
