"""Pipeline-level scheduling for CSR attention (SDDMM -> softmax -> SpMM).

Port of repro/core/pipeline.py. `AutoSage.decide` picks a variant per
op, so a per-op view can never justify a fused kernel: its benefit —
logits and probs never round-trip device memory — lies *between* the
ops. This module decides at pipeline granularity instead:

  1. enumerate composed candidates {sddmm variant x softmax x spmm
     variant} plus the fused CUDA kernels (dense-W and ragged), all
     op="attention" Variants in core/registry.py;
  2. shortlist by the pipeline roofline in core/estimate.py, which
     charges composed candidates the two inter-stage round-trips the
     fused kernels avoid;
  3. micro-probe the shortlist end to end on the same induced subgraphs
     through `AutoSage.probe_candidates` (slope mode);
  4. guardrail (Prop. 1) against the 3-stage gather/segsum baseline and
     cache the joint decision under an op="attention" key with
     deterministic replay (core/cache.py).

Entry points are `repro_torch.api.attention(csr, q, k, v, sage=...)`,
`AutoSage.attention` and `AutoSage.decide_attention`; the GAT layer of
models/gnn.py runs through the first. As in core/scheduler.py, an
exact-key miss first consults peer device classes' probed rankings
(core/transfer.py; the end-to-end probe is the confirm pass of a
non-confident transfer), and with resilience on the probe is
sandboxed, a quarantined or unconstructible pin is re-decided (or
raises `ReplayMiss` in replay mode) and a fault in the decision
machinery yields an uncached 3-stage baseline decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

from repro_torch.core import obs
from repro_torch.core import probe as probe_mod
from repro_torch.core import registry, resilience, telemetry
from repro_torch.core.cache import ReplayMiss, ScheduleCache
from repro_torch.core.features import InputFeatures, device_sig
from repro_torch.core.guardrail import apply_guardrail
from repro_torch.core.scheduler import (
    AutoSage,
    Decision,
    ProbeOutcome,
    default_probe_args,
    entry_with_stats,
)
from repro_torch.kernels import baselines as kb
from repro_torch.sparse.csr import CSR

# the fused variants run as one stage in probe_stage_breakdown
FUSED = ("fused_attention_cuda", "ragged_attention_cuda")


@dataclasses.dataclass
class AttentionDecision(Decision):
    """A joint pipeline decision, plus a per-stage timing breakdown of the
    chosen candidate (probe-subgraph medians; empty unless requested)."""

    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_cache_entry(self) -> Dict:
        entry = super().to_cache_entry()
        entry["op"] = "attention"
        if self.stage_ms:
            entry["stage_ms"] = dict(self.stage_ms)
        return entry


def decide_attention(
    sage: AutoSage, csr: CSR, d: int, seed: int = 0, stage_breakdown: bool = False,
    allow_transfer: bool = True,
) -> AttentionDecision:
    """estimate -> end-to-end probe -> guardrail -> cache, at pipeline
    granularity. ``d`` is the head dimension (the F of the cache key)."""
    t0 = time.perf_counter()
    with obs.span("decide", op="attention", f=d, scheduler="exact"):
        try:
            decision, tier = _decide_attention_impl(
                sage, csr, d, seed=seed, stage_breakdown=stage_breakdown,
                allow_transfer=allow_transfer,
            )
        except ReplayMiss:
            raise  # the replay contract stays loud — never rescued
        except Exception as exc:
            if not resilience.enabled() or not resilience.rescuable(exc):
                raise
            # mirror of AutoSage.decide's rescue: a runnable, uncached
            # 3-stage baseline decision
            resilience.record_fault("decide", "", "attention", exc, sage.device)
            decision, tier = _rescue_attention(sage, csr, d), "fault"
    obs.REGISTRY.inc(
        "autosage_decides_total", op="attention", tier=tier, scheduler="exact"
    )
    obs.REGISTRY.observe(
        "autosage_decide_ms", (time.perf_counter() - t0) * 1e3,
        op="attention", scheduler="exact",
    )
    return decision


def _rescue_attention(sage: AutoSage, csr: CSR, d: int) -> AttentionDecision:
    feat = InputFeatures.from_csr(csr, d, "attention")
    base = registry.baseline(feat, sage.hw, sage.device)
    return AttentionDecision(
        op="attention", choice="baseline", variant=base, guardrail=None,
        from_cache=False, probe_ms={}, probe_overhead_ms=0.0,
        probe_iter_ms=0.0, estimates_ms={},
    )


def _decide_attention_impl(
    sage: AutoSage, csr: CSR, d: int, seed: int = 0, stage_breakdown: bool = False,
    allow_transfer: bool = True,
) -> tuple:
    """decide_attention body; returns (decision, tier) with tier one of
    "cache" | "transfer" | "probe"."""
    with obs.span("features", op="attention"):
        feat = InputFeatures.from_csr(csr, d, "attention")
    key = ScheduleCache.key(device_sig(sage.device), feat.graph_sig, d, "attention",
                            sage.alpha)

    cands = registry.candidates(feat, sage.hw, sage.device)
    base = registry.baseline(feat, sage.hw, sage.device)
    by_name = {v.full_name(): v for v in cands}
    by_name["baseline"] = base

    cached = sage.cache.get(key) if sage.cache is not None else None
    cached = sage.usable_pin(key, cached, by_name)
    if cached is not None:
        choice = cached["choice"]
        decision = AttentionDecision(
            op="attention", choice=choice, variant=by_name[choice], guardrail=None,
            from_cache=True, probe_ms={}, probe_overhead_ms=0.0,
            probe_iter_ms=0.0, estimates_ms={},
            stage_ms=dict(cached.get("stage_ms", {})),
        )
        telemetry.emit_attention_decision(decision, sage.device)
        return decision, "cache"

    if resilience.enabled():
        sage.breaker.maybe_sync()
    estimates, short = sage.shortlist(feat, cands)
    plan = sage.transfer_plan(key, feat, short, by_name, base, allow_transfer)
    if plan is not None and plan.confident:
        decision = AttentionDecision(
            op="attention", choice=plan.choice, variant=by_name[plan.choice],
            guardrail=plan.guardrail, from_cache=False, probe_ms={},
            probe_overhead_ms=0.0, probe_iter_ms=0.0, estimates_ms=estimates,
            transfer=plan.provenance("confirmed"),
        )
        sage.pin_entry(key, entry_with_stats(decision, feat, base.full_name()), "attention")
        obs.REGISTRY.inc("autosage_transfer_verdict_total", verdict="confirmed")
        telemetry.emit_decide_event(decision, sage.device, feat, kind="transfer")
        telemetry.emit_attention_decision(decision, sage.device)
        return decision, "transfer"
    if short:
        with obs.span("probe", op="attention", n_candidates=len(short) + 1):
            outcome = sage.probe_candidates(
                csr, base, short,
                default_probe_args("attention", d, sage.device, seed), seed=seed,
            )
        obs.REGISTRY.inc("autosage_probe_passes_total", op="attention")
        obs.REGISTRY.observe("autosage_probe_ms", outcome.overhead_ms, op="attention")
        obs.record_probe_estimates(
            "attention", outcome.probe_ms, estimates, base.full_name()
        )
    else:
        # no challengers: only the 3-stage baseline applies, skip probing
        outcome = ProbeOutcome({}, None, float("inf"), 0.0, 0.0, 0.0)
    with obs.span("guardrail", op="attention"):
        gr = apply_guardrail(
            outcome.best_name, outcome.t_best_ms, outcome.t_baseline_ms, sage.alpha,
        )
    variant = by_name[gr.choice] if gr.accepted else base

    stage_ms: Dict[str, float] = {}
    if stage_breakdown:
        stage_ms = probe_stage_breakdown(sage, csr, d, variant, seed=seed)

    decision = AttentionDecision(
        op="attention", choice=gr.choice, variant=variant, guardrail=gr,
        from_cache=False, probe_ms=outcome.probe_ms,
        probe_overhead_ms=outcome.overhead_ms, probe_iter_ms=outcome.iter_ms,
        estimates_ms=estimates, stage_ms=stage_ms,
    )
    if plan is not None:
        # the end-to-end probe doubles as the transfer's confirm pass
        verdict = "confirmed" if gr.choice == plan.choice else "flipped"
        decision.transfer = plan.provenance(verdict)
        obs.REGISTRY.inc("autosage_transfer_verdict_total", verdict=verdict)
    if sage.cache is not None:
        sage.pin_entry(key, entry_with_stats(decision, feat, base.full_name()), "attention")
    telemetry.emit_attention_decision(decision, sage.device)
    return decision, "probe"


def attention_forward(sage: AutoSage, csr: CSR, q, k, v, seed: int = 0):
    """decide + prepare + run on the full graph; returns (out, decision)."""
    d = decide_attention(sage, csr, int(q.shape[1]), seed=seed)
    return sage.build_runner(csr, d)(q, k, v), d


# ---------------------------------------------------------------------
def probe_stage_breakdown(
    sage: AutoSage, csr: CSR, d: int, variant: registry.Variant, seed: int = 0
) -> Dict[str, float]:
    """Median per-stage ms of ``variant`` on the probe subgraph.

    For composed pipelines the three stages run in each stage's own
    layout with their inputs made beforehand, so the numbers isolate
    stage cost (mixed-layout conversion shows only in the end-to-end
    probe_ms). A fused kernel is one stage."""
    sub = probe_mod.induced_subgraph(csr, frac=sage.probe_frac, seed=seed)
    q, k, v = default_probe_args("attention", d, sage.device, seed)(sub)

    def _med(fn, name):
        return probe_mod.time_callable(
            fn, sage.device, iters=sage.probe_iters, cap_ms=sage.probe_cap_ms,
            name=name,
        ).median_ms

    if variant.name in FUSED:
        run = variant.build(variant.prepare(sub), sage.device)
        return {"fused": _med(lambda: run(q, k, v), "fused")}

    s_impl = variant.knobs.get("sddmm", "gather_dot")
    m_impl = variant.knobs.get("spmm", "gather_segsum")
    needs_ell = "row_ell" in (s_impl, m_impl)
    prep = registry._prepare_attn_mixed if needs_ell else kb.prepare_csr
    dev = registry._dev(prep(sub), sage.device)
    ell = {"colind": dev["ell_colind"], "val": dev["ell_val"]} if needs_ell else None
    scale = 1.0 / (d ** 0.5)
    out: Dict[str, float] = {}

    # -- SDDMM stage (+ the softmax in the same layout)
    if s_impl == "row_ell":
        def sddmm_fn():
            return kb.sddmm_row_ell(ell, q, k) * scale

        def softmax_fn(lg):
            return kb.ell_masked_softmax(lg, ell["val"] != 0)
    else:
        def sddmm_fn():
            return kb.sddmm_gather_dot(dev, q, k) * scale

        def softmax_fn(lg):
            return kb.row_softmax(dev, lg)
    out["sddmm"] = _med(sddmm_fn, "sddmm")
    logits = sddmm_fn()
    out["softmax"] = _med(lambda: softmax_fn(logits), "softmax")
    probs = softmax_fn(logits)

    # -- value-SpMM stage, consuming probs in its own layout
    if needs_ell:
        er, es = dev["edge_row"].long(), dev["edge_slot"].long()
    if m_impl == "row_ell":
        if probs.dim() == 1:  # CSR probs -> ELL table
            table = probs.new_zeros(ell["colind"].shape)
            table[er, es] = probs
            probs = table

        def spmm_fn():
            return kb.spmm_row_ell({"colind": ell["colind"], "val": probs}, v)
    else:
        if probs.dim() == 2:  # ELL probs -> CSR values
            probs = probs[er, es]

        def spmm_fn():
            return kb.spmm_gather_segsum({**dev, "val": probs}, v)
    out["spmm"] = _med(spmm_fn, "spmm")
    return out
