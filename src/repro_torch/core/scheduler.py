"""AutoSAGE scheduler: estimate -> micro-probe -> guardrail -> cache.

Port of repro/core/scheduler.py for SpMM, SDDMM and (through
core/pipeline.py) CSR attention: the paper's §4.2 decision procedure
(`autosage_decide`) with the persistent cache fast path, slope probing
on induced subgraphs with identical sampling per candidate, the top-k
shortlist by roofline estimate and the non-regression guardrail
(Prop. 1).

On an exact-key miss, a peer device class's probed entry for the same
graph (core/transfer.py) can stand in for the probe: a confident
re-rank under the local roofline is pinned and served with zero probes,
a non-confident one is confirmed or flipped by the normal probe.

With resilience on (AUTOSAGE_RESILIENCE, default 1; core/resilience.py)
each probe runs sandboxed under a watchdog, a faulting candidate feeds
the per-(candidate, device) circuit breaker, quarantined candidates
leave the shortlist, a quarantined pin is re-decided (or raises
`ReplayMiss` in replay mode), a fault anywhere in the decision
machinery yields an uncached baseline decision, and `build_runner`
returns the fallback chain (chosen variant -> library baseline ->
reference oracle). Every fault and fallback is counted
(``autosage_faults_total``, ``autosage_fallback_total``), so a run can
prove that no kernel hid behind a fallback. A sticky CUDA error
re-raises: nothing can run after it. On a card the probe sandbox and
the chain absorb only injected faults and watchdog timeouts; a real
fault of a kernel is counted and re-raised (`resilience.must_raise`).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import estimate as est
from repro_torch.core import features as features_mod
from repro_torch.core import obs
from repro_torch.core import probe as probe_mod
from repro_torch.core import registry
from repro_torch.core import resilience
from repro_torch.core import telemetry
from repro_torch.core import transfer as transfer_mod
from repro_torch.core.cache import ReplayMiss, ScheduleCache
from repro_torch.core.features import (
    HardwareSpec,
    InputFeatures,
    device_sig,
    resolve_device,
    waste_bin,
)
from repro_torch.core.guardrail import GuardrailDecision, apply_guardrail
from repro_torch.sparse.csr import CSR, graph_signature


@dataclasses.dataclass
class ProbeOutcome:
    """Result of one slope-probe pass over a candidate shortlist."""

    probe_ms: Dict[str, float]  # candidate full-name -> effective cost
    best_name: Optional[str]
    t_best_ms: float
    t_baseline_ms: float
    overhead_ms: float  # wall time incl. prepare + warm-up
    iter_ms: float  # steady-state probe iterations only


def default_probe_args(
    op: str, f: int, device: torch.device, seed: int = 0
) -> Callable[[CSR], tuple]:
    """Random dense operands of width f on ``device``, per subgraph,
    shaped for ``op``'s compute kind: (B,) for SpMM, (vals, B) for
    runtime-valued SpMM (a random nnz-vector standing in for the per-edge
    cotangent), (X, Y) for SDDMM, (q, k, v) for attention. Grad ops get
    cotangent-shaped operands: "spmm_bwd_b" runs on the transpose, so its
    B is (n_cols of the transpose, F_grad)."""
    kind = features_mod.op_kind(op)
    dynamic = features_mod.op_dynamic_vals(op)

    def fn(sub: CSR) -> tuple:
        # per-subgraph stream: the 1x and 2x probe subgraphs must not get
        # byte-identical operands (a warm cache would bias the slope)
        rng = np.random.default_rng((seed, sub.n_rows, sub.nnz))
        if kind == "spmm":
            shapes = [(sub.nnz,), (sub.n_cols, f)] if dynamic else [(sub.n_cols, f)]
        elif kind == "sddmm":
            shapes = [(sub.n_rows, f), (sub.n_cols, f)]
        else:
            shapes = [(sub.n_rows, f), (sub.n_cols, f), (sub.n_cols, f)]
        return tuple(
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
            for shape in shapes
        )

    return fn


@dataclasses.dataclass
class Decision:
    op: str
    choice: str  # "baseline" or variant full-name
    variant: registry.Variant  # the variant to run (baseline if fallback)
    guardrail: Optional[GuardrailDecision]
    from_cache: bool
    probe_ms: Dict[str, float]  # candidate -> median ms (empty if cached)
    probe_overhead_ms: float
    probe_iter_ms: float
    estimates_ms: Dict[str, float]
    # cross-device provenance (core/transfer.py): set when this decision
    # was transferred from a peer device's probed ranking — source_device,
    # verdict (confirmed/pending/flipped), rank_agreement, predicted_ms
    transfer: Optional[Dict[str, Any]] = None

    def to_cache_entry(self) -> Dict[str, Any]:
        entry: Dict[str, Any] = {
            "choice": self.choice,
            "probe_ms": self.probe_ms,
            "estimates_ms": self.estimates_ms,
        }
        if self.transfer is not None:
            entry["transfer"] = dict(self.transfer)
        return entry


def entry_with_stats(
    decision: Decision,
    feat: InputFeatures,
    base_full_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Cache entry + running stats + the device-neutral part (input
    features and the probed ranking), laid out as the JAX package writes
    it. A transferred-but-unprobed entry keeps ``probed_at`` 0.0, so any
    real measurement beats it in the fleet merge."""
    entry = decision.to_cache_entry()
    probed = bool(decision.probe_ms)
    entry["probed"] = probed
    entry["neutral"] = {
        "features": feat.to_neutral(),
        "ranking": transfer_mod.build_ranking(
            decision.probe_ms, decision.estimates_ms,
            base_full_name or "baseline",
        ),
        "op": decision.op,
        "f": feat.f,
        "waste_bin": waste_bin(feat.padding_waste),
    }
    entry["stats"] = {
        "probe_est_ms": decision.probe_ms.get(decision.choice),
        "waste_at_probe": feat.padding_waste,
        "probed_at": time.time() if probed else 0.0,
        "probes": 1 if probed else 0,
    }
    return entry


def _build_raw(csr: CSR, decision: Decision, graph_sig: str,
               device: torch.device) -> Callable:
    """Prepare ``decision``'s variant on the full graph and upload it:
    the runner without a fallback chain."""
    with obs.span("prepare", op=decision.op, choice=decision.choice):
        aux = decision.variant.timed_prepare(csr)
        runner = decision.variant.build(aux, device)
    padding = {k: float(v) for k, v in aux.items() if k.endswith("padding_frac")}
    if padding:
        telemetry.emit_decide_event(decision, device, padding=padding, graph_sig=graph_sig,
                                    kind="prepare")
    return runner


class AutoSage:
    """Holds the cache, the device and its roofline profile.

    ``device=None`` means CUDA; without a card that raises unless the
    caller passes ``device="cpu"``."""

    def __init__(
        self,
        alpha: Optional[float] = None,
        top_k: Optional[int] = None,
        cache: Optional[ScheduleCache] = None,
        hw: Optional[HardwareSpec] = None,
        probe_frac: Optional[float] = None,
        probe_iters: Optional[int] = None,
        probe_cap_ms: Optional[float] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.alpha = float(os.environ.get("AUTOSAGE_ALPHA", 0.95)) if alpha is None else alpha
        self.top_k = int(os.environ.get("AUTOSAGE_TOPK", 3)) if top_k is None else top_k
        self.cache = cache if cache is not None else ScheduleCache()
        self.hw = hw or HardwareSpec.current(self.device)
        self.probe_frac = probe_frac if probe_frac is not None else probe_mod.DEFAULT_FRAC
        self.probe_iters = probe_iters if probe_iters is not None else probe_mod.DEFAULT_ITERS
        self.probe_cap_ms = probe_cap_ms if probe_cap_ms is not None else probe_mod.DEFAULT_CAP_MS
        # built-runner memo, LRU-bounded: prepare() is O(nnz) host work
        # plus an upload, paid once per (graph, op, choice)
        self._runners: Dict[tuple, Callable] = {}
        self._runner_cap = int(os.environ.get("AUTOSAGE_RUNNER_CACHE", "64"))
        # per-(candidate, device) circuit breaker (core/resilience.py): its
        # quarantine records persist through the cache, so fleet workers
        # share the blacklist
        self.breaker = resilience.CircuitBreaker(cache=self.cache, device=self.device)

    # ------------------------------------------------------------------
    def probe_candidates(
        self,
        csr: CSR,
        base: registry.Variant,
        shortlist: List[registry.Variant],
        args_fn: Callable[[CSR], tuple],
        seed: int = 0,
    ) -> ProbeOutcome:
        """Slope-mode micro-probe of baseline + shortlist (paper §4.2):
        every candidate is timed on TWO induced subgraphs (1x and 2x
        rows) with identical sampling, and the cost slope between them,
        extrapolated to the full graph, cancels fixed launch overhead.
        AUTOSAGE_PROBE_MODE=point restores the paper's single point."""
        mode = os.environ.get("AUTOSAGE_PROBE_MODE", "slope")
        t_probe0 = time.perf_counter()
        sub1 = probe_mod.induced_subgraph(csr, frac=self.probe_frac, seed=seed)
        subs = [sub1]
        if mode == "slope" and sub1.n_rows * 2 <= csr.n_rows:
            subs.append(
                probe_mod.induced_subgraph(csr, seed=seed, n_rows=sub1.n_rows * 2)
            )
        args_per_sub = [args_fn(s) for s in subs]
        iter_ms_total = [0.0]

        def _time(v: registry.Variant) -> float:
            times = []
            for sub, args in zip(subs, args_per_sub):
                run = v.build(v.timed_prepare(sub), self.device)
                res = probe_mod.time_callable(
                    lambda: run(*args), self.device, iters=self.probe_iters,
                    cap_ms=self.probe_cap_ms, name=v.full_name(),
                )
                iter_ms_total[0] += sum(res.times_ms)
                times.append(res.median_ms)
            if len(times) == 2:
                slope = (times[1] - times[0]) / max(subs[1].n_rows - subs[0].n_rows, 1)
                if slope > 0:
                    return slope * csr.n_rows  # extrapolated marginal cost
            return times[-1]

        def _sandboxed_time(v: registry.Variant) -> Optional[float]:
            """Probe one candidate under the watchdog; a candidate that
            raises or hangs drops out of this pass (None) instead of
            aborting it, and its failure feeds the breaker. A fault is
            not a measurement, so nothing lands in probe_ms. A fault
            that `resilience.must_raise` (on a card: any real one) is
            counted and re-raised."""
            name = v.full_name()
            if not resilience.enabled():
                return _time(v)
            try:
                t = resilience.run_with_timeout(
                    lambda: _time(v), resilience.policy_for("probe").timeout_s,
                    "probe", name=name,
                )
                if not v.is_baseline:
                    self.breaker.record_success(name)
                return t
            except Exception as exc:
                resilience.record_fault("probe", name, v.op, exc, self.device)
                if resilience.must_raise(exc, self.device):
                    raise resilience.surface(exc)
                if not v.is_baseline:  # the lifeline is never blacklisted
                    self.breaker.record_failure(
                        name, site="probe", op=v.op,
                        permanent=resilience.classify(exc) == resilience.PERMANENT,
                    )
                return None

        probe_ms: Dict[str, float] = {}
        tb = _sandboxed_time(base)
        if tb is not None:
            probe_ms["baseline"] = tb
        else:
            # a faulting baseline probe must not veto a working
            # challenger: an infinite reference cost accepts whichever
            # candidate measured clean (the run-time chain still guards)
            tb = float("inf")
        best_name, t_star = None, float("inf")
        for v in shortlist:
            t = _sandboxed_time(v)
            if t is None:
                continue
            probe_ms[v.full_name()] = t
            if t < t_star:
                best_name, t_star = v.full_name(), t
        return ProbeOutcome(
            probe_ms=probe_ms,
            best_name=best_name,
            t_best_ms=t_star,
            t_baseline_ms=tb,
            overhead_ms=(time.perf_counter() - t_probe0) * 1e3,
            iter_ms=iter_ms_total[0],
        )

    def shortlist(
        self, feat: InputFeatures, cands: List[registry.Variant]
    ) -> tuple:
        """Estimate stage: (estimates_ms, top-k non-baseline candidates)."""
        with obs.span("estimate", op=feat.op, n_candidates=len(cands)):
            estimates = est.estimates_for(feat, self.hw, cands)
        with obs.span("shortlist", op=feat.op, top_k=self.top_k):
            short = sorted(
                (v for v in cands
                 if not v.is_baseline and not self.breaker.is_excluded(v.full_name())),
                key=lambda v: estimates[v.full_name()],
            )[: self.top_k]
        return estimates, short

    # ------------------------------------------------------------------
    def decide(
        self,
        csr: CSR,
        f: int,
        op: str,
        probe_args_fn: Optional[Callable[[CSR], tuple]] = None,
        seed: int = 0,
        allow_transfer: bool = True,
    ) -> Decision:
        """The paper's `autosage_decide(features, F, op)`.

        ``allow_transfer=False`` forces a real local measurement on an
        exact-key miss (the batch scheduler's confirm and drift re-probes
        use it). With resilience on, a fault inside the decision
        machinery yields an uncached baseline decision (tier "fault");
        `ReplayMiss`, sticky CUDA errors and, on a card, a kernel's real
        fault (`resilience.rescuable`) always raise."""
        t0 = time.perf_counter()
        with obs.span("decide", op=op, f=f, scheduler="exact"):
            try:
                decision, tier = self._decide_impl(
                    csr, f, op, probe_args_fn=probe_args_fn, seed=seed,
                    allow_transfer=allow_transfer,
                )
            except ReplayMiss:
                raise  # the replay contract stays loud — never rescued
            except Exception as exc:
                if not resilience.enabled() or not resilience.rescuable(exc):
                    raise
                resilience.record_fault("decide", "", op, exc, self.device)
                decision, tier = self._rescue_decision(csr, f, op), "fault"
        obs.REGISTRY.inc("autosage_decides_total", op=op, tier=tier, scheduler="exact")
        obs.REGISTRY.observe(
            "autosage_decide_ms", (time.perf_counter() - t0) * 1e3,
            op=op, scheduler="exact",
        )
        return decision

    def _rescue_decision(self, csr: CSR, f: int, op: str) -> Decision:
        """Provisional baseline decision for the decide-path rescue: not
        cached (the fault may be transient), never a poisoned pin."""
        feat = InputFeatures.from_csr(csr, f, op)
        base = registry.baseline(feat, self.hw, self.device)
        return Decision(
            op=op, choice="baseline", variant=base, guardrail=None,
            from_cache=False, probe_ms={}, probe_overhead_ms=0.0,
            probe_iter_ms=0.0, estimates_ms={},
        )

    def usable_pin(self, key: str, cached: Optional[Dict[str, Any]],
                   by_name: Dict[str, registry.Variant]) -> Optional[Dict[str, Any]]:
        """The cached entry if its choice may be served here, else None
        (re-decide). A pin that is quarantined (resilience on) or that
        this process cannot construct raises `ReplayMiss` in replay mode
        — never a silent substitute — and is re-decided otherwise."""
        if cached is None:
            return None
        choice = cached.get("choice")
        why = None
        if choice not in by_name:
            why = "is not a candidate here"
        elif resilience.enabled() and choice != "baseline":
            self.breaker.maybe_sync()
            if self.breaker.is_quarantined(choice):
                why = "is quarantined"
        if why is None:
            return cached
        if self.cache.replay_only:
            raise ReplayMiss(
                f"pinned choice {choice!r} for {key} {why} "
                "(AUTOSAGE_REPLAY_ONLY=1 forbids substituting)"
            )
        return None

    def transfer_plan(self, key: str, feat: InputFeatures, short: list,
                      by_name: Dict[str, registry.Variant], base: registry.Variant,
                      allow_transfer: bool):
        """The transfer tier's plan for an exact-key miss, or None: a
        peer device class's probed entry for the same regime re-ranked
        under the local roofline (core/transfer.py)."""
        if not (allow_transfer and short and transfer_mod.enabled()
                and self.cache is not None and not self.cache.replay_only):
            return None
        return transfer_mod.best_plan(
            self.cache.peer_entries(key), feat, self.hw, by_name, base, self.alpha,
            excluded=self.breaker.excluded_names(),
        )

    def pin_entry(self, key: str, entry: Dict[str, Any], op: str) -> None:
        """Pin an entry; a failed write (lock timeout, injected fault,
        disk error) is counted and the decision still returned, the
        entry left dirty for the next flush."""
        with resilience.cache_guard(op=op):
            self.cache.put(key, entry)

    def _decide_impl(
        self,
        csr: CSR,
        f: int,
        op: str,
        probe_args_fn: Optional[Callable[[CSR], tuple]] = None,
        seed: int = 0,
        allow_transfer: bool = True,
    ) -> tuple:
        """decide() body; returns (Decision, tier) with tier one of
        "cache" | "transfer" | "probe"."""
        with obs.span("features", op=op):
            feat = InputFeatures.from_csr(csr, f, op)
        key = ScheduleCache.key(device_sig(self.device), feat.graph_sig, f, op, self.alpha)

        cands = registry.candidates(feat, self.hw, self.device)
        base = registry.baseline(feat, self.hw, self.device)
        by_name = {v.full_name(): v for v in cands}
        by_name["baseline"] = base

        cached = self.cache.get(key) if self.cache is not None else None
        cached = self.usable_pin(key, cached, by_name)
        if cached is not None:
            choice = cached["choice"]
            decision = Decision(
                op=op, choice=choice, variant=by_name[choice], guardrail=None,
                from_cache=True, probe_ms={}, probe_overhead_ms=0.0,
                probe_iter_ms=0.0, estimates_ms={},
            )
            telemetry.emit_decide_event(decision, self.device, feat)
            return decision, "cache"

        if resilience.enabled():
            # cold path: fold in the quarantines peers persisted since our
            # last look before shortlisting and transferring
            self.breaker.maybe_sync()
        estimates, short = self.shortlist(feat, cands)
        plan = self.transfer_plan(key, feat, short, by_name, base, allow_transfer)
        if plan is not None and plan.confident:
            decision = Decision(
                op=op, choice=plan.choice, variant=by_name[plan.choice],
                guardrail=plan.guardrail, from_cache=False, probe_ms={},
                probe_overhead_ms=0.0, probe_iter_ms=0.0, estimates_ms=estimates,
                transfer=plan.provenance("confirmed"),
            )
            self.pin_entry(key, entry_with_stats(decision, feat, base.full_name()), op)
            obs.REGISTRY.inc("autosage_transfer_verdict_total", verdict="confirmed")
            telemetry.emit_decide_event(decision, self.device, feat, kind="transfer")
            return decision, "transfer"

        if short:
            with obs.span("probe", op=op, n_candidates=len(short) + 1):
                outcome = self.probe_candidates(
                    csr, base, short,
                    probe_args_fn or default_probe_args(op, f, self.device, seed),
                    seed=seed,
                )
            obs.REGISTRY.inc("autosage_probe_passes_total", op=op)
            obs.REGISTRY.observe("autosage_probe_ms", outcome.overhead_ms, op=op)
            obs.record_probe_estimates(op, outcome.probe_ms, estimates, base.full_name())
        else:
            # no challengers: the decision can only be baseline
            outcome = ProbeOutcome({}, None, float("inf"), 0.0, 0.0, 0.0)

        with obs.span("guardrail", op=op):
            gr = apply_guardrail(
                outcome.best_name, outcome.t_best_ms, outcome.t_baseline_ms,
                self.alpha,
            )
        variant = by_name[gr.choice] if gr.accepted else base
        decision = Decision(
            op=op, choice=gr.choice, variant=variant, guardrail=gr,
            from_cache=False, probe_ms=outcome.probe_ms,
            probe_overhead_ms=outcome.overhead_ms,
            probe_iter_ms=outcome.iter_ms, estimates_ms=estimates,
        )
        if plan is not None:
            # the probe doubles as the transfer's confirm measurement
            verdict = "confirmed" if gr.choice == plan.choice else "flipped"
            decision.transfer = plan.provenance(verdict)
            obs.REGISTRY.inc("autosage_transfer_verdict_total", verdict=verdict)
        if self.cache is not None:
            self.pin_entry(key, entry_with_stats(decision, feat, base.full_name()), op)
        telemetry.emit_decide_event(decision, self.device, feat)
        return decision, "probe"

    # ------------------------------------------------------------------
    def build_runner(self, csr: CSR, decision: Decision) -> Callable:
        """Prepare the chosen variant on the FULL graph, upload it to the
        device and return its runner (memoized per graph/op/choice). With
        resilience on, the runner is the fallback chain — chosen variant
        -> library baseline -> reference oracle — built lazily at its
        first call, so a choice that raises at prepare or run time
        degrades instead of failing the call, and its failures feed the
        breaker (core/resilience.py)."""
        key = (graph_signature(csr), decision.op, decision.choice)
        runner = self._runners.pop(key, None)
        if runner is None:
            if resilience.enabled():
                runner = self._build_chain(csr, decision, graph_sig=key[0])
            else:
                runner = _build_raw(csr, decision, key[0], self.device)
            while len(self._runners) >= max(self._runner_cap, 1):
                self._runners.pop(next(iter(self._runners)))
        self._runners[key] = runner  # (re)insert at MRU position
        return runner

    def _build_chain(self, csr: CSR, decision: Decision, graph_sig: str) -> Callable:
        """Fallback-chain runner. Stage 0 (the pinned choice) is the raw
        build, padding telemetry included, so the fault-free path runs
        exactly what the unwrapped runner runs. The stages close over
        the device, never over this AutoSage: a runner in the memo that
        referred back to its scheduler would keep both (and the layouts
        on the card) alive until a garbage-collector pass."""
        device, hw = self.device, self.hw

        def build_choice(args):
            return _build_raw(csr, decision, graph_sig, device)

        stages = [(decision.choice, build_choice, True)]
        if decision.choice != "baseline":
            stages += resilience.fallback_stages(csr, decision.op, "baseline", None, hw, device)
        else:
            # the choice IS the baseline: it fronts the chain, backed by
            # the oracle only
            stages.append(("reference",
                           lambda args: resilience.reference_runner(csr, decision.op, device),
                           False))
        return resilience.chain_runner(stages, decision.op, breaker=self.breaker,
                                       device=device)

    # ---- pipeline-level CSR attention (core/pipeline.py) -------------
    def decide_attention(self, csr: CSR, d: int, seed: int = 0,
                         stage_breakdown: bool = False, allow_transfer: bool = True):
        """Joint decision over the composed {sddmm x softmax x spmm}
        pipelines and the fused CUDA kernels; cached under op="attention"."""
        from repro_torch.core import pipeline

        return pipeline.decide_attention(
            self, csr, d, seed=seed, stage_breakdown=stage_breakdown,
            allow_transfer=allow_transfer,
        )

    def attention(self, csr: CSR, q, k, v, seed: int = 0):
        """Decide + prepare + run on the full graph; returns (out,
        decision). `repro_torch.api.attention(csr, q, k, v, sage=...)` is
        the entry point; this keeps `repro`'s method for callers that want
        the decision too."""
        from repro_torch.core import pipeline

        return pipeline.attention_forward(self, csr, q, k, v, seed=seed)
