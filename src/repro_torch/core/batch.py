"""Batched multi-graph scheduling: bucketed decisions under one probe
budget.

Port of repro/core/batch.py. `AutoSage.decide` is priced for one graph
at a time: every cache miss pays an induced-subgraph probe. Minibatched
GNN training, the workload the paper targets, serves thousands of
sampled subgraphs per epoch, each slightly different, so per-graph
probing either dominates step time or never warms the cache.
`BatchScheduler` uses that the winning mapping is stable across coarse
feature regimes:

  1. every incoming graph's `InputFeatures` canonicalize into a coarse
     `ScheduleBucket` (core/features.py), so near-identical sampled
     subgraphs share one decision;
  2. probing is amortized under a shared per-stream probe-time budget:
     an unprobed bucket serves the guardrail baseline provisionally,
     pending buckets are ranked by traffic-weighted estimated gain
     (hits x roofline headroom), and a bucket's decision upgrades in
     place once its probe completes;
  3. every decide is recorded in a stream trace, and `finalize()` pins
     every bucket decision into the cache (bucket keys, core/cache.py),
     so a whole epoch replays under AUTOSAGE_REPLAY_ONLY=1;
  4. `observe(bucket, ms)` feeds a windowed EWMA of the runtimes the
     trainer saw, and the drift detector re-enqueues a bucket on the
     budget (with decayed priority) when that EWMA departs from its
     calibrated reference by AUTOSAGE_DRIFT_RATIO, or when the incoming
     graphs' padding_waste moves AUTOSAGE_DRIFT_WASTE_DELTA away from
     the probe representative's. The re-probe runs on the newest graph
     seen in the bucket;
  5. fleet and cross-device: on a shared cache a new bucket first folds
     in peers' flushes (`ScheduleCache.maybe_reload`), and a bucket no
     entry pins opens from a peer device class's probed ranking when
     one exists (the transfer tier, core/transfer.py): a confident
     transfer is final with zero probes, any other serves its choice
     while one budgeted confirm probe waits;
  6. resilience (core/resilience.py): a quarantined pinned choice is
     re-probed (or raises `ReplayMiss` in replay mode), and a pinned
     choice that faulted at run time re-opens its bucket
     (`_check_fault_retire`), so no bucket serves a fallback forever
     under its pinned name.

Entry points mirror `AutoSage` (`decide`, `build_runner`, `spmm`,
`sddmm`, `attention`), so model code written against `AutoSage`
(models/gnn.py, core/autodiff.py) takes a `BatchScheduler` unchanged.
The serving tier (launch/serve.py) runs it with ``auto_pump=False``,
pumps on a background worker and hears of every in-place upgrade
through `on_upgrade`. A cached choice this process cannot construct
raises `ReplayMiss` in replay mode (the JAX package serves the baseline
under its name) and is re-probed otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.core import obs, registry, resilience, telemetry
from repro_torch.core import transfer as transfer_mod
from repro_torch.core.cache import ScheduleCache
from repro_torch.core.features import (
    InputFeatures,
    ScheduleBucket,
    device_sig,
    waste_bin,
)
from repro_torch.core.scheduler import AutoSage, Decision
from repro_torch.sparse.csr import CSR

DEFAULT_PROBE_BUDGET_MS = float(os.environ.get("AUTOSAGE_BATCH_BUDGET_MS", "2000"))
# observed-runtime EWMA: the exact running mean for the first WINDOW
# observations (permutation-invariant startup), then exponential with
# beta = 1/WINDOW
DEFAULT_EWMA_WINDOW = int(os.environ.get("AUTOSAGE_EWMA_WINDOW", "16"))
# drift fires when ewma / reference leaves [1/ratio, ratio] ...
DEFAULT_DRIFT_RATIO = float(os.environ.get("AUTOSAGE_DRIFT_RATIO", "1.5"))
# ... but only after this many observations since the last (re-)probe
DEFAULT_DRIFT_MIN_OBS = int(os.environ.get("AUTOSAGE_DRIFT_MIN_OBS", "5"))
# each re-probe decays the bucket's pump priority by this factor, so a
# flapping bucket cannot starve never-probed buckets of the budget
DEFAULT_DRIFT_DECAY = float(os.environ.get("AUTOSAGE_DRIFT_DECAY", "0.5"))
# padding-waste drift: |live waste - waste_at_probe| >= this flags the
# bucket (one waste bin spans up to 0.5 of raw waste, and dense-W padded
# work scales like 1/(1 - waste))
DEFAULT_DRIFT_WASTE_DELTA = float(
    os.environ.get("AUTOSAGE_DRIFT_WASTE_DELTA", "0.25")
)


def _attention_family(choice: Optional[str]) -> str:
    """Coarse family of an attention choice for flip telemetry: fused or
    composed, not which layout pair won."""
    if choice is None:
        return "none"
    if choice == "baseline":
        return "baseline"
    if "attention" in choice:  # fused_attention_cuda / ragged_attention_cuda
        return "fused"
    return "composed"  # pipe[sddmm=...,spmm=...]


@dataclasses.dataclass
class _BucketState:
    """Everything the stream knows about one schedule bucket."""

    bucket: ScheduleBucket
    key: str  # bucket-level cache key
    rep_csr: CSR  # first graph seen: the probe representative
    rep_feat: InputFeatures
    base: registry.Variant
    by_name: Dict[str, registry.Variant]
    estimates_ms: Dict[str, float]
    est_gain_ms: float  # roofline headroom: baseline est - best challenger est
    has_challengers: bool
    hits: int = 0
    probed: bool = False  # a final (probed or cached) decision exists
    probing: bool = False  # claimed by an in-flight probe
    decision: Optional[Decision] = None  # None => provisional baseline
    provisional: Optional[Decision] = None
    probe_charge_ms: float = 0.0
    # online statistics and drift state (schema v4)
    obs: int = 0  # observations since the last (re-)probe
    ewma_ms: Optional[float] = None  # windowed EWMA of observed runtimes
    probe_est_ms: Optional[float] = None  # probe-measured ms of the choice
    waste_at_probe: Optional[float] = None  # rep padding_waste at probe time
    # the runtime-drift reference: the mean of the first drift_min_obs
    # observations after a (re-)probe (slope-probe ms exclude per-call
    # dispatch, so they are no reference for wall times); a warm-opened
    # bucket inherits the cached entry's EWMA instead
    ref_ms: Optional[float] = None
    _first_sum: float = 0.0
    reprobes: int = 0  # completed drift re-probes
    drift_flagged: bool = False  # pending on the budget for a re-probe
    drift_reason: str = ""
    hits_flushed: int = 0  # hits already pushed into the cache
    # newest graph seen: the re-probe representative after a drift flag
    last_csr: Optional[CSR] = None
    last_feat: Optional[InputFeatures] = None
    # cross-device transfer state (core/transfer.py)
    transferred: bool = False  # opened from a peer device's probed ranking
    transfer_verdict: str = ""  # "confirmed" | "pending" | "flipped"
    transfer_choice: Optional[str] = None  # the re-ranked winner served
    transfer_info: Optional[Dict[str, Any]] = None  # provenance record

    def current(self) -> Decision:
        return self.decision if self.decision is not None else self.provisional

    def priority(self) -> tuple:
        """Traffic-weighted estimated gain; positive-headroom buckets
        outrank zero-headroom ones, ties break on traffic. Every completed
        re-probe decays the weight, so drift-flapping buckets yield the
        budget to fresh ones."""
        decay = DEFAULT_DRIFT_DECAY ** self.reprobes
        gain = max(self.est_gain_ms, 0.0)
        if self.drift_flagged and gain == 0.0:
            # the observed runtime says the estimate is stale
            gain = 1e-6
        return (gain > 0.0, self.hits * gain * decay, self.hits * decay)


class BatchScheduler:
    """Serves a stream of graphs through bucketed, budgeted decisions.

    Wraps (and shares the cache, device and hardware spec of) an
    `AutoSage`. Use as a context manager, or call `finalize()`, at the end
    of a stream or epoch so every bucket decision (provisional baselines
    included) is pinned into the cache for deterministic replay. Decides
    may come from several threads: bucket state changes under one lock,
    and `pump()` releases it while a probe runs.
    """

    def __init__(
        self,
        sage: Optional[AutoSage] = None,
        probe_budget_ms: float = DEFAULT_PROBE_BUDGET_MS,
        max_probes_per_decide: int = 1,
        auto_pump: bool = True,
        seed: int = 0,
    ):
        self.sage = sage if sage is not None else AutoSage()
        self.cache: ScheduleCache = self.sage.cache
        self.probe_budget_ms = probe_budget_ms
        self.max_probes_per_decide = max_probes_per_decide
        self.auto_pump = auto_pump
        self.seed = seed
        self.ewma_window = DEFAULT_EWMA_WINDOW
        self.drift_ratio = DEFAULT_DRIFT_RATIO
        self.drift_min_obs = DEFAULT_DRIFT_MIN_OBS
        self.drift_waste_delta = DEFAULT_DRIFT_WASTE_DELTA
        self._device = device_sig(self.sage.device)
        self._lock = threading.RLock()
        # upgrade notification: called outside every lock with the probe
        # event dict each time a bucket's decision upgrades in place (the
        # serving tier counts and announces background upgrades with it)
        self.on_upgrade: Optional[Callable[[Dict[str, Any]], None]] = None
        # per-decide results (last_bucket, last_source,
        # last_inline_probes) belong to the deciding thread
        self._decide_tls = threading.local()
        self._buckets: Dict[str, _BucketState] = {}
        # observe() routing, keyed by the full bucket: sig() omits op, F
        # and device, so same-shape buckets of two ops would swallow each
        # other's observations
        self._by_bucket: Dict[ScheduleBucket, _BucketState] = {}
        self.probe_spent_ms = 0.0
        self.trace: List[Dict[str, Any]] = []
        self._decides = obs.ScopedCounter("autosage_decides_total")
        self._probe_passes = obs.ScopedCounter("autosage_bucket_probe_passes_total")
        self._decide_wall_ms = 0.0
        self._warm_opens = obs.ScopedCounter("autosage_bucket_warm_opens_total")
        self._drift_flags = obs.ScopedCounter("autosage_drift_events_total")
        self._drift_reprobes = obs.ScopedCounter("autosage_drift_events_total")
        self._drift_flips = obs.ScopedCounter("autosage_drift_events_total")
        # cross-device transfer accounting (core/transfer.py)
        self._transfers = obs.ScopedCounter("autosage_transfers_total")
        self._transfers_confirmed = obs.ScopedCounter("autosage_transfer_verdict_total")
        self._transfers_flipped = obs.ScopedCounter("autosage_transfer_verdict_total")
        self._transfer_probe_free = obs.ScopedCounter("autosage_transfer_probe_free_total")

    # counter views: the names tests and benchmarks read (`bs.transfers`,
    # `bs.drift_flags`, ...) stay plain ints backed by the registry path
    @property
    def drift_flags(self) -> int:
        return self._drift_flags.value

    @property
    def drift_reprobes(self) -> int:
        return self._drift_reprobes.value

    @property
    def drift_flips(self) -> int:
        return self._drift_flips.value

    @property
    def transfers(self) -> int:
        return self._transfers.value

    @property
    def transfers_confirmed(self) -> int:
        return self._transfers_confirmed.value

    @property
    def transfers_flipped(self) -> int:
        return self._transfers_flipped.value

    @property
    def transfer_probe_free(self) -> int:
        return self._transfer_probe_free.value

    # per-decide views, local to the deciding thread
    @property
    def last_bucket(self) -> Optional[ScheduleBucket]:
        """The bucket of the calling thread's last decide: the handle for
        "observe the decide I just made" without a second feature pass."""
        return getattr(self._decide_tls, "bucket", None)

    @property
    def last_source(self) -> Optional[str]:
        """Tier the calling thread's last decide served from:
        "bucket-cache" | "transfer" | "transfer-pending" | "probe" |
        "drift-pending" | "provisional"."""
        return getattr(self._decide_tls, "source", None)

    @property
    def last_inline_probes(self) -> int:
        """Bucket probes the calling thread's last decide ran inline
        (always 0 with auto_pump=False): the serving tier's stall
        detector reads it."""
        return getattr(self._decide_tls, "inline_probes", 0)

    def _emit(self, event: Dict[str, Any]) -> None:
        telemetry.emit_batch_event(event, self.sage.device)

    # ---------------------------------------------------------- decide
    def decide(self, csr: CSR, f: int, op: str) -> Decision:
        """Bucketed decide: feature extraction on the hot path; probing is
        drawn from the shared budget (at most `max_probes_per_decide`
        bucket probes per call)."""
        t0 = time.perf_counter()
        with obs.span("decide", op=op, f=f, scheduler="batch"):
            with obs.span("features", op=op):
                feat = InputFeatures.from_csr(csr, f, op)
            bucket = ScheduleBucket.from_features(feat, self._device)
            key = ScheduleCache.bucket_key(self._device, bucket.sig(), f, op,
                                           self.sage.alpha)
            with self._lock:
                st = self._buckets.get(key)
                if st is None:
                    if (self.cache.shared and not self.cache.replay_only
                            and not self.cache.contains(key)):
                        # a fleet peer may have probed this bucket since
                        # the load: one mtime stat before paying a probe.
                        # Never in replay mode: replay serves the file as
                        # loaded
                        self.cache.maybe_reload()
                    st = self._open_bucket(bucket, key, csr, feat)
                    self._buckets[key] = st
                    self._by_bucket[bucket] = st
                st.hits += 1
                st.last_csr, st.last_feat = csr, feat
                self._decide_tls.bucket = bucket
                self._check_waste_drift(st, feat)
                self._check_fault_retire(st)
            # probing runs outside the state lock; set on every path, so
            # a warm decide never reads a previous request's count
            inline_probes = 0
            if self.auto_pump and not self.cache.replay_only:
                inline_probes = self.pump(self.max_probes_per_decide)
            self._decide_tls.inline_probes = inline_probes
            with self._lock:
                d = st.current()
                if st.probed and st.decision is not None and st.decision.from_cache:
                    source = "bucket-cache"
                elif (st.probed and st.decision is not None
                      and st.decision.transfer is not None and not st.decision.probe_ms):
                    # confident cross-device transfer: final, no local probe
                    source = "transfer"
                elif st.probed:
                    source = "probe"
                elif st.transferred and st.transfer_verdict == "pending":
                    # transferred choice serving while its confirm probe
                    # waits on the budget
                    source = "transfer-pending"
                elif st.decision is not None:
                    # flagged bucket awaiting its re-probe: the last pinned
                    # decision keeps serving
                    source = "drift-pending"
                else:
                    source = "provisional"
        self._decide_tls.source = source
        wall_ms = (time.perf_counter() - t0) * 1e3
        self._decide_wall_ms += wall_ms
        obs.REGISTRY.observe("autosage_decide_ms", wall_ms, op=op, scheduler="batch")
        self._record(st, d, source)
        return d

    def _open_bucket(
        self, bucket: ScheduleBucket, key: str, csr: CSR, feat: InputFeatures
    ) -> _BucketState:
        hw, device = self.sage.hw, self.sage.device
        cands = registry.candidates(feat, hw, device)
        base = registry.baseline(feat, hw, device)
        by_name = {v.full_name(): v for v in cands}
        by_name["baseline"] = base

        # replay / warm start: a pinned bucket decision ends the story; in
        # replay-only mode a miss raises ReplayMiss, and so does a pinned
        # choice that is quarantined or that this process cannot build
        # (never a silent substitute); outside replay both are re-probed
        cached = self.sage.usable_pin(key, self.cache.get(key), by_name)
        # outside replay a never-probed provisional baseline ("probed":
        # False, pinned by a finalize without budget) is not final either,
        # unless it is a transfer the policy accepted ("confirmed", zero
        # probes by design); a transfer still "pending" re-opens pending
        transfer_confirmed = (
            isinstance(cached, dict)
            and (cached.get("transfer") or {}).get("verdict") == "confirmed"
        )
        cached_unusable = (
            cached is not None and not self.cache.replay_only
            and cached.get("probed") is False and not transfer_confirmed
        )
        if cached is not None and not cached_unusable:
            choice = cached["choice"]
            decision = Decision(
                op=feat.op, choice=choice, variant=by_name[choice], guardrail=None,
                from_cache=True, probe_ms={}, probe_overhead_ms=0.0,
                probe_iter_ms=0.0, estimates_ms={},
            )
            self._warm_opens.inc(op=feat.op)
            stats = cached.get("stats") or {}
            return _BucketState(
                bucket=bucket, key=key, rep_csr=csr, rep_feat=feat, base=base,
                by_name=by_name, estimates_ms={}, est_gain_ms=0.0,
                has_challengers=False, probed=True, decision=decision,
                # drift references travel with the entry
                probe_est_ms=stats.get("probe_est_ms"),
                waste_at_probe=stats.get("waste_at_probe"),
                ref_ms=stats.get("ewma_ms"),
                reprobes=max(int(stats.get("probes") or 1) - 1, 0),
            )

        estimates, short = self.sage.shortlist(feat, cands)
        gain = 0.0
        if short:
            t_base_est = estimates.get(base.full_name(), float("inf"))
            t_best_est = min(estimates[v.full_name()] for v in short)
            gain = t_base_est - t_best_est
        provisional = Decision(
            op=feat.op, choice="baseline", variant=base, guardrail=None,
            from_cache=False, probe_ms={}, probe_overhead_ms=0.0,
            probe_iter_ms=0.0, estimates_ms=estimates,
        )
        st = _BucketState(
            bucket=bucket, key=key, rep_csr=csr, rep_feat=feat, base=base,
            by_name=by_name, estimates_ms=estimates, est_gain_ms=gain,
            has_challengers=bool(short), provisional=provisional,
        )
        if not short:
            # no applicable challengers: the baseline is final, never probe
            st.probed = True
            st.decision = provisional
            return st

        # transfer tier, between warm hit and cold probe: no local entry,
        # but a peer device class may have probed this regime
        if transfer_mod.enabled() and not self.cache.replay_only:
            plan = transfer_mod.best_plan(
                self.cache.peer_entries(key), feat, hw, by_name, base, self.sage.alpha,
                excluded=self.sage.breaker.excluded_names(),
            )
            if plan is not None:
                verdict = "confirmed" if plan.confident else "pending"
                d = Decision(
                    op=feat.op, choice=plan.choice, variant=by_name[plan.choice],
                    guardrail=plan.guardrail, from_cache=False, probe_ms={},
                    probe_overhead_ms=0.0, probe_iter_ms=0.0, estimates_ms=estimates,
                    transfer=plan.provenance(verdict),
                )
                st.decision = d
                st.transferred = True
                st.transfer_verdict = verdict
                st.transfer_choice = plan.choice
                st.transfer_info = d.transfer
                # the padding regime the transfer was accepted under: the
                # waste-drift detector fires off it as off a probe's
                st.waste_at_probe = feat.padding_waste
                self._transfers.inc(op=feat.op)
                if plan.confident:
                    st.probed = True  # final: the confirm probe is waived
                    self._transfers_confirmed.inc(verdict="confirmed")
                    self._transfer_probe_free.inc(op=feat.op)
                else:
                    obs.REGISTRY.inc("autosage_transfer_verdict_total", verdict="pending")
                self._emit({
                    "event": "transfer",
                    "bucket": bucket.sig(),
                    "op": feat.op,
                    "f": feat.f,
                    "choice": plan.choice,
                    "source_device": plan.source_device,
                    "verdict": verdict,
                    "rank_agreement": plan.rank_agreement,
                    "confident": plan.confident,
                    "peer_choice": plan.peer_choice,
                })
                telemetry.emit_decide_event(d, device, feat, kind="transfer")
        return st

    # ----------------------------------------------------------- probes
    def pending(self) -> List[_BucketState]:
        with self._lock:
            return [s for s in self._buckets.values() if not s.probed]

    def pump(self, max_probes: Optional[int] = None) -> int:
        """Probe the highest-priority pending buckets while budget
        remains; returns how many bucket probes ran. Decisions upgrade in
        place: later decides on a pumped bucket see its probed choice.
        Bucket selection claims the bucket (``probing``) under the lock;
        the probe itself runs with the lock released."""
        if self.cache.replay_only:
            return 0
        ran = 0
        while max_probes is None or ran < max_probes:
            with self._lock:
                if self.probe_spent_ms >= self.probe_budget_ms:
                    break
                pend = [s for s in self._buckets.values()
                        if not s.probed and not s.probing]
                if not pend:
                    break
                st = max(pend, key=_BucketState.priority)
                st.probing = True
            try:
                self._probe_bucket(st)
            finally:
                st.probing = False
            ran += 1
        return ran

    def _probe_bucket(self, st: _BucketState) -> None:
        """Run the per-graph decision procedure on the bucket's
        representative and pin the outcome for the whole bucket. On a
        drift re-probe the representative becomes the newest graph seen,
        the pool and estimates are re-derived from its features, and an
        old -> new choice flip is counted."""
        was_drift = st.drift_flagged
        old_choice = st.decision.choice if st.decision is not None else None
        if was_drift and st.last_csr is not None:
            st.rep_csr, st.rep_feat = st.last_csr, st.last_feat
            hw, device = self.sage.hw, self.sage.device
            cands = registry.candidates(st.rep_feat, hw, device)
            st.base = registry.baseline(st.rep_feat, hw, device)
            st.by_name = {v.full_name(): v for v in cands}
            st.by_name["baseline"] = st.base
            st.estimates_ms, short = self.sage.shortlist(st.rep_feat, cands)
            st.has_challengers = bool(short)
        if was_drift:
            # count the re-probe before deriving the seed, so the first
            # re-probe already measures under a fresh probe seed
            st.reprobes += 1
            self._drift_reprobes.inc(event="reprobe")
        was_pending_transfer = st.transferred and st.transfer_verdict == "pending"
        seed = self._bucket_seed(st) + st.reprobes
        reprobe_span = (
            obs.span("drift.reprobe", bucket=st.bucket.sig(), op=st.rep_feat.op,
                     reason=st.drift_reason)
            if was_drift else contextlib.nullcontext()
        )
        # a faulted flush (lock contention, injected chaos) must not lose
        # the probed decision: the write failure is counted, the entry
        # stays dirty for the next flush, and the bucket serves d
        flush_guard = (resilience.cache_guard(op=st.rep_feat.op)
                       if resilience.enabled() else contextlib.nullcontext())
        # one deferred write for the exact-key and bucket puts
        with reprobe_span, flush_guard, self.cache:
            # allow_transfer=False: this IS the measurement that confirms
            # (or flips) a transferred choice and re-pins drifted buckets
            if st.rep_feat.op == "attention":
                d = self.sage.decide_attention(st.rep_csr, st.rep_feat.f, seed=seed,
                                               allow_transfer=False)
            else:
                d = self.sage.decide(st.rep_csr, st.rep_feat.f, st.rep_feat.op, seed=seed,
                                     allow_transfer=False)
            if was_pending_transfer:
                st.transfer_verdict = (
                    "confirmed" if d.choice == st.transfer_choice else "flipped")
                if st.transfer_verdict == "confirmed":
                    self._transfers_confirmed.inc(verdict="confirmed")
                else:
                    self._transfers_flipped.inc(verdict="flipped")
                if st.transfer_info is not None:
                    st.transfer_info = dict(st.transfer_info, verdict=st.transfer_verdict)
                    d.transfer = st.transfer_info
            with self._lock:
                st.decision = d
                st.probe_est_ms = d.probe_ms.get(d.choice)
                st.waste_at_probe = st.rep_feat.padding_waste
                # the new probe resets the regime: statistics restart and
                # the drift reference re-calibrates from upcoming traffic
                st.obs, st.ewma_ms = 0, None
                st.ref_ms, st._first_sum = None, 0.0
                if was_drift:
                    st.drift_flagged = False
                # the decision commits before probed flips, so a decide
                # that sees probed=True also sees the upgraded decision
                st.probed = True
            if resilience.enabled() and d.choice != "baseline":
                # the re-probe answered the fault signal: clear the
                # breaker's counts for the re-pinned choice, so
                # _check_fault_retire does not re-flag off a stale count
                self.sage.breaker.record_success(d.choice)
            self.cache.put(st.key, self._bucket_entry(st, d))
            self._push_stats(st)
        with self._lock:
            st.probe_charge_ms = d.probe_overhead_ms  # 0 on an exact-key hit
            self.probe_spent_ms += st.probe_charge_ms
        self._probe_passes.inc(op=st.rep_feat.op)
        flipped = was_drift and old_choice is not None and d.choice != old_choice
        if flipped:
            self._drift_flips.inc(event="flip")
        event = {
            "event": "drift_reprobe" if was_drift else "bucket_probe",
            "bucket": st.bucket.sig(),
            "op": st.rep_feat.op,
            "f": st.rep_feat.f,
            "choice": d.choice,
            "probe_overhead_ms": d.probe_overhead_ms,
            "budget_spent_ms": self.probe_spent_ms,
            "budget_ms": self.probe_budget_ms,
        }
        if was_pending_transfer:
            event.update(transfer_verdict=st.transfer_verdict,
                         transfer_choice=st.transfer_choice,
                         source_device=(st.transfer_info or {}).get("source_device"))
        if was_drift:
            event.update(old_choice=old_choice, flipped=flipped, reason=st.drift_reason,
                         reprobes=st.reprobes)
            if st.rep_feat.op == "attention":
                # fused <-> composed is the regime signal for attention
                event.update(old_family=_attention_family(old_choice),
                             new_family=_attention_family(d.choice))
        self._emit(event)
        if self.on_upgrade is not None:
            # outside every lock: the callback may emit telemetry or bump
            # metrics and must never be able to deadlock a decide
            try:
                self.on_upgrade(dict(event))
            except Exception:  # noqa: BLE001 - counted; the upgrade stands
                obs.REGISTRY.inc("autosage_serve_upgrade_cb_errors_total")

    # ------------------------------------------------- online statistics
    def bucket_of(self, csr: CSR, f: int, op: str) -> ScheduleBucket:
        """The schedule bucket this graph canonicalizes into (the handle
        `observe` takes)."""
        return ScheduleBucket.from_features(InputFeatures.from_csr(csr, f, op),
                                            self._device)

    def observe(self, bucket: Union[ScheduleBucket, str], runtime_ms: float) -> None:
        """Feed one observed runtime (ms) of the bucket's decision into its
        statistics. Takes a `ScheduleBucket` (from `bucket_of`, or
        `last_bucket` right after a decide); a sig() string only while it
        names one bucket (sigs omit op, F and device), else it is ignored,
        as are unknown buckets.

        The EWMA is the exact mean for the first `ewma_window`
        observations, then exponential with beta = 1/window."""
        with self._lock:
            if isinstance(bucket, ScheduleBucket):
                st = self._by_bucket.get(bucket)
            else:
                matches = [s for b, s in self._by_bucket.items() if b.sig() == bucket]
                st = matches[0] if len(matches) == 1 else None
        if st is None or runtime_ms < 0:
            return
        st.obs += 1
        beta = 1.0 / min(st.obs, self.ewma_window)
        st.ewma_ms = (runtime_ms if st.ewma_ms is None
                      else st.ewma_ms + beta * (runtime_ms - st.ewma_ms))
        # estimate scorecard: each observed runtime of a probed decision
        # scores its roofline estimate (warm-opened buckets have none)
        d = st.decision
        if st.probed and d is not None and st.estimates_ms:
            est_name = st.base.full_name() if d.choice == "baseline" else d.choice
            obs.record_estimate(st.bucket.op, d.choice, st.estimates_ms.get(est_name),
                                runtime_ms, source="observe")
        if st.ref_ms is None:
            # calibrate the drift reference from the first min_obs
            # observations of the freshly probed decision
            st._first_sum += runtime_ms
            if st.obs >= self.drift_min_obs:
                st.ref_ms = st._first_sum / st.obs
        self._check_runtime_drift(st)

    def _check_runtime_drift(self, st: _BucketState) -> None:
        """Flag the bucket when the runtime EWMA departs from the
        calibrated reference by more than drift_ratio, either way."""
        if (
            st.drift_flagged or not st.probed or st.decision is None
            or st.ref_ms is None or st.ewma_ms is None
            or st.obs < self.drift_min_obs
        ):
            return
        ratio = st.ewma_ms / max(st.ref_ms, 1e-9)
        if ratio > self.drift_ratio or ratio < 1.0 / self.drift_ratio:
            self._flag_drift(
                st, f"runtime_ewma {st.ewma_ms:.3f}ms vs reference "
                f"{st.ref_ms:.3f}ms (x{ratio:.2f})"
            )

    def _check_waste_drift(self, st: _BucketState, feat: InputFeatures) -> None:
        """Flag the bucket when an incoming graph's padding_waste departs
        from the probe representative's by drift_waste_delta or more, or
        crosses a waste-bin boundary (an entry whose waste_at_probe came
        from an older binning or another writer)."""
        if st.drift_flagged or not st.probed or st.waste_at_probe is None:
            return
        if (
            abs(feat.padding_waste - st.waste_at_probe) >= self.drift_waste_delta
            or waste_bin(feat.padding_waste) != waste_bin(st.waste_at_probe)
        ):
            self._flag_drift(
                st, f"padding_waste {feat.padding_waste:.3f} departed the "
                f"probe-time regime (waste_at_probe={st.waste_at_probe:.3f})"
            )

    def _flag_drift(self, st: _BucketState, reason: str) -> None:
        """Re-enqueue a probed bucket on the probe budget; the stale
        decision keeps serving until the re-probe lands."""
        if self.cache.replay_only:
            return  # replay is immutable
        st.drift_flagged = True
        st.probed = False
        st.drift_reason = reason
        self._drift_flags.inc(event="flag")
        self._emit({
            "event": "drift_flag",
            "bucket": st.bucket.sig(),
            "op": st.bucket.op,
            "f": st.bucket.f,
            "choice": st.decision.choice if st.decision else "baseline",
            "reason": reason,
            "obs": st.obs,
            "ewma_ms": st.ewma_ms,
            "probe_est_ms": st.probe_est_ms,
        })

    def _check_fault_retire(self, st: _BucketState) -> None:
        """Route run-time faults back into the bucket stream. A pinned or
        transferred choice that builds but faults at run time emits no
        drift signal — the fallback chain would serve the baseline under
        the pinned name forever. The breaker records those run faults;
        this check re-opens the bucket so the next pump re-probes it
        (with allow_transfer=False, so a faulting peer import is not
        re-imported)."""
        if not resilience.enabled() or st.drift_flagged or not st.probed:
            return
        d = st.decision
        if d is None or d.choice == "baseline":
            return
        br = self.sage.breaker
        if br.is_quarantined(d.choice):
            self._flag_fault(st, f"pinned choice {d.choice} is quarantined")
        elif br.run_failures(d.choice) > 0:
            self._flag_fault(st, f"pinned choice {d.choice} faulted at run time")

    def _flag_fault(self, st: _BucketState, reason: str) -> None:
        """Like _flag_drift, triggered by breaker state: the pinned
        decision keeps serving (its chain guarantees a runnable result)
        while the re-probe waits on the budget."""
        if self.cache.replay_only:
            return  # replay is immutable
        st.drift_flagged = True
        st.probed = False
        st.drift_reason = reason
        obs.REGISTRY.inc("autosage_quarantine_total", event="bucket_reopen")
        choice = st.decision.choice if st.decision else "baseline"
        self._emit({
            "event": "fault_flag",
            "bucket": st.bucket.sig(),
            "op": st.bucket.op,
            "f": st.bucket.f,
            "choice": choice,
            "reason": reason,
            "transferred": st.transferred,
        })
        telemetry.emit_fault_event({
            "event": "bucket_reopen",
            "bucket": st.bucket.sig(),
            "op": st.bucket.op,
            "choice": choice,
            "reason": reason,
        }, self.sage.device)

    def _push_stats(self, st: _BucketState) -> None:
        """Fold the bucket's traffic and observations into its entry."""
        self.cache.add_hits(st.key, st.hits - st.hits_flushed)
        st.hits_flushed = st.hits
        self.cache.update_stats(
            st.key, obs=st.obs, ewma_ms=st.ewma_ms,
            probe_est_ms=st.probe_est_ms, waste_at_probe=st.waste_at_probe,
        )

    def _bucket_seed(self, st: _BucketState) -> int:
        """Per-bucket probe seed, stable across runs and stream orders."""
        return (self.seed * 2654435761 + zlib.crc32(st.key.encode())) % (2**31)

    def _bucket_entry(self, st: _BucketState, d: Decision) -> Dict[str, Any]:
        """The bucket's cache entry, laid out as the JAX package writes it.
        A zero-probe transfer stays ``probed`` False and ``probed_at`` 0.0
        (its "transfer" dict tells it from a provisional baseline), so it
        donates nothing and loses every merge against a measured entry."""
        measured = bool(d.probe_ms) or d.from_cache
        entry = {
            "choice": d.choice,
            "op": st.rep_feat.op,
            "bucket": st.bucket.sig(),
            "rep_graph_sig": st.rep_feat.graph_sig,
            "probe_ms": d.probe_ms,
            "estimates_ms": st.estimates_ms,
            # probed=False marks a pinned provisional baseline: "budget
            # never got here", not "measured winner"
            "probed": measured,
            "neutral": {
                "features": st.rep_feat.to_neutral(),
                "ranking": transfer_mod.build_ranking(
                    d.probe_ms, st.estimates_ms or d.estimates_ms, st.base.full_name(),
                ),
                "op": st.rep_feat.op,
                "f": st.rep_feat.f,
                "waste_bin": st.bucket.waste_bin,
            },
            "stats": {
                "probe_est_ms": st.probe_est_ms,
                "waste_at_probe": st.waste_at_probe,
                "probed_at": time.time() if measured else 0.0,
                "probes": st.reprobes + (1 if d.probe_ms else 0),
                "obs": st.obs,
                "ewma_ms": st.ewma_ms,
            },
        }
        if st.transfer_info is not None:
            entry["transfer"] = dict(st.transfer_info)
        return entry

    # ----------------------------------------------------- finalization
    def finalize(self) -> Dict[str, Any]:
        """Pin every bucket decision (probed or provisional baseline) into
        the cache and flush once; replaying the same stream under
        AUTOSAGE_REPLAY_ONLY=1 then serves the same choices without a
        probe. Returns the stream stats. Writes nothing in replay mode."""
        if not self.cache.replay_only:
            flush_guard = (resilience.cache_guard(op="finalize")
                           if resilience.enabled() else contextlib.nullcontext())
            with flush_guard:
                with self._lock:
                    snapshot = list(self._buckets.values())
                with self.cache:
                    for st in snapshot:
                        if not self.cache.contains(st.key):
                            self.cache.put(st.key, self._bucket_entry(st, st.current()))
                        self._push_stats(st)
                self.cache.flush()
        stats = self.stats()
        self._emit({"event": "finalize", **stats})
        return stats

    def __enter__(self) -> "BatchScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finalize()

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        return {
            "decides": self._decides.value,
            "buckets": len(self._buckets),
            "probes_run": self._probe_passes.value,
            "probes_avoided": self._decides.value - self._probe_passes.value,
            "probe_spent_ms": round(self.probe_spent_ms, 3),
            "probe_budget_ms": self.probe_budget_ms,
            "decide_wall_ms": round(self._decide_wall_ms, 3),
            "pending_buckets": len(self.pending()),
            # buckets opened final from the cache: probes a previous run paid
            "warm_cache_opens": self._warm_opens.value,
            "drift_flags": self._drift_flags.value,
            "drift_reprobes": self._drift_reprobes.value,
            "drift_flips": self._drift_flips.value,
            # cross-device transfers: buckets opened from a peer device
            # class's probed ranking; confirmed = probe-free accepts plus
            # confirm probes that agreed
            "transfers": self._transfers.value,
            "transfers_confirmed": self._transfers_confirmed.value,
            "transfers_flipped": self._transfers_flipped.value,
            "transfers_pending": (self._transfers.value - self._transfers_confirmed.value
                                  - self._transfers_flipped.value),
            "transfer_probe_free": self._transfer_probe_free.value,
        }

    def bucket_stats(self) -> List[Dict[str, Any]]:
        """Per-bucket rows, heaviest traffic first."""
        with self._lock:
            snapshot = list(self._buckets.values())

        def r4(x):
            return None if x is None else round(x, 4)

        rows = []
        for st in sorted(snapshot, key=lambda s: -s.hits):
            rows.append({
                "bucket": st.bucket.sig(),
                "op": st.bucket.op,
                "f": st.bucket.f,
                "hits": st.hits,
                "probed": st.probed,
                "choice": st.current().choice,
                "est_gain_ms": round(st.est_gain_ms, 4),
                "probe_charge_ms": round(st.probe_charge_ms, 3),
                "rep_n_rows": st.rep_feat.n_rows,
                "rep_nnz": st.rep_feat.nnz,
                "obs": st.obs,
                "ewma_ms": r4(st.ewma_ms),
                "probe_est_ms": r4(st.probe_est_ms),
                "ref_ms": r4(st.ref_ms),
                "drift_flagged": st.drift_flagged,
                "reprobes": st.reprobes,
                "transferred": st.transferred,
                "transfer_verdict": st.transfer_verdict or None,
                "transfer_source": (st.transfer_info or {}).get("source_device"),
            })
        return rows

    def _record(self, st: _BucketState, d: Decision, source: str) -> None:
        # the one place stream decides are counted
        self._decides.inc(op=d.op, tier=source, scheduler="batch")
        event = {
            "i": self._decides.value - 1,
            "bucket": st.bucket.sig(),
            "key": st.key,
            "op": d.op,
            "f": st.bucket.f,
            "choice": d.choice,
            "source": source,
        }
        with self._lock:
            self.trace.append(event)
        self._emit({"event": "decide", **event})

    def write_trace(self, path: str) -> None:
        """Dump the stream trace as JSONL (one decide per line), replacing
        any existing file."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            for event in self.trace:
                json.dump(event, f, sort_keys=True)
                f.write("\n")

    # ----------------------------------------- AutoSage-compatible API
    def build_runner(self, csr: CSR, decision: Decision) -> Callable:
        return self.sage.build_runner(csr, decision)

    def spmm(self, csr: CSR, b):
        d = self.decide(csr, int(b.shape[1]), "spmm")
        return self.build_runner(csr, d)(b), d

    def sddmm(self, csr: CSR, x, y):
        d = self.decide(csr, int(x.shape[1]), "sddmm")
        return self.build_runner(csr, d)(x, y), d

    def attention(self, csr: CSR, q, k, v):
        d = self.decide(csr, int(q.shape[1]), "attention")
        return self.build_runner(csr, d)(q, k, v), d
