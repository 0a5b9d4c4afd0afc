"""Fault-tolerant execution layer: taxonomy, retries, fallback chains,
and the per-(candidate, device) circuit breaker.

Port of repro/core/resilience.py. The guardrail (core/guardrail.py,
Prop. 1) defends against *slow* choices; this module defends against
choices that *raise or hang*: a kernel that refuses a launch on a new
card, an OOM on a hub-heavy graph, a probe that never returns. The
contract is that every decide/run path returns a runnable result:

fault taxonomy
    transient  worth retrying in place (bounded retries + exponential
               backoff, per-site FaultPolicy)
    permanent  never retried: OOM (``MemoryError`` and
               ``torch.cuda.OutOfMemoryError``, kind "oom"),
               NotImplementedError/TypeError/ValueError (a launch that
               will fail identically again), a launcher's
               deterministic cudaError (invalid value or configuration,
               out of resources), probe watchdog timeouts
    fatal      a sticky CUDA error (illegal address 700, launch failure
               719 and their kin): the CUDA context is unusable after
               it, so no stage of any chain can run — the reference
               stage included. Every catch site re-raises these instead
               of falling back (`is_fatal`).

on a card (operands on a CUDA device)
    The sites that build or run a kernel (the chain's stages, the probe
    sandbox) re-raise every real fault, unretried, after counting it
    (`must_raise`): a hand-written kernel that fails to build, to launch
    or for any other reason surfaces instead of hiding behind the
    library baseline or the oracle. They absorb only the faults the
    harness injects (``AUTOSAGE_FAULT``) and probes the watchdog gave up
    on (a kernel too slow to measure loses its probe, which is the
    scheduler's job). The exception is marked (`surface`), so decide's
    rescue lets it through too (`rescuable`); that rescue still serves
    the baseline past a fault of the decision machinery itself, as the
    legacy ``"csr_attention"`` op's estimate needs. Operands on the CPU
    walk the whole taxonomy, as in the JAX package.

fallback chain (ordered, per op)
    chosen variant -> library baseline variant -> reference oracle
    The terminal reference-oracle stage (kernels/ref.py, eager) is
    *injection-immune* (no fault_point fires on it): even
    ``AUTOSAGE_FAULT="run::raise:"`` (fault every run forever) ends
    with output bit-identical to the oracle.

    The chain sees what raises in the Python call. A CUDA kernel runs
    asynchronously, so a fault that only surfaces at a later
    synchronize (an illegal address inside a kernel that launched
    cleanly) happens outside the chain, as an XLA runtime error does in
    the JAX package; it is also sticky, so nothing could serve the call
    anyway.

circuit breaker / quarantine
    A candidate that exhausts its retries ``AUTOSAGE_BREAKER_N`` times
    (or fails permanently once) is quarantined per (candidate,
    device_sig): excluded from shortlist, probe and transfer, and
    persisted into the schedule cache as a ``quarantine|{device}|{name}``
    entry so fleet workers share the blacklist. Quarantine expires after
    ``AUTOSAGE_QUARANTINE_TTL_S`` into a half-open state granting one
    recovery probe: success clears it (a "cleared" record with a fresh
    event time beats stale "active" records in the fleet merge), failure
    re-quarantines at once. The baseline is exempt.

``AUTOSAGE_RESILIENCE=0`` disables every wrapper (faults propagate raw).
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faultinject, obs, telemetry
from repro_torch.core.cache import CacheLockTimeout, ScheduleCache
from repro_torch.core.faultinject import InjectedFault

TRANSIENT = "transient"
PERMANENT = "permanent"

DEFAULT_RETRIES = 1
DEFAULT_BACKOFF_MS = 2.0
DEFAULT_BACKOFF_MAX_MS = 50.0
DEFAULT_PROBE_TIMEOUT_S = 30.0
DEFAULT_BREAKER_N = 3
DEFAULT_QUARANTINE_TTL_S = 3600.0

# cudaError codes a launcher can return that fail identically on retry
# (invalid value, invalid configuration, out of resources) or that mean
# no memory; every other launcher code is retried as transient
_CUDA_PERMANENT = frozenset({1, 2, 9, 98, 701})
# cudaError codes after which the CUDA context is unusable: ECC
# uncorrectable, illegal address, launch timeout, device assert, stack
# error, illegal instruction, misaligned address, invalid address space,
# invalid PC, launch failure
_CUDA_STICKY = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718, 719})
_STICKY_TEXT = (
    "illegal memory access", "unspecified launch failure", "misaligned address",
    "illegal instruction", "device-side assert", "uncorrectable ecc",
    "hardware stack error", "invalid program counter",
)
_CUDA_CODE = re.compile(r"cudaError (\d+)")


class ProbeTimeout(RuntimeError):
    """The watchdog gave up on a probe that outlived its timeout."""


def enabled() -> bool:
    """Resilience wrappers active? AUTOSAGE_RESILIENCE=0 disables."""
    return os.environ.get("AUTOSAGE_RESILIENCE", "1") != "0"


def _cuda_code(exc: BaseException) -> Optional[int]:
    """The cudaError code of a CUDA failure: torch's AcceleratorError
    carries it, the port's launchers (kernels/build.py) print it."""
    code = getattr(exc, "error_code", None)
    if isinstance(code, int):
        return code
    m = _CUDA_CODE.search(str(exc))
    return int(m.group(1)) if m else None


def is_fatal(exc: BaseException) -> bool:
    """A sticky CUDA error: the context is lost, no fallback can run."""
    if not isinstance(exc, RuntimeError) or isinstance(exc, InjectedFault):
        return False
    code = _cuda_code(exc)
    if code is not None:
        return code in _CUDA_STICKY
    text = str(exc).lower()
    return any(t in text for t in _STICKY_TEXT)


def must_raise(exc: BaseException, device=None) -> bool:
    """At a site that builds or runs a kernel, a fault no fallback may
    absorb: a sticky CUDA error on any device, and on a card every fault
    that was neither injected nor a watchdog timeout (see the module
    docstring)."""
    if isinstance(exc, (InjectedFault, ProbeTimeout)):
        return False
    if is_fatal(exc):
        return True
    return device is not None and torch.device(device).type == "cuda"


_SURFACED = "autosage_surfaced"


def surface(exc: BaseException) -> BaseException:
    """Mark ``exc``, which a kernel site re-raises, so that no outer
    rescue absorbs it; returns it."""
    setattr(exc, _SURFACED, True)
    return exc


def rescuable(exc: BaseException) -> bool:
    """May decide's rescue serve a baseline past ``exc``? Not past a
    sticky CUDA error, nor past a fault a kernel site surfaced."""
    return not (is_fatal(exc) or getattr(exc, _SURFACED, False))


def classify(exc: BaseException) -> str:
    """TRANSIENT (retry in place) or PERMANENT (straight to fallback).

    Permanent: OOM (host or card), a launch error that will fail
    identically on retry, an injected permanent fault, watchdog timeouts
    (retrying a hang just hangs the retry budget too), and the sticky
    CUDA errors (which no caller may fall back from, see `is_fatal`).
    torch's OutOfMemoryError is a RuntimeError, so the JAX rule would
    retry it as transient; here it is permanent."""
    if isinstance(exc, InjectedFault):
        return PERMANENT if exc.permanent else TRANSIENT
    if isinstance(
        exc,
        (MemoryError, torch.cuda.OutOfMemoryError, NotImplementedError, TypeError,
         ValueError, ProbeTimeout),
    ):
        return PERMANENT
    code = _cuda_code(exc) if isinstance(exc, RuntimeError) else None
    if code is not None and code in _CUDA_PERMANENT:
        return PERMANENT
    if is_fatal(exc):
        return PERMANENT
    return TRANSIENT


def fault_kind(exc: BaseException) -> str:
    """Metrics label for one fault."""
    if isinstance(exc, InjectedFault):
        return exc.kind
    if isinstance(exc, ProbeTimeout):
        return "timeout"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, CacheLockTimeout):
        return "lock_timeout"
    if isinstance(exc, RuntimeError) and _cuda_code(exc) is not None:
        return "cuda_error"
    return type(exc).__name__.lower()


@dataclass(frozen=True)
class FaultPolicy:
    """Per-site retry/backoff/watchdog budget."""

    retries: int = DEFAULT_RETRIES  # retries beyond the first attempt
    backoff_ms: float = DEFAULT_BACKOFF_MS
    backoff_max_ms: float = DEFAULT_BACKOFF_MAX_MS
    timeout_s: Optional[float] = None  # watchdog budget (probe site only)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def policy_for(site: str) -> FaultPolicy:
    """Env-tunable policy: AUTOSAGE_FAULT_RETRIES / _BACKOFF_MS apply to
    every site; AUTOSAGE_PROBE_TIMEOUT_S arms the probe watchdog."""
    retries = int(_env_float("AUTOSAGE_FAULT_RETRIES", DEFAULT_RETRIES))
    backoff = _env_float("AUTOSAGE_FAULT_BACKOFF_MS", DEFAULT_BACKOFF_MS)
    timeout = None
    if site == "probe":
        timeout = _env_float("AUTOSAGE_PROBE_TIMEOUT_S", DEFAULT_PROBE_TIMEOUT_S)
    return FaultPolicy(retries=retries, backoff_ms=backoff, timeout_s=timeout)


def record_fault(
    site: str, name: str, op: str, exc: BaseException,
    device: Optional[torch.device] = None,
) -> None:
    """One fault event into the observability layer: counter + span +
    faults.jsonl telemetry. Never raises."""
    kind = fault_kind(exc)
    try:
        obs.REGISTRY.inc("autosage_faults_total", site=site, kind=kind)
        # label is "candidate", not "name": span()'s first positional
        # parameter is the span name and would collide
        with obs.span("fault", site=site, kind=kind, candidate=name, op=op):
            pass
        telemetry.emit_fault_event(
            {
                "event": "fault",
                "site": site,
                "kind": kind,
                "name": name,
                "op": op,
                "error": f"{type(exc).__name__}: {exc}",
            },
            device,
        )
    except Exception:
        pass  # fault accounting must never mask the fault itself


def record_fallback(frm: str, to: str, op: str,
                    device: Optional[torch.device] = None) -> None:
    # "from" is a Python keyword, hence the ** spelling
    obs.REGISTRY.inc("autosage_fallback_total", **{"from": frm, "to": to})
    telemetry.emit_fault_event({"event": "fallback", "from": frm, "to": to, "op": op},
                               device)


def retry_call(
    fn: Callable[[], Any],
    site: str,
    name: str = "",
    op: str = "",
    policy: Optional[FaultPolicy] = None,
    device: Optional[torch.device] = None,
) -> Any:
    """Call ``fn`` with the site's retry budget: transient faults back
    off exponentially and retry; permanent faults (and budget
    exhaustion) re-raise for the caller's fallback chain, and so does a
    fault that `must_raise` on ``device``. Every fault, the retried-away
    ones included, is recorded."""
    pol = policy or policy_for(site)
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            record_fault(site, name, op, exc, device)
            if (must_raise(exc, device) or classify(exc) == PERMANENT
                    or attempt >= pol.retries):
                raise
            delay_ms = min(pol.backoff_ms * (2.0 ** attempt), pol.backoff_max_ms)
            time.sleep(delay_ms / 1e3)
            attempt += 1


def run_with_timeout(
    fn: Callable[[], Any], timeout_s: Optional[float], site: str, name: str = ""
) -> Any:
    """Watchdog: run ``fn`` on a daemon thread and give up after
    ``timeout_s`` with ProbeTimeout. The hung thread is abandoned (it
    holds no locks the caller needs); daemon status keeps it from
    blocking interpreter exit. ``timeout_s`` None/<=0 runs inline.

    On a card the thread launches its CUDA work on that thread's
    current stream, the device's default stream for a new thread, and
    an abandoned probe keeps its kernels queued and the card busy until
    they end: the caller gets control back, not the card. The probe's
    grad mode is the thread's own (enabled); probes build no graph,
    since their operands need no grad."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    box: Dict[str, Any] = {}

    def _target() -> None:
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - relayed below
            box["error"] = exc

    t = threading.Thread(target=_target, daemon=True, name=f"watchdog-{site}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise ProbeTimeout(f"{site}:{name or '*'} exceeded {timeout_s}s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


@contextlib.contextmanager
def cache_guard(op: str = ""):
    """Swallow cache persistence faults (lock contention past timeout,
    injected lock/flush faults, disk errors) so a computed decision is
    still returned; the cache stays dirty and the next flush retries.
    ReplayMiss is NOT caught — the replay contract must stay loud."""
    try:
        yield
    except (CacheLockTimeout, InjectedFault, OSError) as exc:
        site = "lock" if isinstance(exc, CacheLockTimeout) else getattr(
            exc, "site", "flush"
        )
        record_fault(site, "cache", op, exc)


# --------------------------------------------------------- circuit breaker


def _breaker_n() -> int:
    try:
        return int(os.environ.get("AUTOSAGE_BREAKER_N", DEFAULT_BREAKER_N))
    except ValueError:
        return DEFAULT_BREAKER_N


def _quarantine_ttl_s() -> float:
    return _env_float("AUTOSAGE_QUARANTINE_TTL_S", DEFAULT_QUARANTINE_TTL_S)


class CircuitBreaker:
    """Per-(candidate, device_sig) failure accounting + quarantine.

    In-memory state is per-process; quarantine events also persist into
    the schedule cache as ``quarantine|{device}|{name}`` entries whose
    ``stats.probed_at`` is the event time, so the fleet's last-probe-wins
    merge resolves conflicting records (a fresh "cleared" beats a stale
    "active" and vice versa) and ``sync_from_cache`` adopts peers'
    verdicts. ``device=None`` means CUDA, as for `AutoSage`."""

    def __init__(
        self,
        cache: Optional[ScheduleCache] = None,
        threshold: Optional[int] = None,
        ttl_s: Optional[float] = None,
        device=None,
    ):
        from repro_torch.core.features import resolve_device

        self.cache = cache
        self.device = resolve_device(device)
        self._threshold = threshold
        self._ttl_s = ttl_s
        self._fails: Dict[str, int] = {}  # consecutive exhausted failures
        self._run_fails: Dict[str, int] = {}  # run-site failures (drift signal)
        self._active: Dict[str, Dict[str, Any]] = {}  # name -> quarantine rec
        self._half_open: set = set()  # granted one recovery probe
        self._cleared_at: Dict[str, float] = {}  # name -> clear event time
        self._synced_mtime: Optional[int] = None

    @property
    def threshold(self) -> int:
        return self._threshold if self._threshold is not None else _breaker_n()

    @property
    def ttl_s(self) -> float:
        return self._ttl_s if self._ttl_s is not None else _quarantine_ttl_s()

    def _emit(self, event: Dict[str, Any]) -> None:
        telemetry.emit_fault_event(event, self.device)

    # ---- queries ------------------------------------------------------
    def is_quarantined(self, name: str) -> bool:
        """Actively quarantined (TTL-checked). A record past its TTL
        transitions to half-open — one recovery probe is allowed."""
        rec = self._active.get(name)
        if rec is None:
            return False
        ttl = float(rec.get("ttl_s") or self.ttl_s)
        if time.time() - float(rec.get("since") or 0.0) > ttl:
            self._active.pop(name, None)
            self._half_open.add(name)
            obs.REGISTRY.inc("autosage_quarantine_total", event="recovery_probe")
            self._emit({"event": "recovery_probe", "name": name})
            return False
        return True

    def is_excluded(self, name: str) -> bool:
        """Exclude from shortlist/probe/transfer? Half-open candidates
        are NOT excluded — that is their recovery probe."""
        return self.is_quarantined(name)

    def excluded_names(self) -> set:
        return {n for n in list(self._active) if self.is_quarantined(n)}

    def run_failures(self, name: str) -> int:
        """Run-site failures seen for this candidate (the batch
        scheduler's re-open signal for faulting pinned choices)."""
        return self._run_fails.get(name, 0)

    def active_quarantine(self, name: str) -> Optional[Dict[str, Any]]:
        return self._active.get(name)

    # ---- state transitions -------------------------------------------
    def record_failure(
        self, name: str, site: str = "run", op: str = "", permanent: bool = False
    ) -> bool:
        """One exhausted (post-retry) failure. Returns True if it tipped
        the candidate into quarantine. The baseline is exempt."""
        if not name or name == "baseline":
            return False
        n = self._fails.get(name, 0) + 1
        self._fails[name] = n
        if site == "run":
            self._run_fails[name] = self._run_fails.get(name, 0) + 1
        if name in self._half_open:
            # failed its one recovery probe: straight back to quarantine
            self._half_open.discard(name)
            self._quarantine(name, site, op, "recovery_failed", n)
            return True
        if name in self._active:
            return True
        if permanent or n >= self.threshold:
            reason = "permanent" if permanent else f"{n}_failures"
            self._quarantine(name, site, op, reason, n)
            return True
        return False

    def record_success(self, name: str) -> None:
        """A clean call resets the consecutive-failure count; a success
        while half-open/quarantined clears the quarantine (persisted as
        a "cleared" record so the fleet un-blacklists too)."""
        if not name or name == "baseline":
            return
        self._fails.pop(name, None)
        self._run_fails.pop(name, None)
        if name in self._half_open or name in self._active:
            self._half_open.discard(name)
            old = self._active.pop(name, None)
            now = time.time()
            self._cleared_at[name] = now
            obs.REGISTRY.inc("autosage_quarantine_total", event="recover")
            self._emit({"event": "recover", "name": name,
                        "was": (old or {}).get("reason")})
            self._persist(
                {
                    "name": name,
                    "device": self._device(),
                    "state": "cleared",
                    "reason": "recovered",
                    "since": now,
                    "ttl_s": self.ttl_s,
                }
            )

    def _quarantine(
        self, name: str, site: str, op: str, reason: str, fails: int
    ) -> None:
        now = time.time()
        rec = {
            "name": name,
            "device": self._device(),
            "state": "active",
            "site": site,
            "op": op,
            "reason": reason,
            "fails": fails,
            "since": now,
            "ttl_s": self.ttl_s,
        }
        self._active[name] = rec
        self._half_open.discard(name)
        obs.REGISTRY.inc("autosage_quarantine_total", event="quarantine")
        self._emit({"event": "quarantine", **rec})
        self._persist(rec)

    # ---- persistence / fleet sync ------------------------------------
    def _device(self) -> str:
        from repro_torch.core.features import device_sig

        return device_sig(self.device)

    def _persist(self, rec: Dict[str, Any]) -> None:
        cache = self.cache
        if cache is None or cache.replay_only:
            return
        key = ScheduleCache.quarantine_key(rec["device"], rec["name"])
        entry = {
            "choice": rec["name"],
            "quarantine": rec,
            # event time as probed_at: the fleet merge's last-probe-wins
            # rule then resolves conflicting records by recency
            "stats": {"probed_at": rec["since"]},
        }
        with cache_guard(op=rec.get("op", "")):
            cache.put(key, entry)

    def maybe_sync(self) -> None:
        """Cheap sync: re-scan the cache's quarantine records only when
        its on-disk state changed since the last scan (or on first use).
        In-process events are already in memory — this is how a peer
        worker's quarantine reaches us."""
        cache = self.cache
        if cache is None:
            return
        mtime = getattr(cache, "_disk_mtime_ns", None)
        if self._synced_mtime is not None and mtime == self._synced_mtime:
            return
        self._synced_mtime = mtime
        self.sync_from_cache()

    def sync_from_cache(self) -> None:
        """Adopt quarantine records for THIS device from the cache,
        last-event-wins against local state."""
        cache = self.cache
        if cache is None:
            return
        for _key, rec in cache.quarantine_records(device=self._device()):
            name = rec.get("name")
            if not name:
                continue
            since = float(rec.get("since") or 0.0)
            if rec.get("state") == "active":
                mine = self._active.get(name)
                newer_than_clear = since > self._cleared_at.get(name, -1.0)
                if newer_than_clear and (
                    mine is None or since > float(mine.get("since") or 0.0)
                ):
                    self._active[name] = dict(rec)
                    self._half_open.discard(name)
            elif rec.get("state") == "cleared":
                mine = self._active.get(name)
                if mine is not None and since > float(mine.get("since") or 0.0):
                    self._active.pop(name, None)
                    self._fails.pop(name, None)
                    self._run_fails.pop(name, None)
                self._cleared_at[name] = max(self._cleared_at.get(name, 0.0), since)


# --------------------------------------------------------- fallback chain


def _infer_f(op: str, args: tuple) -> int:
    """Feature width from the runtime operands (the fallback stages are
    built lazily, after the decision object is long gone)."""
    from repro_torch.core import features as features_mod

    if features_mod.op_kind(op) == "spmm":
        return int(args[-1].shape[1])
    return int(args[0].shape[-1])


def reference_runner(csr, op: str, device: torch.device) -> Callable:
    """The chain's terminal stage: the kernels/ref.py oracle for ``op``'s
    structural kind, on ``device``. No fault_point fires here — this is
    the lifeline whose output the chaos tests compare against. Eager
    torch, the same functions the oracle tests call, so its output is
    the oracle's bit for bit."""
    from repro_torch.core import features as features_mod
    from repro_torch.kernels import ref

    kind = features_mod.op_kind(op)
    dynamic = features_mod.op_dynamic_vals(op)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rowptr, colind = up(csr.rowptr), up(csr.colind)
    val = None if csr.val is None else up(np.asarray(csr.val, np.float32))
    if kind == "spmm" and dynamic:
        return lambda vals, b: ref.spmm_ref(rowptr, colind, vals, b)
    if kind == "spmm":
        return lambda b: ref.spmm_ref(rowptr, colind, val, b)
    if kind == "sddmm":
        return lambda x, y: ref.sddmm_ref(rowptr, colind, x, y)
    if kind == "attention":
        from repro_torch.core import registry

        return registry.attention_runner(
            lambda q, k, v: ref.csr_attention_ref(rowptr, colind, q, k, v))
    raise KeyError(op)


def fallback_stages(csr, op: str, choice: str, variant, hw,
                    device: torch.device) -> List[Tuple]:
    """Ordered (name, build(args)->runner, injectable) stages:
    chosen variant -> library baseline -> reference oracle. The baseline
    stage is resolved lazily (it needs features, which need the runtime
    F); the oracle stage is injection-immune."""
    stages: List[Tuple] = []

    if choice != "baseline":

        def build_choice(args, _v=variant):
            return _v.build(_v.timed_prepare(csr), device)

        stages.append((choice, build_choice, True))

    def build_baseline(args):
        from repro_torch.core import registry
        from repro_torch.core.features import InputFeatures

        feat = InputFeatures.from_csr(csr, _infer_f(op, args), op)
        base = registry.baseline(feat, hw, device)
        return base.build(base.timed_prepare(csr), device)

    stages.append(("baseline", build_baseline, True))
    stages.append(("reference", lambda args: reference_runner(csr, op, device), False))
    return stages


def chain_runner(
    stages: List[Tuple],
    op: str,
    breaker: Optional[CircuitBreaker] = None,
    on_stage_fault: Optional[Callable[[str, str, BaseException], None]] = None,
    device: Optional[torch.device] = None,
) -> Callable:
    """Runnable that walks the fallback chain: each call tries the first
    live stage (with the run-site retry budget) and falls through on an
    exhausted or permanent fault. A faulted stage is NOT dropped for
    good — the breaker records each exhausted failure, and once the
    candidate crosses the quarantine threshold the stage is skipped via
    ``is_excluded`` (zero per-call cost) until its TTL half-opens it
    again. Without a breaker the stage IS dropped permanently (nothing
    would bound the re-attempt cost). The terminal stage has no
    fault_point and no further fallback. A fault that `must_raise` (a
    sticky CUDA error; on a card, any real fault) re-raises at once."""

    state: Dict[str, Any] = {"dead": set(), "runners": {}}
    # threads that call one runner at once build each stage once
    build_lock = threading.Lock()

    def run(*args):
        last_exc: Optional[BaseException] = None
        prev_fault: Optional[str] = None
        for name, build, injectable in stages:
            if name in state["dead"]:
                continue
            if breaker is not None and injectable and breaker.is_excluded(name):
                continue  # quarantined: skip without re-paying the fault
            if prev_fault is not None:
                record_fallback(prev_fault, name, op, device)
                prev_fault = None
            runner = state["runners"].get(name)
            site = "prepare" if runner is None else "run"
            try:
                if runner is None:
                    with build_lock:
                        runner = state["runners"].get(name)
                        if runner is None and injectable:
                            runner = retry_call(
                                lambda: build(args), "prepare", name=name, op=op,
                                device=device,
                            )
                        elif runner is None:
                            runner = build(args)
                        state["runners"][name] = runner
                if injectable:

                    def attempt(_r=runner, _n=name):
                        faultinject.fault_point("run", name=_n, op=op)
                        return _r(*args)

                    out = retry_call(attempt, "run", name=name, op=op, device=device)
                else:
                    out = runner(*args)
                if breaker is not None and injectable:
                    breaker.record_success(name)
                return out
            except Exception as exc:
                if must_raise(exc, device):
                    raise surface(exc)
                last_exc = exc
                if breaker is not None:
                    breaker.record_failure(
                        name, site=site, op=op, permanent=classify(exc) == PERMANENT,
                    )
                else:
                    state["dead"].add(name)
                if on_stage_fault is not None:
                    on_stage_fault(name, site, exc)
                prev_fault = name
        if last_exc is not None:
            raise last_exc  # unreachable in practice: oracle cannot fault
        raise RuntimeError(f"no runnable stage left for {op}")

    return run
