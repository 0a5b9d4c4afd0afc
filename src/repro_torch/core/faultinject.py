"""Deterministic fault-injection harness (chaos testing).

Faults are declared in ``AUTOSAGE_FAULT`` and fire at named call sites
threaded through the scheduler stack (``fault_point`` hooks live at
prepare / run / probe / lock / flush). Two spec forms:

Deterministic clauses (``;``-separated)::

    AUTOSAGE_FAULT="site:match:kind:count"

    site   one of prepare|run|probe|lock|flush, or * for any site
    match  substring matched against the call site's variant name or op;
           empty matches everything at that site
    kind   raise  -> transient InjectedFault
           oom    -> permanent InjectedFault (classified like MemoryError)
           hang   -> sleep AUTOSAGE_FAULT_HANG_S (default 0.5s) without
                     raising, so watchdog timeouts are exercised
    count  how many times this clause fires before going inert
           (omitted = fire forever)

Probabilistic mode (seed-pinned, reproducible given the same sequence of
call sites)::

    AUTOSAGE_FAULT="prob:0.05:seed=8"

This module is intentionally stdlib-only: ``cache.py`` hooks into it and
must not grow an import cycle through the scheduler stack. The fast path
when no spec is set is a single ``os.environ.get``.

Port of repro/core/faultinject.py, unchanged.
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SITES = ("prepare", "run", "probe", "lock", "flush")

KIND_RAISE = "raise"
KIND_OOM = "oom"
KIND_HANG = "hang"
KINDS = (KIND_RAISE, KIND_OOM, KIND_HANG)

DEFAULT_HANG_S = 0.5


class InjectedFault(RuntimeError):
    """A fault raised by the injection harness. ``permanent`` mirrors the
    taxonomy in core/resilience.py: permanent faults (kind=oom) skip the
    retry loop and go straight to fallback + breaker accounting."""

    def __init__(self, site: str, name: str, kind: str):
        super().__init__(f"injected {kind} fault at {site}:{name or '*'}")
        self.site = site
        self.name = name
        self.kind = kind
        self.permanent = kind == KIND_OOM


@dataclass
class _Clause:
    site: str
    match: str
    kind: str
    remaining: Optional[int]  # None = unbounded

    def wants(self, site: str, name: str, op: str) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.site != "*" and self.site != site:
            return False
        if self.match and self.match not in name and self.match not in op:
            return False
        return True


@dataclass
class _Spec:
    clauses: List[_Clause] = field(default_factory=list)
    prob: float = 0.0
    rng: Optional[random.Random] = None


def _parse(spec: str) -> _Spec:
    out = _Spec()
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if parts[0] == "prob":
            # prob:p[:seed=N]
            try:
                out.prob = float(parts[1]) if len(parts) > 1 else 0.0
            except ValueError:
                continue
            seed = 0
            for p in parts[2:]:
                if p.startswith("seed="):
                    try:
                        seed = int(p[5:])
                    except ValueError:
                        seed = 0
            out.rng = random.Random(seed)
            continue
        site = parts[0]
        if site != "*" and site not in SITES:
            continue  # tolerate unknown sites: a typo must not crash decide
        match = parts[1] if len(parts) > 1 else ""
        kind = parts[2] if len(parts) > 2 else KIND_RAISE
        if kind not in KINDS:
            continue
        remaining: Optional[int] = None
        if len(parts) > 3 and parts[3]:
            try:
                remaining = int(parts[3])
            except ValueError:
                remaining = None
        out.clauses.append(_Clause(site, match, kind, remaining))
    return out


# compiled spec cached against the exact env string, so the per-call cost
# with injection active is one env read + one string compare; decrement
# state lives in the cached _Spec's clauses
_compiled: Optional[Tuple[str, _Spec]] = None

# fired-fault tally for tests/diagnostics: {(site, kind): n}
_fired: Dict[Tuple[str, str], int] = {}


def reset() -> None:
    """Drop compiled spec + counters (tests that rotate AUTOSAGE_FAULT)."""
    global _compiled
    _compiled = None
    _fired.clear()


def fired() -> Dict[Tuple[str, str], int]:
    """Copy of the (site, kind) -> count tally of faults injected so far."""
    return dict(_fired)


def _hang_s() -> float:
    try:
        return float(os.environ.get("AUTOSAGE_FAULT_HANG_S", DEFAULT_HANG_S))
    except ValueError:
        return DEFAULT_HANG_S


def fault_point(site: str, name: str = "", op: str = "") -> None:
    """Maybe inject a fault at a named call site.

    Fast path (no AUTOSAGE_FAULT set): one env lookup, no allocation.
    With a spec set, the first matching clause fires: ``raise``/``oom``
    raise InjectedFault, ``hang`` sleeps so the caller's watchdog trips.
    """
    spec_str = os.environ.get("AUTOSAGE_FAULT")
    if not spec_str:
        return
    global _compiled
    if _compiled is None or _compiled[0] != spec_str:
        _compiled = (spec_str, _parse(spec_str))
    spec = _compiled[1]
    for cl in spec.clauses:
        if cl.wants(site, name, op):
            if cl.remaining is not None:
                cl.remaining -= 1
            _trigger(site, name, cl.kind)
            return
    if spec.prob > 0.0 and spec.rng is not None:
        if spec.rng.random() < spec.prob:
            _trigger(site, name, KIND_RAISE)


def _trigger(site: str, name: str, kind: str) -> None:
    _fired[(site, kind)] = _fired.get((site, kind), 0) + 1
    if kind == KIND_HANG:
        time.sleep(_hang_s())
        return
    raise InjectedFault(site, name, kind)
