"""Cross-device schedule portability: estimate-space decision transfer.

Port of repro/core/transfer.py. A fleet-shared cache (core/cache.py)
shares nothing across device kinds: bucket and exact keys pin
``device_sig``, so a heterogeneous fleet (CPU probe boxes feeding the
card's trainers, or a JAX process on another accelerator) probes every
regime from cold on every device class. But a peer device's *probed
ranking* is evidence about the input, not just about the peer's
machine, and this module uses it:

  1. an entry's device-neutral part carries the full probed candidate
     ranking with each candidate's slope-probe ms AND its roofline
     estimate ms *at probe time on the source device*;
  2. the per-candidate residual ``probe_ms / est_ms`` isolates what the
     source roofline missed about this input — a calibration term that
     travels better than the raw timing;
  3. the local device re-estimates every candidate under ITS roofline
     (same model, `estimate.estimates_for`) and predicts
     ``pred_local = est_local * residual_source``;
  4. the re-ranked winner passes the usual guardrail *in predicted
     space* (a transferred choice is never predicted to regress the
     baseline), and serves immediately;
  5. a transfer is **confident** — served as final, zero probes — only
     when the local re-rank agrees with the source's pinned choice AND
     the predicted margin over the runner-up clears
     AUTOSAGE_TRANSFER_MARGIN; anything murkier keeps serving the
     transferred choice provisionally while ONE local probe (charged to
     the normal budget) confirms or flips it.

A donor written by the JAX package names its Pallas variants
(``ragged_ell_pallas[bc=8,f_tile=128,ragged=True,rb=8]``). `local_name`
maps such a name to the port's variant of the same family and knobs
through ``registry.PORTED_FROM`` (reversed) before the ``by_name``
lookup — less the ``f_tile`` knob, which the CUDA kernels choose
themselves, so two JAX tiles of one blocking map to one port variant
and the faster probe of the two stands — and the port re-ranks a JAX
ranking; a name it cannot map is ``skipped``, like an unconstructible
one. Plans speak local names throughout
(``choice``, ``predicted_ms``, ``residuals``); ``peer_choice`` is mapped
too, so top-1 agreement compares like with like.

Env knobs: AUTOSAGE_TRANSFER=0 disables the tier entirely;
AUTOSAGE_TRANSFER_MARGIN (default 1.1) is the predicted winner/runner-up
separation required to skip the confirm probe.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional

from repro_torch.core import estimate as est_mod
from repro_torch.core import obs
from repro_torch.core.features import HardwareSpec, InputFeatures
from repro_torch.core.guardrail import GuardrailDecision, apply_guardrail
from repro_torch.core.registry import PORTED_FROM

DEFAULT_MARGIN = 1.1

# the JAX package's family name -> the port's variant of that family
_LOCAL_FAMILY = {jax_name: name for name, jax_name in PORTED_FROM.items()}


def local_name(name: str) -> str:
    """A donor's candidate name in the port's vocabulary: a JAX family
    (``ragged_ell_pallas[bc=8,f_tile=128,...]``) becomes the port's
    variant of it with the same knobs but ``f_tile``
    (``ragged_ell_cuda[bc=8,...]``: the CUDA SpMM kernels choose their
    feature tile themselves, `kernels.spmm.f_tile`); "baseline", the
    port's own names and names of no known family come back unchanged."""
    family, bracket, knobs = name.partition("[")
    local = _LOCAL_FAMILY.get(family)
    if local is None or local == family:
        return name
    if bracket:
        knobs = ",".join(k for k in knobs.rstrip("]").split(",")
                         if not k.startswith("f_tile="))
        return f"{local}[{knobs}]" if knobs else local
    return local


def enabled() -> bool:
    return os.environ.get("AUTOSAGE_TRANSFER", "1") != "0"


def confirm_margin() -> float:
    return float(os.environ.get("AUTOSAGE_TRANSFER_MARGIN", DEFAULT_MARGIN))


@dataclasses.dataclass
class TransferPlan:
    """One peer entry re-ranked into the local cost space."""

    source_key: str
    source_device: str
    peer_choice: str  # the donor's pinned (device-specific) decision
    choice: str  # local re-ranked winner after the predicted-space guardrail
    predicted_ms: Dict[str, float]  # candidate -> est_local * residual_source
    residuals: Dict[str, float]  # candidate -> probe/est on the source device
    rank_agreement: float  # pairwise order concordance (source probe vs local pred)
    top1_agrees: bool  # local winner == donor's pinned choice
    confident: bool  # serve final without a confirm probe
    guardrail: GuardrailDecision  # applied over predicted_ms
    skipped: List[str]  # ranked names not constructible locally

    def provenance(self, verdict: str) -> Dict[str, Any]:
        """The transfer record attached to decisions, cache entries and
        decide_events.jsonl."""
        return {
            "source_device": self.source_device,
            "source_key": self.source_key,
            "verdict": verdict,
            "rank_agreement": round(self.rank_agreement, 4),
            "top1_agrees": self.top1_agrees,
            "peer_choice": self.peer_choice,
            "transfer_choice": self.choice,
            "predicted_ms": {
                k: round(v, 6) for k, v in self.predicted_ms.items()
            },
        }


def ranking_of(entry: Dict[str, Any], base_full_name: str) -> List[Dict[str, Any]]:
    """The donor's probed candidate ranking: ``[{name, probe_ms, est_ms}]``
    sorted fastest-first. Prefers the schema-v5 neutral part; a v4 entry
    (no "neutral") synthesizes it from ``probe_ms``/``estimates_ms`` —
    the baseline's estimate lives under its full variant name there, so
    the caller supplies the locally-derived baseline name to join them.
    Empty when the entry was never probed (nothing to transfer)."""
    neutral = entry.get("neutral") or {}
    ranking = neutral.get("ranking")
    if isinstance(ranking, list) and ranking:
        return ranking
    probe_ms = entry.get("probe_ms") or {}
    if not isinstance(probe_ms, dict) or not probe_ms:
        return []
    est = entry.get("estimates_ms") or {}
    out = []
    for name, ms in probe_ms.items():
        est_name = base_full_name if name == "baseline" else name
        out.append({"name": name, "probe_ms": ms, "est_ms": est.get(est_name)})
    out.sort(key=lambda r: r["probe_ms"])
    return out


def build_ranking(
    probe_ms: Dict[str, float],
    estimates_ms: Dict[str, float],
    base_full_name: str,
) -> List[Dict[str, Any]]:
    """The v5 neutral ranking written at probe time: every probed
    candidate with its measured slope-probe ms and its estimate ms under
    the prober's roofline (the residual source for later transfers)."""
    out = []
    for name, ms in sorted(probe_ms.items(), key=lambda kv: kv[1]):
        est_name = base_full_name if name == "baseline" else name
        out.append(
            {
                "name": name,
                "probe_ms": round(float(ms), 6),
                "est_ms": estimates_ms.get(est_name),
            }
        )
    return out


def _pairwise_agreement(
    source_order: Dict[str, float], local_order: Dict[str, float]
) -> float:
    """Fraction of candidate pairs whose relative order matches between
    the source's probed costs and the local predicted costs (1.0 when
    fewer than two shared candidates)."""
    names = [n for n in source_order if n in local_order]
    agree = total = 0
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = names[i], names[j]
            s = source_order[a] - source_order[b]
            p = local_order[a] - local_order[b]
            total += 1
            if s * p > 0 or (s == 0 and p == 0):
                agree += 1
    return agree / total if total else 1.0


def plan_transfer(
    source_key: str,
    entry: Dict[str, Any],
    feat: InputFeatures,
    hw: HardwareSpec,
    by_name: Dict[str, Any],
    base,
    alpha: float,
    margin: Optional[float] = None,
    excluded: Optional[set] = None,
) -> Optional[TransferPlan]:
    """Re-rank one donor entry's probed candidate set under the local
    roofline. Returns None when the entry has nothing transferable (no
    probed ranking, no constructible challenger, or no baseline anchor).

    ``by_name`` maps locally-constructible full variant names to their
    Variant objects (the donor may have probed candidates this process
    cannot build — those are skipped, and noted in ``plan.skipped``).
    ``excluded`` names (the circuit breaker's quarantined candidates,
    core/resilience.py) are treated exactly like unconstructible ones: a
    peer's pinned choice that faults locally must not be re-imported."""
    from repro_torch.core.cache import parse_key

    margin = confirm_margin() if margin is None else margin
    excluded = excluded or set()
    base_full = base.full_name()
    ranking = ranking_of(entry, base_full)
    if not ranking:
        return None
    ck = parse_key(source_key)
    source_device = ck.device if ck is not None else "?"

    source_probe: Dict[str, float] = {}
    residuals: Dict[str, float] = {}
    est_local: Dict[str, float] = {}
    skipped: List[str] = []
    for r in ranking:
        name = r.get("name")
        probe = r.get("probe_ms")
        if not isinstance(name, str) or not isinstance(probe, (int, float)):
            continue
        name = local_name(name)
        if name in source_probe:
            # two JAX f_tile variants map to one port variant: the
            # faster probe (first in the fastest-first ranking) stands
            continue
        variant = base if name == "baseline" else by_name.get(name)
        if variant is None or (name != "baseline" and name in excluded):
            skipped.append(name)
            continue
        try:
            est_local[name] = est_mod.estimates_for(feat, hw, [variant]).popitem()[1]
        except KeyError:
            # a donor variant name this estimate model does not know
            skipped.append(name)
            continue
        source_probe[name] = float(probe)
        est_src = r.get("est_ms")
        if isinstance(est_src, (int, float)) and est_src > 0 and probe > 0:
            residuals[name] = float(probe) / float(est_src)
    if "baseline" not in source_probe or len(source_probe) < 2:
        return None

    # candidates whose source estimate is missing borrow the geometric
    # mean residual of the others (the shared device+input error term)
    if residuals:
        fallback = math.exp(
            sum(math.log(r) for r in residuals.values()) / len(residuals)
        )
    else:
        fallback = 1.0
    predicted = {
        name: est_local[name] * residuals.get(name, fallback)
        for name in source_probe
    }

    challengers = {n: t for n, t in predicted.items() if n != "baseline"}
    best = min(challengers, key=challengers.get)
    gr = apply_guardrail(best, challengers[best], predicted["baseline"], alpha)
    choice = gr.choice if gr.accepted else "baseline"

    peer_choice = local_name(entry.get("choice", "baseline"))
    top1 = choice == peer_choice
    agreement = _pairwise_agreement(source_probe, predicted)
    alternatives = [t for n, t in predicted.items() if n != choice]
    margin_ok = bool(alternatives) and (
        min(alternatives) >= margin * predicted[choice]
    )
    return TransferPlan(
        source_key=source_key,
        source_device=source_device,
        peer_choice=peer_choice,
        choice=choice,
        predicted_ms=predicted,
        residuals=residuals,
        rank_agreement=agreement,
        top1_agrees=top1,
        confident=top1 and margin_ok,
        guardrail=gr,
        skipped=skipped,
    )


def best_plan(
    peers: List[tuple],
    feat: InputFeatures,
    hw: HardwareSpec,
    by_name: Dict[str, Any],
    base,
    alpha: float,
    margin: Optional[float] = None,
    excluded: Optional[set] = None,
) -> Optional[TransferPlan]:
    """First workable plan over the donor list (freshest probe first, as
    returned by ScheduleCache.peer_entries)."""
    with obs.span("transfer", op=feat.op, n_peers=len(peers)):
        for key, entry in peers:
            if not isinstance(entry, dict):
                continue
            plan = plan_transfer(
                key, entry, feat, hw, by_name, base, alpha, margin=margin,
                excluded=excluded,
            )
            if plan is not None:
                return plan
        return None
