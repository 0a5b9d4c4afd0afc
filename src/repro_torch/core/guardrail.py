"""Guardrail (paper §4.2, Proposition 1).

Accept the best probed candidate iff t* <= alpha * t_baseline (alpha<=1),
else fall back to the baseline. With alpha <= 1 the chosen runtime never
exceeds the baseline's on the probe distribution — AutoSAGE does not
regress versus baseline under identical input and device.

Port of repro/core/guardrail.py, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GuardrailDecision:
    choice: str  # variant full-name, or "baseline"
    accepted: bool
    t_best_ms: float
    t_baseline_ms: float
    alpha: float

    @property
    def speedup(self) -> float:
        if not self.accepted:
            return 1.0
        return self.t_baseline_ms / max(self.t_best_ms, 1e-9)


def apply_guardrail(
    best_name: Optional[str],
    t_best_ms: float,
    t_baseline_ms: float,
    alpha: float = 0.95,
) -> GuardrailDecision:
    assert alpha <= 1.0, "Proposition 1 requires alpha <= 1"
    accepted = best_name is not None and t_best_ms <= alpha * t_baseline_ms
    return GuardrailDecision(
        choice=best_name if accepted else "baseline",
        accepted=accepted,
        t_best_ms=t_best_ms,
        t_baseline_ms=t_baseline_ms,
        alpha=alpha,
    )
