"""AutoSAGE core: input-aware kernel scheduling (the paper's contribution).

Pipeline: features -> roofline estimate shortlist -> on-device micro-probe
on an induced subgraph -> guardrail (never regress, Prop. 1) -> persistent
cache with deterministic replay.
"""
from repro_torch.core.batch import BatchScheduler
from repro_torch.core.cache import CacheKey, ReplayMiss, ScheduleCache, parse_key
from repro_torch.core.features import (
    HardwareSpec,
    InputFeatures,
    ScheduleBucket,
    device_sig,
    resolve_device,
)
from repro_torch.core.guardrail import GuardrailDecision, apply_guardrail
from repro_torch.core.pipeline import AttentionDecision
from repro_torch.core.scheduler import AutoSage, Decision, ProbeOutcome

__all__ = [
    "AttentionDecision",
    "AutoSage",
    "BatchScheduler",
    "CacheKey",
    "Decision",
    "GuardrailDecision",
    "HardwareSpec",
    "InputFeatures",
    "ProbeOutcome",
    "ReplayMiss",
    "ScheduleBucket",
    "ScheduleCache",
    "apply_guardrail",
    "device_sig",
    "parse_key",
    "resolve_device",
]
