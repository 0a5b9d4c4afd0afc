"""AutoSAGE core: input-aware kernel scheduling (the paper's contribution).

Pipeline: features -> roofline estimate shortlist -> on-device micro-probe
on an induced subgraph -> guardrail (never regress, Prop. 1) -> transfer
from peer device classes -> resilience (fallback chain, circuit breaker)
-> persistent cache with deterministic replay and fleet sharing.
"""
from repro_torch.core.batch import BatchScheduler
from repro_torch.core.cache import (
    CacheKey,
    CacheLockTimeout,
    ReplayMiss,
    ScheduleCache,
    parse_key,
)
from repro_torch.core.faultinject import InjectedFault, fault_point
from repro_torch.core.features import (
    HardwareSpec,
    InputFeatures,
    ScheduleBucket,
    device_sig,
    features_from_neutral,
    resolve_device,
    waste_bin,
)
from repro_torch.core.guardrail import GuardrailDecision, apply_guardrail
from repro_torch.core.obs import REGISTRY, MetricsRegistry, ScopedCounter, span
from repro_torch.core.pipeline import AttentionDecision
from repro_torch.core.resilience import CircuitBreaker, FaultPolicy, ProbeTimeout
from repro_torch.core.scheduler import AutoSage, Decision, ProbeOutcome
from repro_torch.core.transfer import TransferPlan, best_plan, plan_transfer

__all__ = [
    "AttentionDecision",
    "AutoSage",
    "BatchScheduler",
    "CacheKey",
    "CacheLockTimeout",
    "CircuitBreaker",
    "Decision",
    "FaultPolicy",
    "GuardrailDecision",
    "HardwareSpec",
    "InjectedFault",
    "InputFeatures",
    "MetricsRegistry",
    "ProbeOutcome",
    "ProbeTimeout",
    "REGISTRY",
    "ReplayMiss",
    "ScheduleBucket",
    "ScheduleCache",
    "ScopedCounter",
    "TransferPlan",
    "apply_guardrail",
    "best_plan",
    "device_sig",
    "fault_point",
    "features_from_neutral",
    "parse_key",
    "plan_transfer",
    "resolve_device",
    "span",
    "waste_bin",
]
