"""JSON telemetry (paper §10) and the device, software-version and
AUTOSAGE_* env snapshot of `_meta`.

Port of repro/core/telemetry.py, apart from its CSV writer, which only
the JAX package's paper tables call: the per-op decide/prepare stream
(with the transfer provenance of transferred decisions), the
attention-decision stream, the batch-scheduler stream, the resilience
layer's fault stream and the serving tier's request stream. JSONL
streams keep one unbuffered O_APPEND handle per process and write every
record as one write() of one full line, so concurrent writer processes
interleave whole records.
"""
from __future__ import annotations

import atexit
import json
import os
import platform
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.core.features import device_sig

JSONL_SCHEMA = 1


def _env_snapshot() -> Dict[str, str]:
    """The AUTOSAGE_* env at this call (never cached at import)."""
    return {k: v for k, v in os.environ.items() if k.startswith("AUTOSAGE_")}


def _meta(device: torch.device) -> Dict:
    return {
        "device_sig": device_sig(device),
        "torch_version": torch.__version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "env": _env_snapshot(),
    }


_handles: Dict[str, object] = {}
_handles_lock = threading.Lock()


def _handle(path: str):
    p = str(Path(path))
    with _handles_lock:
        f = _handles.get(p)
        if f is None or f.closed:
            Path(p).parent.mkdir(parents=True, exist_ok=True)
            # binary + unbuffered: each write() is one O_APPEND syscall
            f = open(p, "ab", buffering=0)
            _handles[p] = f
        return f


def close_streams() -> None:
    """Close every cached JSONL handle."""
    with _handles_lock:
        for f in _handles.values():
            try:
                f.close()
            except OSError:
                pass
        _handles.clear()


atexit.register(close_streams)


def append_jsonl(path: str, record: Dict, device: Optional[torch.device]) -> None:
    """Append one JSON record, tagged with the device signature (None
    when the writer has no device, as a cache-lock fault), the stream
    schema version and a monotonic timestamp, in one write()."""
    line = json.dumps(
        {
            "schema": JSONL_SCHEMA,
            "t_mono": time.monotonic(),
            "device_sig": None if device is None else device_sig(device),
            **record,
        },
        sort_keys=True,
    ) + "\n"
    _handle(path).write(line.encode())


def emit_fault_event(event: Dict, device: Optional[torch.device] = None) -> Optional[str]:
    """Resilience-layer stream (faults.jsonl): fault, fallback,
    quarantine and recovery events from core/resilience.py, one record
    per event.

    No-op unless AUTOSAGE_TELEMETRY_DIR is set. Returns the path written."""
    out = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
    if not out:
        return None
    path = str(Path(out) / "faults.jsonl")
    append_jsonl(path, event, device)
    return path


def emit_decide_event(
    decision,
    device: torch.device,
    feat=None,
    padding: Optional[Dict] = None,
    graph_sig: Optional[str] = None,
    kind: str = "decide",
) -> Optional[str]:
    """Per-op decide/prepare events (decide_events.jsonl): a "decide"
    event records the input's estimated `padding_waste` next to the
    choice; a "prepare" event (from build_runner) records the exact
    per-partition `padding_frac` the block-ELL conversion measured.

    No-op unless AUTOSAGE_TELEMETRY_DIR is set. Returns the path written.
    """
    out = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
    if not out:
        return None
    path = str(Path(out) / "decide_events.jsonl")
    rec = {
        "kind": kind,
        "op": decision.op,
        "choice": decision.choice,
        "from_cache": decision.from_cache,
    }
    tr = getattr(decision, "transfer", None)
    if tr:
        # cross-device provenance: the donor device, how the local
        # re-rank agreed with it, and the confirm verdict
        rec["transfer"] = {
            k: tr[k]
            for k in ("source_device", "verdict", "rank_agreement", "top1_agrees",
                      "peer_choice")
            if k in tr
        }
    if feat is not None:
        rec.update(
            graph_sig=feat.graph_sig,
            n_rows=feat.n_rows,
            nnz=feat.nnz,
            f=feat.f,
            skew=feat.skew,
            padding_waste=feat.padding_waste,
            ell_width_est=feat.ell_width_est,
        )
    if graph_sig is not None:
        rec["graph_sig"] = graph_sig
    if padding:
        rec["padding_frac"] = padding
    append_jsonl(path, rec, device)
    return path


def emit_attention_decision(decision, device: torch.device) -> Optional[str]:
    """Per-stage breakdown stream for pipeline decisions
    (attention_decisions.jsonl, §8.7 analysis).

    No-op unless AUTOSAGE_TELEMETRY_DIR is set. Returns the path written.
    """
    out = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
    if not out:
        return None
    path = str(Path(out) / "attention_decisions.jsonl")
    append_jsonl(
        path,
        {
            "op": decision.op,
            "choice": decision.choice,
            "from_cache": decision.from_cache,
            "probe_ms": decision.probe_ms,
            "stage_ms": getattr(decision, "stage_ms", {}),
            "estimates_ms": decision.estimates_ms,
            "probe_overhead_ms": decision.probe_overhead_ms,
        },
        device,
    )
    return path


def emit_batch_event(event: Dict, device: torch.device) -> Optional[str]:
    """Batch-scheduler stream (batch_stream.jsonl): per-decide events,
    bucket probes, drift flags and finalize summaries, one record each.

    No-op unless AUTOSAGE_TELEMETRY_DIR is set: the batched decide hot
    path touches no file by default. Returns the path written."""
    out = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
    if not out:
        return None
    path = str(Path(out) / "batch_stream.jsonl")
    append_jsonl(path, event, device)
    return path


def emit_serve_event(event: Dict, device: Optional[torch.device] = None) -> Optional[str]:
    """Online-serving stream (serve_events.jsonl): per-request records
    (tier, bucket, decision latency), background bucket upgrades and
    session summaries from the serving tier (launch/serve.py). Client
    threads and the probe worker share the stream; each record is one
    whole-line append.

    No-op unless AUTOSAGE_TELEMETRY_DIR is set: the request path touches
    no file by default. Returns the path written."""
    out = os.environ.get("AUTOSAGE_TELEMETRY_DIR")
    if not out:
        return None
    path = str(Path(out) / "serve_events.jsonl")
    append_jsonl(path, event, device)
    return path
