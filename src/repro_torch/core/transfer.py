"""The device-neutral probed ranking of a schedule-cache entry.

A schema-v6 entry carries, beside its device-pinned choice, every
probed candidate with its slope-probe ms and its roofline estimate ms
at probe time. The JAX package's estimate-space transfer
(repro/core/transfer.py) re-ranks a peer device class's entry from that
part. The port writes the part so its entries serve as such peers; the
transfer tier itself joins the port with the fleet slice, where more
than one device class exists.
"""
from __future__ import annotations

from typing import Any, Dict, List


def build_ranking(
    probe_ms: Dict[str, float],
    estimates_ms: Dict[str, float],
    base_full_name: str,
) -> List[Dict[str, Any]]:
    """The neutral ranking written at probe time: every probed
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
