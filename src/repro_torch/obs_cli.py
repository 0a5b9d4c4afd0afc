"""Decision-narrative CLI over the schedule cache + obs artifacts.

Port of repro/obs_cli.py, over the port's cache key grammar
(`core.cache.parse_key`, schema v6, the same as the JAX package's, so
either package explains the other's cache files) and `core.obs`.

    python -m repro_torch.obs_cli explain <cache-key> [--cache PATH]
                                    [--telemetry DIR]
    python -m repro_torch.obs_cli summary [--obs DIR]
    python -m repro_torch.obs_cli export-trace [--out PATH] [--obs DIR]

``explain`` reconstructs WHY a pinned schedule is what it is, from the
cache entry (features -> ranked estimates -> probed ranking ->
transfer/drift provenance -> pinned choice) joined with the decide-event
streams under the telemetry dir (live tier history, drift flags,
re-probes). ``summary`` aggregates every worker's ``metrics_<pid>.json``
snapshot into one fleet view; ``export-trace`` merges every worker's
spans into one Chrome/Perfetto trace JSON.

Reads artifacts only — never constructs a scheduler, never triggers a
probe, never mutates the cache it explains.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core import obs
from repro_torch.core.cache import DEFAULT_PATH, parse_key


def _load_cache(path: str) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        raise SystemExit(f"no cache file at {p}")
    with open(p) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise SystemExit(f"{p} is not a schedule cache (root is not an object)")
    return data


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail from a crashed writer
        if isinstance(rec, dict):
            out.append(rec)
    return out


def _fmt_ms(v: Any) -> str:
    return f"{v:.4f}ms" if isinstance(v, (int, float)) else "-"


def _tier_of(entry: Dict[str, Any]) -> str:
    """The decision tier a pinned entry came from, named the way the
    acceptance story talks about it: probe / transfer / drift (+ the
    never-measured provisional baseline)."""
    stats = entry.get("stats") or {}
    transfer = entry.get("transfer") or {}
    probes = int(stats.get("probes") or 0)
    if probes > 1:
        return f"drift (re-probed {probes - 1}x)"
    if transfer:
        return f"transfer ({transfer.get('verdict', '?')})"
    if entry.get("probed") or probes > 0:
        return "probe"
    return "provisional (pinned without a measurement)"


def explain(
    key: str,
    cache_path: str = DEFAULT_PATH,
    telemetry_dir: Optional[str] = None,
) -> str:
    """Human-readable decision narrative for one cache key."""
    data = _load_cache(cache_path)
    entry = data.get(key)
    if entry is None:
        near = [k for k in data if key in k]
        lines = [f"no entry for key: {key}"]
        if near:
            lines.append("did you mean:")
            lines += [f"  {k}" for k in near[:10]]
        else:
            lines.append(f"cache holds {len(data)} entries; try one of:")
            lines += [f"  {k}" for k in sorted(data)[:10]]
        return "\n".join(lines)
    if not isinstance(entry, dict):
        return f"{key}: foreign (non-dict) entry: {entry!r}"
    if isinstance(entry.get("quarantine"), dict):
        # explain called on a quarantine record itself (schema v6)
        return "\n".join([f"== {key}"] + _fmt_quarantine(entry["quarantine"]))

    ck = parse_key(key)
    stats = entry.get("stats") or {}
    neutral = entry.get("neutral") or {}
    transfer = entry.get("transfer") or {}
    tier = _tier_of(entry)
    choice = entry.get("choice", "?")

    out: List[str] = []
    out.append(f"== {key}")
    if ck is not None:
        out.append(
            f"   kind={ck.kind} device={ck.device} op={ck.op} F={ck.f} "
            f"alpha={ck.alpha}"
        )
    out.append(f"   pinned choice: {choice}   tier: {tier}")
    if entry.get("bucket"):
        out.append(
            f"   bucket {entry['bucket']} (probe representative "
            f"{entry.get('rep_graph_sig', '?')})"
        )

    feats = neutral.get("features")
    if isinstance(feats, dict) and feats:
        out.append("-- input features (device-neutral)")
        row = ", ".join(f"{k}={feats[k]}" for k in sorted(feats))
        out.append(f"   {row}")

    estimates = entry.get("estimates_ms") or {}
    if estimates:
        out.append("-- roofline estimates (shortlist order)")
        for name, ms in sorted(estimates.items(), key=lambda kv: kv[1]):
            mark = " <- pinned" if name == choice else ""
            out.append(f"   {_fmt_ms(ms):>12s}  {name}{mark}")

    ranking = neutral.get("ranking")
    if isinstance(ranking, list) and ranking:
        out.append("-- probed ranking (slope-probe ms vs estimate at probe time)")
        for r in ranking:
            if not isinstance(r, dict):
                continue
            name = r.get("name", "?")
            mark = " <- pinned" if name == choice else ""
            out.append(
                f"   {_fmt_ms(r.get('probe_ms')):>12s}  est "
                f"{_fmt_ms(r.get('est_ms')):>12s}  {name}{mark}"
            )
    elif entry.get("probed"):
        out.append("-- probed, but no ranking recorded (pre-v5 entry)")
    else:
        out.append("-- never probed locally (no measured ranking)")

    if transfer:
        out.append("-- cross-device transfer provenance")
        out.append(
            f"   from {transfer.get('source_device', '?')} "
            f"(peer pinned {transfer.get('peer_choice', '?')}) -> local "
            f"re-rank {transfer.get('transfer_choice', '?')}, verdict "
            f"{transfer.get('verdict', '?')}, rank agreement "
            f"{transfer.get('rank_agreement', '?')}"
        )
        pred = transfer.get("predicted_ms") or {}
        for name, ms in sorted(pred.items(), key=lambda kv: kv[1]):
            out.append(f"   predicted {_fmt_ms(ms):>12s}  {name}")

    out += _quarantine_section(data, ck, choice)

    out.append("-- live statistics")
    ewma = stats.get("ewma_ms")
    out.append(
        f"   fleet hits={stats.get('hits', 0)} observations="
        f"{stats.get('obs', 0)} observed EWMA={_fmt_ms(ewma)} "
        f"probe_est={_fmt_ms(stats.get('probe_est_ms'))} "
        f"waste_at_probe={stats.get('waste_at_probe')}"
    )
    probed_at = stats.get("probed_at") or 0.0
    out.append(
        f"   probes={stats.get('probes', 0)} probed_at={probed_at}"
        + ("" if probed_at else " (never measured: loses any fleet merge)")
    )

    if telemetry_dir:
        out += _history_section(key, ck, Path(telemetry_dir))
    return "\n".join(out)


def _fmt_quarantine(rec: Dict[str, Any]) -> List[str]:
    state = rec.get("state", "?")
    line = (
        f"   {rec.get('name', '?')}: {state} "
        f"(reason={rec.get('reason', '?')}"
    )
    if state == "active":
        line += (
            f", site={rec.get('site', '?')}, fails={rec.get('fails', '?')}"
        )
    line += f", since={rec.get('since')}, ttl_s={rec.get('ttl_s')})"
    return [line]


def _quarantine_section(
    data: Dict[str, Any], ck, choice: str
) -> List[str]:
    """Schema-v6 circuit-breaker provenance: quarantine records written
    by core/resilience.py under quarantine|<device>|<name> keys, scoped
    to this entry's device. The pinned choice being quarantined means
    the fleet serves its fallback chain — and a replay of this entry
    under AUTOSAGE_REPLAY_ONLY=1 raises ReplayMiss by contract."""
    device = ck.device if ck is not None else None
    recs: List[Dict[str, Any]] = []
    for k, v in data.items():
        if not (isinstance(k, str) and k.startswith("quarantine|")):
            continue
        if not isinstance(v, dict) or not isinstance(v.get("quarantine"), dict):
            continue
        rec = v["quarantine"]
        if device is not None and rec.get("device") not in (None, device):
            continue
        recs.append(rec)
    if not recs:
        return []
    out = ["-- quarantine records (circuit breaker, this device)"]
    for rec in sorted(recs, key=lambda r: r.get("name", "")):
        out += _fmt_quarantine(rec)
        if rec.get("name") == choice and rec.get("state") == "active":
            out.append(
                "   ^ the PINNED choice is quarantined: decides serve the"
                " fallback chain; AUTOSAGE_REPLAY_ONLY=1 raises ReplayMiss"
                " for this entry"
            )
    return out


def _history_section(key: str, ck, tdir: Path) -> List[str]:
    """Join the entry against the decide-event streams: how traffic was
    actually served over time, and any drift/transfer/probe events."""
    out: List[str] = []
    batch = _read_jsonl(tdir / "batch_stream.jsonl")
    sig = ck.sig if ck is not None else None
    mine = [
        r for r in batch
        if r.get("key") == key or (sig is not None and r.get("bucket") == sig)
    ]
    if mine:
        out.append(f"-- stream history ({tdir / 'batch_stream.jsonl'})")
        by_source: Dict[str, int] = {}
        for r in mine:
            if r.get("event") == "decide":
                src = r.get("source", "?")
                by_source[src] = by_source.get(src, 0) + 1
        if by_source:
            served = ", ".join(
                f"{n}x {s}" for s, n in sorted(by_source.items())
            )
            out.append(f"   decides served: {served}")
        for r in mine:
            ev = r.get("event")
            if ev in ("bucket_probe", "drift_reprobe", "drift_flag", "transfer"):
                detail = {
                    k: r[k]
                    for k in (
                        "choice", "old_choice", "flipped", "reason", "verdict",
                        "source_device", "probe_overhead_ms",
                    )
                    if k in r
                }
                out.append(f"   {ev}: {json.dumps(detail, sort_keys=True)}")
    decide_events = _read_jsonl(tdir / "decide_events.jsonl")
    if sig is not None and ck.kind == "exact":
        mine = [r for r in decide_events if r.get("graph_sig") == sig]
        if mine:
            out.append(f"-- decide events ({tdir / 'decide_events.jsonl'})")
            for r in mine[-12:]:
                out.append(
                    f"   {r.get('kind', 'decide')}: choice={r.get('choice')} "
                    f"from_cache={r.get('from_cache')} "
                    f"waste={r.get('padding_waste')}"
                )
    if not out:
        out.append(f"-- no stream history for this key under {tdir}")
    return out


def summary(obs_dir: Optional[str] = None) -> str:
    """Aggregate every worker's metrics_<pid>.json under the obs dir."""
    base = Path(obs_dir) if obs_dir else obs.obs_dir()
    snaps = sorted(base.glob("metrics_*.json"))
    if not snaps:
        return f"no metrics snapshots under {base}"
    counters: Dict[str, Dict[str, float]] = {}
    hists: Dict[str, List[Dict[str, Any]]] = {}
    for p in snaps:
        try:
            snap = json.loads(p.read_text())
        except ValueError:
            continue
        for name, series in (snap.get("counters") or {}).items():
            for row in series:
                lbl = json.dumps(row.get("labels") or {}, sort_keys=True)
                counters.setdefault(name, {})
                counters[name][lbl] = counters[name].get(lbl, 0.0) + row["value"]
        for name, series in (snap.get("histograms") or {}).items():
            hists.setdefault(name, []).extend(series)
    out = [f"== obs summary over {len(snaps)} worker snapshot(s) in {base}"]
    for name in sorted(counters):
        out.append(f"{name}")
        for lbl, v in sorted(counters[name].items()):
            out.append(f"   {lbl} {int(v) if float(v).is_integer() else v}")
    for name in sorted(hists):
        n = sum(r.get("count", 0) for r in hists[name])
        s = sum(r.get("sum", 0.0) for r in hists[name])
        p99 = max(
            (r.get("p99") for r in hists[name] if r.get("p99") is not None),
            default=None,
        )
        mean = s / n if n else 0.0
        p99s = f"{p99:.4f}" if isinstance(p99, (int, float)) else "-"
        out.append(
            f"{name}  n={n} mean={mean:.4f} worst-worker-p99={p99s}"
        )
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs_cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("explain", help="decision narrative for a cache key")
    ex.add_argument("key")
    ex.add_argument("--cache", default=DEFAULT_PATH)
    ex.add_argument(
        "--telemetry", default=os.environ.get("AUTOSAGE_TELEMETRY_DIR"),
        help="telemetry dir holding decide_events/batch_stream JSONL",
    )

    sm = sub.add_parser("summary", help="aggregate worker metrics snapshots")
    sm.add_argument("--obs", default=None, help="obs artifact dir")

    et = sub.add_parser(
        "export-trace", help="merge worker spans into one Perfetto trace"
    )
    et.add_argument("--out", default=None)
    et.add_argument("--obs", default=None, help="obs artifact dir")

    args = ap.parse_args(argv)
    if args.cmd == "explain":
        print(explain(args.key, cache_path=args.cache,
                      telemetry_dir=args.telemetry))
    elif args.cmd == "summary":
        print(summary(args.obs))
    elif args.cmd == "export-trace":
        base = Path(args.obs) if args.obs else obs.obs_dir()
        out = args.out or str(base / "trace_merged.json")
        trace = obs.export_trace(out, directory=str(base))
        print(
            f"wrote {out}: {len(trace['traceEvents'])} events, "
            f"{len({e['name'] for e in trace['traceEvents']})} distinct spans "
            f"(open in ui.perfetto.dev)"
        )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `obs_cli summary | head`
        os._exit(0)
