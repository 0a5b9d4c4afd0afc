"""Persistent schedule cache with deterministic replay (paper §4.2, §10).

Port of repro/core/cache.py: the same schema (v6), the same key grammar
and the same entry layout, so a file written by either package loads in
the other. Two key kinds live side by side:

  exact   ``{device}|{graph_sig}|F={f}|{op}|a={alpha}`` — the paper's
          "(device, graph signature, F, op)" plus the guardrail alpha.
  bucket  ``bucket|{device}|{bucket_sig}|F={f}|{op}|a={alpha}`` — one
          decision shared by every graph of a schedule bucket.

JSON on disk, atomic writes. `replay_only` mode never probes: a cache
miss raises `ReplayMiss`, which guarantees identical schedule choices
across runs (AUTOSAGE_REPLAY_ONLY=1). Keys this version does not parse
(e.g. the JAX package's ``quarantine|...`` records) are carried along
untouched.

A put outside ``with cache:`` writes the file at once; inside it, puts
only mark the cache dirty and one atomic write happens on exit (or on
`flush()`), so a decision stream (the batch scheduler) rewrites the file
once instead of once per put. Per-entry running statistics (hits and
observed runtimes, schema v4) are deferred-dirty always. The fleet mode
(lockfile-guarded load-merge-write on every flush, hit-count-sum across
processes) and `peer_entries` wait for the port's fleet slice.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core import faultinject

DEFAULT_PATH = os.environ.get("AUTOSAGE_CACHE", "autosage_cache.json")

# entry schema history: see repro/core/cache.py. The port writes v6
# entries and reads every older shape.
SCHEMA_VERSION = 6

_BUCKET_PREFIX = "bucket"


class ReplayMiss(RuntimeError):
    pass


def default_stats() -> Dict[str, Any]:
    """Schema-v4 per-entry running statistics (same fields as the JAX
    package's, so merged files stay readable by both)."""
    return {
        "hits": 0,
        "obs": 0,
        "ewma_ms": None,
        "probe_est_ms": None,
        "waste_at_probe": None,
        "probed_at": 0.0,
        "probes": 0,
    }


def _normalize_entry(entry: Dict[str, Any]) -> Dict[str, Any]:
    """v3 -> v4 in-memory migration: every entry carries a full stats
    dict (unknown stats fields from the future are preserved)."""
    stats = default_stats()
    stats.update(entry.get("stats") or {})
    out = dict(entry)
    out["stats"] = stats
    return out


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Structured form of a cache key; `format()`/`parse_key()` are the
    only places that know the on-disk string layout."""

    kind: str  # "exact" | "bucket"
    device: str
    sig: str  # graph_sig (exact) or bucket_sig (bucket)
    f: int
    op: str
    alpha: float

    def format(self) -> str:
        body = f"{self.device}|{self.sig}|F={self.f}|{self.op}|a={self.alpha}"
        return f"{_BUCKET_PREFIX}|{body}" if self.kind == "bucket" else body


def parse_key(key: str) -> Optional[CacheKey]:
    """Inverse of CacheKey.format(); None for keys this version does not
    understand (foreign entries are carried along, never crashed on)."""
    parts = key.split("|")
    kind = "exact"
    if parts and parts[0] == _BUCKET_PREFIX:
        kind = "bucket"
        parts = parts[1:]
    if len(parts) != 5:
        return None
    device, sig, f_part, op, a_part = parts
    if not f_part.startswith("F=") or not a_part.startswith("a="):
        return None
    try:
        return CacheKey(
            kind=kind, device=device, sig=sig, f=int(f_part[2:]), op=op,
            alpha=float(a_part[2:]),
        )
    except ValueError:
        return None


class ScheduleCache:
    def __init__(
        self,
        path: Optional[str] = DEFAULT_PATH,
        replay_only: Optional[bool] = None,
    ):
        self.path = Path(path) if path else None
        if replay_only is None:
            replay_only = os.environ.get("AUTOSAGE_REPLAY_ONLY") == "1"
        self.replay_only = replay_only
        self._lock = threading.RLock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._dirty = False
        self._defer_depth = 0
        if self.path and self.path.exists():
            self._data = self._load_tolerant()

    def _load_tolerant(self) -> Dict[str, Dict[str, Any]]:
        """Load the cache file; a corrupt file is moved aside to
        ``<path>.corrupt`` and the cache starts empty. Transient read
        failures (OSError) still raise, so a valid file is never
        discarded and later overwritten."""
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"cache root is {type(data).__name__}, not object")
            return {k: (_normalize_entry(v) if isinstance(v, dict) else v)
                    for k, v in data.items()}
        except (ValueError, UnicodeDecodeError):  # JSONDecodeError is a ValueError
            try:
                os.replace(self.path, Path(str(self.path) + ".corrupt"))
            except OSError:
                pass
            return {}

    @staticmethod
    def key(device_sig: str, graph_sig: str, f: int, op: str, alpha: float) -> str:
        return CacheKey("exact", device_sig, graph_sig, f, op, alpha).format()

    @staticmethod
    def bucket_key(device_sig: str, bucket_sig: str, f: int, op: str, alpha: float) -> str:
        return CacheKey("bucket", device_sig, bucket_sig, f, op, alpha).format()

    def contains(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        entry = self._data.get(key)
        if entry is None and self.replay_only:
            raise ReplayMiss(
                f"AUTOSAGE_REPLAY_ONLY=1 but no cached schedule for {key}"
            )
        return entry

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        if self.replay_only:
            raise ReplayMiss("cannot write cache in replay-only mode")
        with self._lock:
            new = _normalize_entry({"schema": SCHEMA_VERSION, **entry})
            old = self._data.get(key)
            if isinstance(old, dict):
                # the cache owns the traffic counter: a re-put must not
                # zero the hits accumulated so far
                new["stats"]["hits"] = old.get("stats", {}).get("hits", 0)
            self._data[key] = new
            self._dirty = True
            if self._defer_depth == 0:
                self._flush()

    # ---- running stats (schema v4) -----------------------------------
    def add_hits(self, key: str, n: int = 1) -> None:
        """Record ``n`` decide hits served by ``key``. Deferred-dirty:
        traffic bookkeeping never rewrites the file by itself."""
        if n <= 0 or self.replay_only:
            return
        with self._lock:
            entry = self._data.get(key)
            if not isinstance(entry, dict):
                return
            entry["stats"]["hits"] = entry["stats"].get("hits", 0) + n
            self._dirty = True

    def update_stats(self, key: str, **fields: Any) -> None:
        """Merge the non-None observation fields (ewma_ms, obs,
        probe_est_ms, waste_at_probe, probed_at, probes) into the entry's
        stats. Deferred-dirty, like add_hits; ``hits`` goes through
        add_hits."""
        if "hits" in fields:
            raise ValueError("use add_hits() for traffic counts")
        if self.replay_only:
            return
        with self._lock:
            entry = self._data.get(key)
            if not isinstance(entry, dict):
                return
            for k, v in fields.items():
                if v is not None:
                    entry["stats"][k] = v
            self._dirty = True

    def stats(self, key: str) -> Optional[Dict[str, Any]]:
        entry = self._data.get(key)
        if not isinstance(entry, dict):
            return None
        return entry.get("stats")

    def keys_for_op(self, op: str, kind: Optional[str] = None) -> List[str]:
        """All cached keys for one op (optionally one key kind)."""
        out = []
        for k in self._data:
            ck = parse_key(k)
            if ck is not None and ck.op == op and (kind is None or ck.kind == kind):
                out.append(k)
        return out

    # ---- deferred flushing -------------------------------------------
    def __enter__(self) -> "ScheduleCache":
        with self._lock:
            self._defer_depth += 1
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        with self._lock:
            self._defer_depth = max(0, self._defer_depth - 1)
            if self._defer_depth == 0 and self._dirty:
                self._flush()

    def flush(self) -> None:
        """Write now if dirty (atomic rename); safe to call any time."""
        with self._lock:
            if self._dirty:
                self._flush()

    def _flush(self) -> None:
        """Atomic write of the whole cache (temp file + rename)."""
        if not self.path:
            self._dirty = False
            return
        # chaos hook BEFORE mkstemp: an injected flush fault leaves no
        # temp file behind
        faultinject.fault_point("flush", name=str(self.path))
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent or "."), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        self._dirty = False

    def __len__(self) -> int:
        return len(self._data)
