"""Persistent schedule cache with deterministic replay (paper §4.2, §10).

Port of repro/core/cache.py: the same schema (v6), the same key grammar,
the same entry layout and the same lockfile protocol, so a file written
by either package loads in the other and a JAX process and a port
process can share one file in fleet mode. Two key kinds live side by
side:

  exact   ``{device}|{graph_sig}|F={f}|{op}|a={alpha}`` — the paper's
          "(device, graph signature, F, op)" plus the guardrail alpha.
  bucket  ``bucket|{device}|{bucket_sig}|F={f}|{op}|a={alpha}`` — one
          decision shared by every graph of a schedule bucket.

plus the circuit breaker's ``quarantine|{device}|{candidate}`` records
(core/resilience.py), which `parse_key` does not parse, so no decision
path serves them. JSON on disk, atomic writes. `replay_only` mode never
probes: a cache miss raises `ReplayMiss`, which guarantees identical
schedule choices across runs (AUTOSAGE_REPLAY_ONLY=1).

A put outside ``with cache:`` writes the file at once; inside it, puts
only mark the cache dirty and one atomic write happens on exit (or on
`flush()`). Per-entry running statistics (hits and observed runtimes,
schema v4) are deferred-dirty always.

Fleet mode (AUTOSAGE_CACHE_SHARED=1, or ``shared=True``): N trainer
processes share one warm cache file. Every flush becomes a
load-merge-write transaction under an ``O_CREAT|O_EXCL`` lockfile
(``<path>.lock``): the on-disk state is re-read, merged with the local
state and written back atomically, so concurrent flushes lose no
entries. Conflicts on one key resolve by **last-probe-wins** for the
decision (the entry whose ``stats.probed_at`` is newest) and
**hit-count-sum** for the traffic statistics (each process adds the hits
it saw since its last merge). A crashed lock holder (dead pid, or a lock
older than AUTOSAGE_LOCK_STALE_S) has its lock broken; a live holder
that outlasts AUTOSAGE_LOCK_TIMEOUT_S raises `CacheLockTimeout`. Lock
polls back off exponentially with jitter (AUTOSAGE_LOCK_BACKOFF_*).
`maybe_reload` folds a peer's newer entries in without writing.

`peer_entries()` returns the same regime probed on *other* device
classes: the donors of the estimate-space decision transfer
(core/transfer.py), which lets a CPU probe box warm a card's trainer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import faultinject, obs

DEFAULT_PATH = os.environ.get("AUTOSAGE_CACHE", "autosage_cache.json")

# entry schema: 1 = per-op decisions (choice/probe_ms/estimates_ms);
# 2 adds joint pipeline decisions ("op": "attention", "stage_ms");
# 3 adds bucket-level entries ("bucket": <bucket_sig>) written by the
# batch scheduler; 4 adds per-entry running "stats" (fleet traffic +
# observed-runtime EWMA + probe provenance) and the shared merge-on-
# flush protocol; 5 splits every entry into a device-neutral part (the
# "neutral" dict: input features + the full probed candidate ranking
# with slope-probe ms and estimate ms at probe time + op/F/waste_bin)
# and a device-pinned part (the top-level "choice" plus the device sig
# in the key), so a bucket probed on device A transfers to device B
# (core/transfer.py re-ranks A's probed set under B's roofline); a
# "transfer" dict records provenance (source_device, verdict,
# rank_agreement) on entries that were transferred rather than probed.
# Reads stay tolerant of every shape, so old caches replay unchanged
# (v3/v4 entries grow default stats on load; transfer synthesizes a
# ranking from v4 probe_ms/estimates_ms when "neutral" is absent); 6 adds
# circuit-breaker quarantine records (core/resilience.py) stored under
# ``quarantine|{device}|{candidate}`` keys: a quarantine entry carries a
# "quarantine" dict (name/device/state/reason/since/ttl_s) and sets
# stats.probed_at to the event time, so the v4 last-probe-wins fleet
# merge resolves conflicting records by recency with no new merge code —
# a fresh "cleared" beats a stale "active". parse_key() returns None for
# quarantine keys, so v5 readers carry them along as foreign entries
# (the tolerant-read contract) without serving them as decisions.
SCHEMA_VERSION = 6

_BUCKET_PREFIX = "bucket"
_QUARANTINE_PREFIX = "quarantine"

DEFAULT_LOCK_TIMEOUT_S = float(os.environ.get("AUTOSAGE_LOCK_TIMEOUT_S", "10"))
DEFAULT_LOCK_STALE_S = float(os.environ.get("AUTOSAGE_LOCK_STALE_S", "30"))

# lock-poll backoff: exponential with jitter, env-tunable. The old fixed
# 5ms poll made N contending flushers hammer the lockfile in sync; the
# jittered backoff decorrelates them (waits land in the labeled
# autosage_cache_lock_wait_ms histogram either way).
DEFAULT_LOCK_BACKOFF_BASE_MS = 2.0
DEFAULT_LOCK_BACKOFF_MAX_MS = 50.0
DEFAULT_LOCK_BACKOFF_JITTER = 0.5


def _lock_backoff_s(attempt: int) -> float:
    """Sleep before lock-acquire retry ``attempt`` (0-based): capped
    exponential plus proportional jitter."""

    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, default))
        except ValueError:
            return default

    base = _f("AUTOSAGE_LOCK_BACKOFF_BASE_MS", DEFAULT_LOCK_BACKOFF_BASE_MS)
    cap = _f("AUTOSAGE_LOCK_BACKOFF_MAX_MS", DEFAULT_LOCK_BACKOFF_MAX_MS)
    jitter = _f("AUTOSAGE_LOCK_BACKOFF_JITTER", DEFAULT_LOCK_BACKOFF_JITTER)
    delay_ms = min(base * (2.0 ** attempt), cap)
    return (delay_ms / 1e3) * (1.0 + max(jitter, 0.0) * random.random())


class ReplayMiss(RuntimeError):
    pass


class CacheLockTimeout(RuntimeError):
    """A live peer held the shared-cache lock past the acquire timeout."""


def default_stats() -> Dict[str, Any]:
    """Schema-v4 per-entry running statistics.

    hits           fleet-wide decide traffic served by this entry
    obs / ewma_ms  observed-runtime feedback (BatchScheduler.observe):
                   windowed EWMA — exact running mean for the first
                   AUTOSAGE_EWMA_WINDOW observations, then exponential
    probe_est_ms   the probe-measured cost of the pinned choice at
                   decision time (the drift detector's reference point)
    waste_at_probe padding_waste of the probe representative (drift via
                   waste-bin shift)
    probed_at      wall-clock of the pinning probe — merge tiebreaker
                   (last-probe-wins)
    probes         how many probe passes produced this entry (>1 after
                   drift re-probes)
    """
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
        shared: Optional[bool] = None,
        lock_timeout_s: float = DEFAULT_LOCK_TIMEOUT_S,
        lock_stale_s: float = DEFAULT_LOCK_STALE_S,
    ):
        self.path = Path(path) if path else None
        if replay_only is None:
            replay_only = os.environ.get("AUTOSAGE_REPLAY_ONLY") == "1"
        if shared is None:
            shared = os.environ.get("AUTOSAGE_CACHE_SHARED") == "1"
        self.replay_only = replay_only
        self.shared = bool(shared) and self.path is not None
        self.lock_timeout_s = lock_timeout_s
        self.lock_stale_s = lock_stale_s
        self._lock = threading.RLock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._dirty = False
        self._defer_depth = 0
        # hits observed by THIS process since its last merge: the merge
        # adds these deltas onto the on-disk counts (hit-count-sum), so
        # fleet traffic accumulates instead of one process's absolute
        # count clobbering everyone else's
        self._pending_hits: Dict[str, int] = {}
        self._disk_mtime_ns: int = -1
        if self.path and self.path.exists():
            self._data = self._load_tolerant()

    def _load_tolerant(self) -> Dict[str, Dict[str, Any]]:
        """Load the cache file; a corrupt/truncated file is moved aside to
        ``<path>.corrupt`` and the cache starts empty instead of taking the
        process down (a crash mid-rename or a half-synced volume must not
        brick every later run). Transient read failures (OSError) still
        raise: a momentarily-unreadable but valid file must not be
        discarded and later overwritten by an eager put()."""
        try:
            st = os.stat(self.path)
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"cache root is {type(data).__name__}, not object")
            self._disk_mtime_ns = st.st_mtime_ns
            # foreign/malformed values are carried along, never crashed on
            return {k: (_normalize_entry(v) if isinstance(v, dict) else v)
                    for k, v in data.items()}
        except (ValueError, UnicodeDecodeError):  # JSONDecodeError is a ValueError
            backup = Path(str(self.path) + ".corrupt")
            try:
                os.replace(self.path, backup)
            except OSError:
                pass
            return {}

    @staticmethod
    def key(device_sig: str, graph_sig: str, f: int, op: str, alpha: float) -> str:
        return CacheKey("exact", device_sig, graph_sig, f, op, alpha).format()

    @staticmethod
    def bucket_key(device_sig: str, bucket_sig: str, f: int, op: str, alpha: float) -> str:
        return CacheKey("bucket", device_sig, bucket_sig, f, op, alpha).format()

    # ---- quarantine records (schema v6, core/resilience.py) ----------
    @staticmethod
    def quarantine_key(device_sig: str, name: str) -> str:
        """Key of the circuit breaker's record for one (candidate,
        device) pair. Deliberately NOT a CacheKey shape: parse_key()
        returns None for it, so every decision-serving path (get-by-key
        aside), peer_entries, and keys_for_op skip it, and pre-v6
        readers carry it as a foreign entry."""
        return f"{_QUARANTINE_PREFIX}|{device_sig}|{name}"

    def quarantine_records(
        self, device: Optional[str] = None
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """(key, quarantine-record) pairs, optionally for one device
        signature. Read-only: works in replay mode (the breaker must
        still *honor* a persisted blacklist under AUTOSAGE_REPLAY_ONLY,
        it just may not extend it)."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        prefix = _QUARANTINE_PREFIX + "|"
        for k, v in self._data.items():
            if not k.startswith(prefix) or not isinstance(v, dict):
                continue
            rec = v.get("quarantine")
            if not isinstance(rec, dict):
                continue
            if device is not None and rec.get("device") != device:
                continue
            out.append((k, rec))
        return out

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
                # the cache owns the traffic counter: a re-put (e.g. a
                # drift re-probe overwriting a bucket decision) must not
                # zero the hits accumulated so far
                new["stats"]["hits"] = old.get("stats", {}).get("hits", 0)
            self._data[key] = new
            self._dirty = True
            if self._defer_depth == 0:
                self._flush()

    # ---- running stats (schema v4) -----------------------------------
    def add_hits(self, key: str, n: int = 1) -> None:
        """Record ``n`` decide hits served by ``key`` in this process.
        Deferred-dirty only: traffic bookkeeping must not trigger a
        whole-file rewrite per decide."""
        if n <= 0 or self.replay_only:
            return
        with self._lock:
            entry = self._data.get(key)
            if not isinstance(entry, dict):
                return
            entry["stats"]["hits"] = entry["stats"].get("hits", 0) + n
            self._pending_hits[key] = self._pending_hits.get(key, 0) + n
            self._dirty = True

    def update_stats(self, key: str, **fields: Any) -> None:
        """Merge non-None observation fields (ewma_ms, obs, probe_est_ms,
        waste_at_probe, probed_at, probes) into the entry's stats.
        Deferred-dirty, like add_hits. ``hits`` must go through
        add_hits() — it is delta-merged across processes."""
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

    def peer_entries(self, key: str) -> List[tuple]:
        """Transfer donors for ``key``: entries with the same structured
        key *modulo the device signature* — the same regime (exact graph
        or schedule bucket), F, op, and alpha, probed/pinned on another
        device class. Returns (key, entry) pairs, freshest probe first
        (deterministic tie-break on the key string), so the caller's
        re-rank uses the newest measurement of the regime. Never raises
        in replay mode — it only reads entries that are present."""
        ck = parse_key(key)
        if ck is None:
            return []
        out: List[tuple] = []
        for k, v in self._data.items():
            if k == key or not isinstance(v, dict):
                continue
            pk = parse_key(k)
            if pk is None or pk.device == ck.device:
                continue
            if (pk.kind, pk.sig, pk.f, pk.op, pk.alpha) == (
                ck.kind, ck.sig, ck.f, ck.op, ck.alpha
            ):
                out.append((k, v))
        out.sort(
            key=lambda kv: (
                -float((kv[1].get("stats") or {}).get("probed_at") or 0.0),
                kv[0],
            )
        )
        return out

    def keys_for_op(self, op: str, kind: Optional[str] = None) -> List[str]:
        """All cached keys for one op (optionally one key kind), via the
        structured parse — no substring matching against sig fields."""
        out = []
        for k in self._data:
            ck = parse_key(k)
            if ck is not None and ck.op == op and (kind is None or ck.kind == kind):
                out.append(k)
        return out

    # ---- deferred flushing -------------------------------------------
    # A decision *stream* (batch scheduler, probe pump) performs many
    # puts; rewriting the whole JSON per put is O(n^2) over the stream.
    # Inside `with cache:` puts only mark the cache dirty; one atomic
    # write happens on exit (or on an explicit flush()).
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
        if not self.path:
            self._dirty = False
            return
        if self.shared:
            self._flush_shared()
            return
        self._dirty = False
        self._write_atomic()

    def _write_atomic(self) -> None:
        # chaos hook BEFORE mkstemp: an injected flush fault leaves no
        # temp file behind and the cache simply stays dirty for retry
        faultinject.fault_point("flush", name=str(self.path))
        # atomic rename so a crash never corrupts the cache
        fd, tmp = tempfile.mkstemp(
            dir=str(self.path.parent or "."), suffix=".tmp"
        )
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        try:
            self._disk_mtime_ns = os.stat(self.path).st_mtime_ns
        except OSError:
            self._disk_mtime_ns = -1

    # ---- fleet mode: merge-on-flush under a lockfile ------------------
    def _lockfile(self) -> Path:
        return Path(str(self.path) + ".lock")

    def _lock_is_stale(self, lockfile: Path) -> bool:
        """A lock is stale when its holder crashed (pid dead) or it has
        outlived lock_stale_s (holder wedged / pid recycled)."""
        try:
            age = time.time() - os.stat(lockfile).st_mtime
        except OSError:
            return False  # vanished: not ours to break
        if age > self.lock_stale_s:
            return True
        try:
            holder = json.loads(lockfile.read_text())
            pid = int(holder["pid"])
        except (OSError, ValueError, KeyError, TypeError):
            return False  # mid-write or foreign format: give it its age out
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True  # holder is gone
        except PermissionError:
            pass  # alive, owned by someone else
        return False

    def _acquire_lock(self) -> Tuple[Path, int]:
        """O_CREAT|O_EXCL lockfile acquire with stale-holder recovery and
        jittered exponential backoff between polls (AUTOSAGE_LOCK_BACKOFF_*).
        Returns (lockfile, wait_attempts) so the caller can label the
        lock-wait histogram. Raises CacheLockTimeout when a live holder
        outlasts lock_timeout_s."""
        # chaos hook BEFORE os.open: an injected lock fault can never
        # leave a lockfile behind for peers to time out on
        faultinject.fault_point("lock", name=str(self.path))
        lockfile = self._lockfile()
        payload = json.dumps({"pid": os.getpid(), "ts": time.time()}).encode()
        deadline = time.monotonic() + self.lock_timeout_s
        attempts = 0
        while True:
            try:
                fd = os.open(str(lockfile), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, payload)
                finally:
                    os.close(fd)
                return lockfile, attempts
            except FileExistsError:
                if self._lock_is_stale(lockfile):
                    self._break_stale_lock(lockfile)
                    continue
                if time.monotonic() >= deadline:
                    raise CacheLockTimeout(
                        f"{lockfile} held by a live peer for more than "
                        f"{self.lock_timeout_s}s"
                    )
                time.sleep(
                    min(_lock_backoff_s(attempts), max(deadline - time.monotonic(), 0.0))
                )
                attempts += 1

    def _break_stale_lock(self, lockfile: Path) -> None:
        """Evict a stale lock through a one-winner election: a bare
        check-then-unlink would let a process whose staleness verdict is
        outdated unlink the lock a faster peer just broke AND re-acquired
        (two writers inside the merge transaction — the exact lost-update
        the lock exists to prevent). The O_EXCL breaker file serializes
        breakers; the winner re-verifies staleness before unlinking, so
        a fresh lock acquired in the meantime survives. A breaker left by
        a crashed process ages out on the same staleness horizon."""
        breaker = Path(str(lockfile) + ".breaker")
        try:
            fd = os.open(str(breaker), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            try:
                if time.time() - os.stat(breaker).st_mtime > self.lock_stale_s:
                    os.unlink(breaker)  # its holder crashed mid-break
            except OSError:
                pass
            time.sleep(0.005)  # a live breaker is working; let it finish
            return
        try:
            if self._lock_is_stale(lockfile):
                try:
                    os.unlink(lockfile)
                except FileNotFoundError:
                    pass
        finally:
            try:
                os.unlink(breaker)
            except OSError:
                pass

    def _release_lock(self, lockfile: Path) -> None:
        # only unlink a lock WE still hold: a holder that stalled past
        # the staleness horizon may have been evicted by a peer — blindly
        # unlinking would remove the peer's fresh lock and let a third
        # process enter the merge transaction concurrently
        try:
            holder = json.loads(lockfile.read_text())
            if int(holder.get("pid", -1)) != os.getpid():
                return
        except (OSError, ValueError, TypeError):
            return
        try:
            os.unlink(lockfile)
        except FileNotFoundError:
            pass

    def _flush_shared(self) -> None:
        """Load-merge-write transaction: reload the on-disk state (peers
        may have flushed since), merge the local state in, write back
        atomically — all under the lockfile, so no flush loses entries."""
        t_lock0 = time.perf_counter()
        try:
            with obs.span("cache.lock_wait", path=str(self.path)):
                lockfile, wait_attempts = self._acquire_lock()
        except CacheLockTimeout:
            obs.REGISTRY.observe(
                "autosage_cache_lock_wait_ms",
                (time.perf_counter() - t_lock0) * 1e3,
                outcome="timeout",
            )
            raise
        obs.REGISTRY.observe(
            "autosage_cache_lock_wait_ms",
            (time.perf_counter() - t_lock0) * 1e3,
            outcome="immediate" if wait_attempts == 0 else "waited",
        )
        try:
            t_merge0 = time.perf_counter()
            with obs.span("cache.merge", path=str(self.path)):
                disk: Dict[str, Any] = {}
                if self.path.exists():
                    try:
                        with open(self.path) as f:
                            raw = json.load(f)
                        if isinstance(raw, dict):
                            disk = {
                                k: (_normalize_entry(v) if isinstance(v, dict) else v)
                                for k, v in raw.items()
                            }
                    except (ValueError, UnicodeDecodeError):
                        disk = {}  # corrupt on-disk state: local wins wholesale
                self._data = self._merge(disk, self._data)
                self._write_atomic()
                # only a landed write consumes the deltas: a failed write
                # (ENOSPC, EIO) must leave the cache dirty and the hit
                # deltas pending so the next flush retries the merge
                self._pending_hits.clear()
                self._dirty = False
            obs.REGISTRY.observe(
                "autosage_cache_merge_ms",
                (time.perf_counter() - t_merge0) * 1e3,
            )
        finally:
            self._release_lock(lockfile)

    def _merge(
        self, disk: Dict[str, Any], local: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Union of keys; per-key conflicts resolve by last-probe-wins on
        the decision payload and hit-count-sum on traffic stats."""
        merged = dict(disk)
        for key, mine in local.items():
            theirs = merged.get(key)
            if theirs is None:
                merged[key] = mine
                continue
            if not isinstance(mine, dict) or not isinstance(theirs, dict):
                # foreign-format value on either side: keep whichever is
                # a structured entry, else leave the disk value alone
                merged[key] = mine if isinstance(mine, dict) else theirs
                continue
            d_stats, l_stats = theirs["stats"], mine["stats"]
            winner = mine if l_stats.get("probed_at", 0.0) >= d_stats.get(
                "probed_at", 0.0
            ) else theirs
            out = dict(winner)
            stats = dict(winner["stats"])
            # traffic sums: disk already holds every peer's merged hits;
            # this process contributes only its delta since its own last
            # merge, so no hit is counted twice
            stats["hits"] = d_stats.get("hits", 0) + self._pending_hits.get(key, 0)
            stats["probes"] = max(
                d_stats.get("probes", 0), l_stats.get("probes", 0)
            )
            out["stats"] = stats
            merged[key] = out
        return merged

    def maybe_reload(self) -> bool:
        """Fleet warm-start mid-run: if a peer has flushed since our last
        load/merge, fold the on-disk entries we don't have (or that carry
        a newer probe) into memory — WITHOUT writing. Returns True if
        anything was reloaded. No-op for non-shared caches."""
        if not self.shared or not self.path:
            return False
        with self._lock:
            try:
                mtime_ns = os.stat(self.path).st_mtime_ns
            except OSError:
                return False
            if mtime_ns == self._disk_mtime_ns:
                return False
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except (OSError, ValueError, UnicodeDecodeError):
                return False
            if not isinstance(raw, dict):
                return False
            self._disk_mtime_ns = mtime_ns
            for k, v in raw.items():
                entry = _normalize_entry(v) if isinstance(v, dict) else v
                mine = self._data.get(k)
                if not isinstance(mine, dict) or not isinstance(entry, dict):
                    self._data.setdefault(k, entry)
                    continue
                if entry["stats"].get("probed_at", 0.0) > mine["stats"].get(
                    "probed_at", 0.0
                ):
                    # a peer re-probed this key: adopt its decision but
                    # keep our unmerged local hit delta on top
                    entry["stats"]["hits"] = entry["stats"].get(
                        "hits", 0
                    ) + self._pending_hits.get(k, 0)
                    self._data[k] = entry
            return True

    def __len__(self) -> int:
        return len(self._data)
