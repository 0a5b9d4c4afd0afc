"""repro_torch's cache schema migration on the CPU: the twin of
tests/test_cache_migration.py. The committed v4 and v5 fixtures
(`tests/fixtures/`) go through the port's load, flush, shared merge,
replay, `BatchScheduler` bucket replay, transfer donor and quarantine
round trip with no entry, stat or replay behaviour lost. Beyond the JAX
file: both packages' `ScheduleCache` give equal entries for every key of
both fixtures, and their flushed files are equal, so a cache either
package wrote loads in the other.

Every BatchScheduler here probes through a fixed per-family timer
(monkeypatched in the test only), so no verdict depends on wall-clock
probes.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from repro.core import ScheduleCache as JxCache
from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache
from repro_torch.core import probe as probe_mod
from repro_torch.core import transfer as transfer_mod
from repro_torch.core.cache import SCHEMA_VERSION, ReplayMiss, default_stats
from repro_torch.sparse import fixed_degree, sample_subgraph_stream

torch.set_num_threads(1)  # see test_torch_spmm.py

FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE = FIXTURES / "cache_v4.json"
FIXTURE_V5 = FIXTURES / "cache_v5.json"
CPU = torch.device("cpu")

EXACT_SPMM = "cpu:fixture:jax0.4|deadbeefcafef00d|F=32|spmm|a=0.95"
EXACT_ATTN = "cpu:fixture:jax0.4|feedface01234567|F=16|attention|a=0.95"
BUCKET_PROBED = "bucket|cpu:fixture:jax0.4|r10.z13.s0.d-2.w0.simple|F=16|spmm|a=0.95"
BUCKET_PROVISIONAL = "bucket|cpu:fixture:jax0.4|r10.z14.s2.d-2.w2.simple|F=16|spmm|a=0.95"
FOREIGN = "future|key|format|v9|unknown|extra"
V5_BUCKET = BUCKET_PROBED
V5_FOREIGN = FOREIGN


def _copy(src, tmp_path, name):
    path = tmp_path / name
    shutil.copy(src, path)
    return str(path)


@pytest.fixture
def v4_path(tmp_path):
    return _copy(FIXTURE, tmp_path, "cache_v4.json")


@pytest.fixture
def v5_path(tmp_path):
    return _copy(FIXTURE_V5, tmp_path, "cache_v5.json")


def _data(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------ v4 -> v6
def test_v4_fixture_is_schema_4():
    """The committed fixture stays a v4 file: if a run ever rewrote it in
    place, the migration coverage would silently evaporate."""
    data = _data(FIXTURE)
    assert {v.get("schema") for v in data.values() if isinstance(v, dict)} == {4}
    assert not any("neutral" in v for v in data.values() if isinstance(v, dict))


def test_v4_load_preserves_entries_and_stats(v4_path):
    c = ScheduleCache(path=v4_path)
    for key, old in _data(FIXTURE).items():
        if not isinstance(old, dict):
            continue
        entry = c.get(key)
        assert entry["choice"] == old["choice"]
        assert entry.get("probe_ms") == old.get("probe_ms")
        assert entry.get("estimates_ms") == old.get("estimates_ms")
        for field, value in old["stats"].items():  # v4 stats survive verbatim
            assert entry["stats"][field] == value
        for field in default_stats():  # every later default field exists
            assert field in entry["stats"]
    assert c.get(EXACT_ATTN)["stage_ms"]["softmax"] == 0.4
    assert c._data[FOREIGN] == "opaque-forward-compat-value"


def test_v4_flush_roundtrip_loses_nothing(v4_path):
    c = ScheduleCache(path=v4_path)
    c.put("new-key", {"choice": "dense"})  # eager flush rewrites the file
    reloaded = _data(v4_path)
    orig = _data(FIXTURE)
    assert set(orig) <= set(reloaded)
    for key, old in orig.items():
        if not isinstance(old, dict):
            assert reloaded[key] == old
            continue
        assert reloaded[key]["choice"] == old["choice"]
        assert reloaded[key]["stats"]["hits"] == old["stats"]["hits"]
        assert reloaded[key]["stats"]["probed_at"] == old["stats"]["probed_at"]
    assert reloaded["new-key"]["schema"] == SCHEMA_VERSION


def test_v4_shared_merge_loses_nothing(v4_path):
    """Two shared cache objects (one holding the v4 file, one fresh) flush
    in turn: the merged file holds the union and the v4 hit counts
    accumulate instead of resetting."""
    a = ScheduleCache(path=v4_path, shared=True)
    b = ScheduleCache(path=v4_path, shared=True)
    a.add_hits(EXACT_SPMM, 3)
    b.add_hits(EXACT_SPMM, 2)
    a.put("a-key", {"choice": "x", "stats": {"probed_at": 9.0}})
    b.put("b-key", {"choice": "y", "stats": {"probed_at": 9.0}})
    a.flush()
    b.flush()
    final = ScheduleCache(path=v4_path)
    orig = _data(FIXTURE)
    for key in orig:
        assert final.contains(key), key
    assert final.stats(EXACT_SPMM)["hits"] == orig[EXACT_SPMM]["stats"]["hits"] + 5
    assert final.contains("a-key") and final.contains("b-key")
    assert final.get(BUCKET_PROBED)["choice"] == "row_ell"
    assert final.get(BUCKET_PROVISIONAL)["probed"] is False


def test_v4_replay_behavior_preserved(v4_path):
    replay = ScheduleCache(path=v4_path, replay_only=True)
    for key, old in _data(FIXTURE).items():
        if isinstance(old, dict):
            assert replay.get(key)["choice"] == old["choice"]
    with pytest.raises(ReplayMiss):
        replay.get("never-pinned-key")
    with pytest.raises(ReplayMiss):
        replay.put("k", {"choice": "x"})


_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0}


def _fixed_timer(fn, device, iters=1, cap_ms=0.0, name="?"):
    ms = _FAMILY_MS.get(name.split("[")[0], 6.0)
    return probe_mod.ProbeResult(name, ms, [ms], 1, False)


def test_v4_bucket_replays_through_batch_scheduler(tmp_path, monkeypatch):
    """Decisions pinned by a run are re-served identically from a file
    stripped back to v4 shape (no neutral part), as an old writer left it."""
    monkeypatch.setattr(probe_mod, "time_callable", _fixed_timer)
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "migrate-sim")
    path = str(tmp_path / "m.json")
    stream = sample_subgraph_stream([fixed_degree(2048, 12, seed=1)], 4, rows_per_graph=256,
                                    seed=2)
    sage = AutoSage(cache=ScheduleCache(path=path), device="cpu", probe_iters=1,
                    probe_cap_ms=25, probe_frac=0.25)
    with BatchScheduler(sage, probe_budget_ms=10_000) as bs:
        choices = [bs.decide(g, 16, "spmm").choice for g in stream]
    data = _data(path)
    for v in data.values():
        if isinstance(v, dict):
            v.pop("neutral", None)
            v["schema"] = 4
    with open(path, "w") as f:
        json.dump(data, f)
    rbs = BatchScheduler(AutoSage(cache=ScheduleCache(path=path, replay_only=True),
                                  device="cpu"))
    assert [rbs.decide(g, 16, "spmm").choice for g in stream] == choices
    assert rbs.stats()["probes_run"] == 0


def test_v4_entry_is_a_transfer_donor(v4_path, monkeypatch):
    """peer_entries + best_plan work straight off the v4 fixture: the
    probed ranking is synthesized from probe_ms / estimates_ms."""
    from repro_torch.core import HardwareSpec, InputFeatures, registry

    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "other-device")
    c = ScheduleCache(path=v4_path)
    local_key = BUCKET_PROBED.replace("cpu:fixture:jax0.4", "other-device")
    peers = c.peer_entries(local_key)
    assert [k for k, _ in peers] == [BUCKET_PROBED]
    feat = InputFeatures.from_csr(fixed_degree(1400, 12, seed=3), 16, "spmm")
    hw = HardwareSpec.cpu_wide()
    by_name = {v.full_name(): v for v in registry.candidates(feat, hw, CPU)}
    base = registry.baseline(feat, hw, CPU)
    plan = transfer_mod.best_plan(peers, feat, hw, by_name, base, 0.95)
    assert plan is not None
    assert plan.source_device == "cpu:fixture:jax0.4"
    assert plan.choice in by_name or plan.choice == "baseline"


# ------------------------------------------------------------ v5 -> v6
def test_v5_fixture_is_schema_5():
    data = _data(FIXTURE_V5)
    assert {v.get("schema") for k, v in data.items()
            if isinstance(v, dict) and k != V5_FOREIGN} == {5}
    assert not any(k.startswith("quarantine|") for k in data)


def test_v5_load_flush_roundtrip_loses_nothing(v5_path):
    c = ScheduleCache(path=v5_path)
    orig = _data(FIXTURE_V5)
    for key, old in orig.items():
        if key == V5_FOREIGN:
            continue
        entry = c.get(key)
        assert entry["choice"] == old["choice"]
        assert entry.get("neutral") == old.get("neutral")
        for field, value in old["stats"].items():
            assert entry["stats"][field] == value
    c.put("new-key", {"choice": "dense"})  # eager flush rewrites at v6
    reloaded = _data(v5_path)
    assert set(orig) <= set(reloaded)
    assert reloaded["new-key"]["schema"] == SCHEMA_VERSION
    assert reloaded[V5_BUCKET]["neutral"]["ranking"]  # transfer donor intact


def test_quarantine_records_round_trip_and_merge(v5_path):
    """Two shared-cache writers each quarantine a candidate; the merged
    file holds both records, conflicting records on one name resolve
    last-event-wins, and v5-style readers treat the keys as foreign."""
    from repro_torch.core.cache import parse_key

    a = ScheduleCache(path=v5_path, shared=True)
    b = ScheduleCache(path=v5_path, shared=True)
    qkey = ScheduleCache.quarantine_key("cpu:fixture:jax0.4", "row_ell")
    rec_old = {"name": "row_ell", "device": "cpu:fixture:jax0.4", "state": "active",
               "reason": "3_failures", "since": 100.0, "ttl_s": 60.0}
    rec_new = dict(rec_old, state="cleared", reason="recovered", since=200.0)
    a.put(qkey, {"choice": "row_ell", "quarantine": rec_old, "stats": {"probed_at": 100.0}})
    other = ScheduleCache.quarantine_key("cpu:fixture:jax0.4", "hub_split")
    b.put(other, {"choice": "hub_split", "quarantine": dict(rec_old, name="hub_split"),
                  "stats": {"probed_at": 150.0}})
    b.put(qkey, {"choice": "row_ell", "quarantine": rec_new, "stats": {"probed_at": 200.0}})
    a.flush()
    b.flush()
    final = ScheduleCache(path=v5_path)
    recs = dict(final.quarantine_records(device="cpu:fixture:jax0.4"))
    assert set(recs) == {qkey, other}
    assert recs[qkey]["state"] == "cleared"
    assert recs[other]["state"] == "active"
    assert parse_key(qkey) is None
    local = V5_BUCKET.replace("cpu:fixture:jax0.4", "elsewhere")
    assert all(not k.startswith("quarantine|") for k, _ in final.peer_entries(local))
    for key, old in _data(FIXTURE_V5).items():
        if isinstance(old, dict) and key != V5_FOREIGN:
            assert final.get(key)["choice"] == old["choice"]


def test_quarantine_readable_in_replay(v5_path):
    """Replay mode honours the blacklist (reads records) but never extends
    it: puts raise, records load."""
    c = ScheduleCache(path=v5_path, shared=True)
    qkey = ScheduleCache.quarantine_key("cpu:fixture:jax0.4", "row_ell")
    c.put(qkey, {"choice": "row_ell",
                 "quarantine": {"name": "row_ell", "device": "cpu:fixture:jax0.4",
                                "state": "active", "since": 1.0, "ttl_s": 60.0},
                 "stats": {"probed_at": 1.0}})
    c.flush()
    replay = ScheduleCache(path=v5_path, replay_only=True)
    recs = replay.quarantine_records(device="cpu:fixture:jax0.4")
    assert [r["name"] for _, r in recs] == ["row_ell"]
    with pytest.raises(ReplayMiss):
        replay.put(qkey, {"choice": "x"})


# --------------------------------------------- the two packages agree
@pytest.mark.parametrize("fixture", [FIXTURE, FIXTURE_V5], ids=["v4", "v5"])
def test_both_packages_load_and_flush_the_fixture_alike(fixture, tmp_path):
    """Equal entries for every key, and equal files after the same put."""
    ours = ScheduleCache(path=_copy(fixture, tmp_path, "ours.json"))
    theirs = JxCache(path=_copy(fixture, tmp_path, "theirs.json"))
    keys = [k for k, v in _data(fixture).items() if isinstance(v, dict) and k != FOREIGN]
    assert keys
    for key in keys:
        assert ours.get(key) == theirs.get(key), key
    for c in (ours, theirs):
        c.put("new-key", {"choice": "dense", "stats": {"probed_at": 1.0}})
        c.flush()
    assert _data(tmp_path / "ours.json") == _data(tmp_path / "theirs.json")
