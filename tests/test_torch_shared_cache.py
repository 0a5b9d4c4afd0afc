"""repro_torch's fleet-shared schedule cache on the CPU: the twin of
tests/test_shared_cache.py, plus the cross-package fleet.

- Merge-on-flush across real processes, lockfile contention, timeout
  and stale-holder recovery, hit-count-sum, ownership-checked release,
  v3 -> v4 migration and replay from a merged file, as in the JAX file.
- Two ``python -m repro_torch.shared_worker`` processes (the twin of
  benchmarks/shared_worker.py) share one file: the second opens the
  first's buckets warm, and both replay it.
- One JAX process (benchmarks/shared_worker.py) and one port process
  flush into one file under the lockfile, concurrently: no entry is
  lost, and each package loads and replays the merged file.
- `train_gnn --workers 2` on the CPU: two minibatch trainers on one
  shared file, no fault, no fallback.

Every subprocess has a timeout of its own; every in-process scheduler
probes through a fixed per-family timer (monkeypatched in the test
only).
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro.core import AutoSage as JxSage
from repro.core import BatchScheduler as JxBatch
from repro.core import ScheduleCache as JxCache
from repro_torch.core import AutoSage, BatchScheduler, CacheLockTimeout, ScheduleCache
from repro_torch.core import device_sig
from repro_torch.core import probe as probe_mod
from repro_torch.core.cache import SCHEMA_VERSION, default_stats
from repro_torch.shared_worker import build_stream
from repro_torch.sparse import fixed_degree, hub_skew, sample_subgraph_stream

torch.set_num_threads(1)  # see test_torch_spmm.py

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
N_WORKERS = 2  # the fleet minimum; processes stay few, since the suite shares the cores
TIMEOUT_S = 240

_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0}


def _fixed_timer(fn, device, iters=1, cap_ms=0.0, name="?"):
    ms = _FAMILY_MS.get(name.split("[")[0], 6.0)
    return probe_mod.ProbeResult(name, ms, [ms], 1, False)


@pytest.fixture
def fixed_probe(monkeypatch):
    monkeypatch.setattr(probe_mod, "time_callable", _fixed_timer)


# one compute thread per subprocess: the suite runs its files in
# parallel, and the JAX package's wall-clock tests share the cores
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
               "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}


def _spawn(cmd, **kw):
    """A subprocess at low CPU priority: the suite runs its files in
    parallel, and the JAX package's wall-clock tests must keep theirs."""
    return subprocess.Popen(["nice", "-n", "10", *cmd], **kw)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("AUTOSAGE_REPLAY_ONLY", "AUTOSAGE_CACHE_SHARED", "AUTOSAGE_FAULT",
                        "AUTOSAGE_PROBE_PALLAS")}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **_ONE_THREAD)
    env.update(extra)
    return env


def _communicate(procs):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode() if isinstance(err, bytes) else err
        outs.append(out)
    return outs


# each worker writes 5 private keys plus hits on one contended key, all
# flushed through the merge-on-flush path while its peers do the same
_WORKER_SCRIPT = """
import sys
from repro_torch.core.cache import ScheduleCache
wid, path = int(sys.argv[1]), sys.argv[2]
c = ScheduleCache(path=path, shared=True)
with c:
    for i in range(5):
        c.put(f"w{wid}-k{i}", {"choice": f"v{wid}", "stats": {"probed_at": 1.0 + wid}})
    c.put("common", {"choice": f"w{wid}", "stats": {"probed_at": 1.0 + wid}})
    c.add_hits("common", 3)
c.flush()
"""


def test_concurrent_merge_loses_no_entries(tmp_path):
    path = str(tmp_path / "shared.json")
    procs = [_spawn([sys.executable, "-c", _WORKER_SCRIPT, str(w), path],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for w in range(N_WORKERS)]
    _communicate(procs)
    data = json.load(open(path))
    for w in range(N_WORKERS):
        for i in range(5):
            assert f"w{w}-k{i}" in data, sorted(data)
    assert data["common"]["stats"]["hits"] == 3 * N_WORKERS
    assert data["common"]["choice"] == f"w{N_WORKERS - 1}"  # last-probe-wins
    assert not os.path.exists(path + ".lock")


def test_lock_contention_blocks_then_succeeds(tmp_path):
    path = tmp_path / "c.json"
    c = ScheduleCache(path=str(path), shared=True, lock_timeout_s=5.0)
    lock = tmp_path / "c.json.lock"
    lock.write_text(json.dumps({"pid": os.getpid(), "ts": time.time()}))
    t = threading.Timer(0.3, lock.unlink)
    t.start()
    t0 = time.monotonic()
    c.put("k", {"choice": "x"})  # eager flush: waits for the release
    assert time.monotonic() - t0 >= 0.25
    t.join()
    assert json.load(open(path))["k"]["choice"] == "x"
    assert not lock.exists()


def test_lock_timeout_raises_on_live_holder(tmp_path):
    path = tmp_path / "c.json"
    c = ScheduleCache(path=str(path), shared=True, lock_timeout_s=0.2)
    lock = tmp_path / "c.json.lock"
    lock.write_text(json.dumps({"pid": os.getpid(), "ts": time.time()}))
    with pytest.raises(CacheLockTimeout):
        c.put("k", {"choice": "x"})
    lock.unlink()
    c.flush()  # usable again once the lock clears
    assert json.load(open(path))["k"]["choice"] == "x"


def test_stale_lock_dead_holder_recovered(tmp_path):
    path = tmp_path / "c.json"
    lock = tmp_path / "c.json.lock"
    lock.write_text(json.dumps({"pid": 2**22 + 12345, "ts": time.time()}))
    c = ScheduleCache(path=str(path), shared=True, lock_timeout_s=2.0)
    c.put("k", {"choice": "x"})
    assert json.load(open(path))["k"]["choice"] == "x"
    assert not lock.exists()


def test_stale_lock_old_mtime_recovered(tmp_path):
    path = tmp_path / "c.json"
    lock = tmp_path / "c.json.lock"
    lock.write_text(json.dumps({"pid": os.getpid(), "ts": time.time() - 999}))
    old = time.time() - 999
    os.utime(lock, (old, old))
    c = ScheduleCache(path=str(path), shared=True, lock_timeout_s=2.0, lock_stale_s=30.0)
    c.put("k", {"choice": "x"})
    assert json.load(open(path))["k"]["choice"] == "x"


def test_hit_count_sum_across_cache_objects(tmp_path):
    path = str(tmp_path / "c.json")
    a = ScheduleCache(path=path, shared=True)
    a.put("k", {"choice": "x", "stats": {"probed_at": 5.0}})
    a.flush()
    b = ScheduleCache(path=path, shared=True)
    a.add_hits("k", 4)
    b.add_hits("k", 2)
    a.flush()
    b.flush()
    assert ScheduleCache(path=path, shared=True).stats("k")["hits"] == 6
    b.put("other", {"choice": "y"})  # no new traffic: no double count
    assert ScheduleCache(path=path).stats("k")["hits"] == 6


def test_release_lock_requires_ownership(tmp_path):
    c = ScheduleCache(path=str(tmp_path / "c.json"), shared=True)
    lock = tmp_path / "c.json.lock"
    lock.write_text(json.dumps({"pid": os.getpid() + 1, "ts": time.time()}))
    c._release_lock(lock)  # not ours: must survive
    assert lock.exists()
    lock.write_text(json.dumps({"pid": os.getpid(), "ts": time.time()}))
    c._release_lock(lock)
    assert not lock.exists()


def test_maybe_reload_folds_in_a_peers_newer_entries(tmp_path):
    path = str(tmp_path / "c.json")
    a = ScheduleCache(path=path, shared=True)
    a.put("k", {"choice": "x", "stats": {"probed_at": 1.0}})
    b = ScheduleCache(path=path, shared=True)
    assert not b.maybe_reload()  # nothing new since its load
    b.add_hits("k", 2)
    time.sleep(0.01)
    a.put("k", {"choice": "y", "stats": {"probed_at": 2.0}})
    a.put("new", {"choice": "z"})
    assert b.maybe_reload()
    assert b.get("k")["choice"] == "y" and b.stats("k")["hits"] == 2
    assert b.contains("new")
    assert not ScheduleCache(path=path).maybe_reload()  # not shared: no-op


def _tiny_sage(path=None, shared=False, replay=None):
    return AutoSage(cache=ScheduleCache(path=path, shared=shared, replay_only=replay),
                    device="cpu", probe_iters=1, probe_cap_ms=25, probe_frac=0.25)


def test_warm_open_reprobes_unconstructible_peer_choice(tmp_path, fixed_probe):
    """A peer's pinned choice this process cannot build is probed afresh
    outside replay; in replay it raises ReplayMiss (the port's departure:
    the JAX package serves the baseline under the pinned name)."""
    from repro_torch.core import ReplayMiss

    path = str(tmp_path / "c.json")
    stream = sample_subgraph_stream([fixed_degree(2048, 12, seed=1)], 4, rows_per_graph=256,
                                    seed=2)
    bs = BatchScheduler(_tiny_sage(path, shared=True), probe_budget_ms=10_000)
    key = ScheduleCache.bucket_key(device_sig(torch.device("cpu")),
                                   bs.bucket_of(stream[0], 16, "spmm").sig(), 16, "spmm",
                                   bs.sage.alpha)
    bs.cache.put(key, {"choice": "imaginary_pallas[xy=1]", "probed": True, "op": "spmm",
                       "stats": {"probed_at": 123.0, "probes": 1}})
    replay_file = tmp_path / "replay.json"
    replay_file.write_text(Path(path).read_text())
    d = bs.decide(stream[0], 16, "spmm")
    assert d.choice != "imaginary_pallas[xy=1]"
    assert bs.stats()["probes_run"] == 1 and bs.stats()["warm_cache_opens"] == 0
    rbs = BatchScheduler(_tiny_sage(str(replay_file), replay=True))
    with pytest.raises(ReplayMiss, match="not a candidate"):
        rbs.decide(stream[1], 16, "spmm")


def test_v3_cache_migrates_to_v4_roundtrip(tmp_path):
    path = tmp_path / "old.json"
    v3 = {
        "cpu:x:jax1|deadbeef|F=32|spmm|a=0.95": {
            "schema": 3, "choice": "row_ell", "probe_ms": {"baseline": 2.0}},
        "bucket|cpu:x:jax1|r9.z12.s0.d-3.w0.simple|F=32|spmm|a=0.95": {
            "schema": 3, "choice": "hub_split_ell[hub_threshold=24]"},
    }
    path.write_text(json.dumps(v3))
    c = ScheduleCache(path=str(path))
    for key, old in v3.items():
        entry = c.get(key)
        assert entry["choice"] == old["choice"]
        assert all(field in entry["stats"] for field in default_stats())
    c.put("new", {"choice": "dense"})
    reloaded = json.load(open(path))
    assert reloaded["new"]["schema"] == SCHEMA_VERSION
    replay = ScheduleCache(path=str(path), replay_only=True)
    for key, old in v3.items():
        assert reloaded[key]["choice"] == replay.get(key)["choice"] == old["choice"]


def test_replay_bit_identical_from_merged_cache(tmp_path, fixed_probe):
    path = str(tmp_path / "merged.json")
    stream_a = sample_subgraph_stream([fixed_degree(2048, 3, seed=0),
                                       fixed_degree(2048, 12, seed=1)], 8,
                                      rows_per_graph=256, seed=4)
    stream_b = sample_subgraph_stream([fixed_degree(2048, 48, seed=2),
                                       hub_skew(2048, 6, 0.10, 60, seed=3)], 8,
                                      rows_per_graph=256, seed=5)
    for stream in (stream_a, stream_b):
        with BatchScheduler(_tiny_sage(path, shared=True), probe_budget_ms=10_000) as bs:
            for g in stream:
                bs.decide(g, 16, "spmm")

    def replay():
        rbs = BatchScheduler(_tiny_sage(path, replay=True))
        out = [rbs.decide(g, 16, "spmm").choice for g in stream_a + stream_b]
        assert rbs.stats()["probes_run"] == 0
        return out, rbs

    (c1, rbs), (c2, _) = replay(), replay()
    assert c1 == c2
    merged = json.load(open(path))
    bucket_choices = {v["bucket"]: v["choice"] for v in merged.values()
                      if isinstance(v, dict) and "bucket" in v}
    for g, choice in zip(stream_a + stream_b, c1):
        assert choice == bucket_choices[rbs.bucket_of(g, 16, "spmm").sig()]


_TELEMETRY_SCRIPT = """
import os, sys
os.environ["AUTOSAGE_TELEMETRY_DIR"] = sys.argv[2]
import torch
from repro_torch.core import telemetry
wid = sys.argv[1]
for i in range(200):
    telemetry.append_jsonl(os.path.join(sys.argv[2], "decide_events.jsonl"),
                           {"kind": "probe", "worker": wid, "i": i, "pad": "x" * 200},
                           torch.device("cpu"))
telemetry.close_streams()
"""


def test_jsonl_appends_never_interleave_across_processes(tmp_path):
    out_dir = str(tmp_path / "tele")
    procs = [_spawn([sys.executable, "-c", _TELEMETRY_SCRIPT, str(w), out_dir],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for w in range(N_WORKERS)]
    _communicate(procs)
    lines = Path(out_dir, "decide_events.jsonl").read_text().splitlines()
    assert len(lines) == 200 * N_WORKERS
    assert len({(json.loads(x)["worker"], json.loads(x)["i"]) for x in lines}) == len(lines)


def test_shared_cache_warm_opens_avoid_probes(tmp_path, fixed_probe):
    path = str(tmp_path / "warm.json")
    parents = [fixed_degree(2048, 12, seed=1), fixed_degree(2048, 48, seed=2)]
    with BatchScheduler(_tiny_sage(path, shared=True), probe_budget_ms=10_000) as bs1:
        for g in sample_subgraph_stream(parents, 8, rows_per_graph=256, seed=3):
            bs1.decide(g, 16, "spmm")
    assert bs1.stats()["probes_run"] >= 1
    with BatchScheduler(_tiny_sage(path, shared=True), probe_budget_ms=10_000) as bs2:
        for g in sample_subgraph_stream(parents, 8, rows_per_graph=256, seed=9):
            bs2.decide(g, 16, "spmm")
    s2 = bs2.stats()
    assert s2["probes_run"] == 0 and s2["warm_cache_opens"] == s2["buckets"]


# ------------------------------------------------ shared_worker processes
def _worker(path, *args, module="repro_torch.shared_worker", extra_env=None):
    cmd = [sys.executable, "-m", module, "--cache", path, *args]
    if module == "repro_torch.shared_worker":
        cmd += ["--device", "cpu"]
    return _spawn(cmd, cwd=str(REPO), env=_env(**(extra_env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_stream_is_the_jax_workers_stream():
    from benchmarks.shared_worker import build_stream as jx_build_stream

    for regimes in (4, 8):
        mine, theirs = build_stream(12, 256, 3, regimes), jx_build_stream(12, 256, 3, regimes)
        for g, jg in zip(mine, theirs):
            assert (g.rowptr == jg.rowptr).all() and (g.colind == jg.colind).all()


def _main_json(main, argv, capsys) -> dict:
    """One worker's JSON stats line, run in this process."""
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_two_port_workers_share_one_file(tmp_path, capsys):
    """The second worker, started after the first flushed, opens every
    bucket warm and probes nothing; a replay of the merged file (in this
    process) serves the second worker's choices."""
    from repro_torch.shared_worker import main

    path = str(tmp_path / "fleet.json")
    args = ("--shared", "--n-graphs", "12", "--f", "16")
    (a,) = _communicate([_worker(path, *args, "--seed", "1")])
    (b,) = _communicate([_worker(path, *args, "--seed", "2")])
    sa, sb = json.loads(a)["stats"], json.loads(b)["stats"]
    assert sa["probes_run"] >= 1
    assert sb["probes_run"] == 0 and sb["warm_cache_opens"] == sb["buckets"]
    r = _main_json(main, ["--cache", path, "--replay", "--n-graphs", "12", "--f", "16",
                          "--seed", "2", "--device", "cpu"], capsys)
    assert r["trace_choices"] == json.loads(b)["trace_choices"]


def test_one_jax_and_one_port_process_share_one_file(tmp_path, capsys, monkeypatch):
    """A JAX worker (benchmarks/shared_worker.py) and a port worker flush
    into one file concurrently under the lockfile: every bucket of both
    survives, and each package loads the result and replays its own
    stream from it (in this process). The two name their device classes
    apart, as two device kinds do."""
    from benchmarks.shared_worker import main as jx_main
    from repro_torch.shared_worker import main

    path = str(tmp_path / "mixed.json")
    # budget 0: every bucket is pinned by finalize without a probe, so the
    # two processes flush concurrently without timing anything
    args = ("--shared", "--n-graphs", "12", "--f", "16", "--seed", "1", "--budget-ms", "0")
    jx = _worker(path, *args, module="benchmarks.shared_worker",
                 extra_env={"AUTOSAGE_DEVICE_SIG_OVERRIDE": "jax-cpu",
                            "AUTOSAGE_TRANSFER": "0"})
    pt = _worker(path, *args, extra_env={"AUTOSAGE_DEVICE_SIG_OVERRIDE": "torch-cpu",
                                         "AUTOSAGE_TRANSFER": "0"})
    out_jx, out_pt = _communicate([jx, pt])
    jx_keys = set(json.loads(out_jx)["trace_keys"])
    pt_keys = set(json.loads(out_pt)["trace_keys"])
    data = json.load(open(path))
    assert jx_keys <= set(data) and pt_keys <= set(data)
    assert all(k.startswith("bucket|jax-cpu|") for k in jx_keys)
    assert all(k.startswith("bucket|torch-cpu|") for k in pt_keys)
    assert not os.path.exists(path + ".lock")
    assert len(JxCache(path=path)) == len(ScheduleCache(path=path)) == len(data)
    replay = ["--cache", path, "--replay", "--n-graphs", "12", "--f", "16", "--seed", "1"]
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "jax-cpu")
    r_jx = _main_json(jx_main, replay, capsys)
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "torch-cpu")
    r_pt = _main_json(main, replay + ["--device", "cpu"], capsys)
    assert r_jx["trace_choices"] == json.loads(out_jx)["trace_choices"]
    assert r_pt["trace_choices"] == json.loads(out_pt)["trace_choices"]


def test_jax_batch_scheduler_warm_opens_from_a_port_written_file(tmp_path, fixed_probe,
                                                                 monkeypatch):
    """Under one device signature the two packages' bucket keys are the
    same strings: a JAX BatchScheduler opens every bucket a port one
    finalized warm (library candidates, named alike in both)."""
    from repro.sparse import fixed_degree as jx_fixed_degree
    from repro.sparse import sample_subgraph_stream as jx_stream

    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "one-dev")
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    path = str(tmp_path / "c.json")
    parents = [fixed_degree(2048, 12, seed=1), fixed_degree(2048, 48, seed=2)]
    with BatchScheduler(_tiny_sage(path, shared=True), probe_budget_ms=10_000) as bs:
        for g in sample_subgraph_stream(parents, 8, rows_per_graph=256, seed=3):
            bs.decide(g, 16, "spmm")
    jparents = [jx_fixed_degree(2048, 12, seed=1), jx_fixed_degree(2048, 48, seed=2)]
    jbs = JxBatch(JxSage(cache=JxCache(path=path, shared=True), probe_iters=1,
                         probe_cap_ms=25, probe_frac=0.25), probe_budget_ms=10_000)
    choices = [jbs.decide(g, 16, "spmm").choice
               for g in jx_stream(jparents, 8, rows_per_graph=256, seed=3)]
    s = jbs.stats()
    assert s["probes_run"] == 0 and s["warm_cache_opens"] == s["buckets"]
    assert choices == [e["choice"] for e in bs.trace]


def test_train_gnn_fleet_mode_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`train_gnn --workers 2` on the CPU (its parent in this process):
    both minibatch trainers exit 0 on one shared file, each reports its
    stream stats with no fault and no fallback, and the merged file
    loads in both packages."""
    from repro_torch import train_gnn

    path = str(tmp_path / "fleet.json")
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    train_gnn.main(["--device", "cpu", "--workers", "2", "--minibatch", "256", "--epochs", "1",
                    "--scale", "0.005", "--cache", path])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    workers = summary["workers"]
    assert len(workers) == 2 and summary["cache"] == path
    for w in workers:
        assert w["decides"] > 0 and w["buckets"] > 0
        assert w["autosage_faults_total"] == w["autosage_fallback_total"] == 0
    assert len(ScheduleCache(path=path, replay_only=True)) == len(JxCache(path=path)) > 0
