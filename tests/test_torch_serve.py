"""repro_torch's online serving tier (launch/serve.py) on the CPU: twins
of tests/test_serve.py, the same served stream through the JAX package's
`GNNServer` and the port's, the probe worker's card-fault re-raise, the
thread-locality of `last_inline_probes` and the runner and layout memos
under concurrent callers.

Every scheduler here probes through a fixed per-family timer
(monkeypatched in this file only; it still fires the ``probe`` fault
point, so the hang injection bites), so no tier or choice depends on
wall-clock probes. Tolerances: tiers, sources, choices, buckets and
counts exact; served outputs against the JAX package's rtol 1e-5, atol
1e-6 * max|ref| (the two sum in another order); a provisional answer
against the port's own baseline bit for bit.
"""
import json
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AutoSage as JxSage
from repro.core import BatchScheduler as JxBatch
from repro.core import ScheduleCache as JxCache
from repro.core import probe as jx_probe
from repro.core.probe import ProbeResult as JxProbeResult
from repro.launch.serve import GNNServer as JxServer
from repro.sparse import fixed_degree as jx_fixed_degree
from repro.sparse import sample_subgraph_stream as jx_stream
from repro_torch.core import AutoSage, BatchScheduler, InputFeatures, ScheduleCache
from repro_torch.core import faultinject, obs, probe as probe_mod, registry, resilience
from repro_torch.core import scheduler as scheduler_mod
from repro_torch.core import telemetry
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import GNNServer
from repro_torch.sparse import fixed_degree, sample_subgraph_stream

torch.set_num_threads(1)  # see test_torch_spmm.py

_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0}


def _family_ms(name):
    return _FAMILY_MS.get(name.split("[")[0], 6.0)


def _port_fixed_timer(fn, device, iters=1, cap_ms=0.0, name="?"):
    faultinject.fault_point("probe", name=name)
    ms = _family_ms(name)
    return probe_mod.ProbeResult(name, ms, [ms], 1, False)


def _jax_fixed_timer(fn, iters=1, cap_ms=0.0, name="?"):
    ms = _family_ms(name)
    return JxProbeResult(name, ms, [ms], 1, False)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh metrics, no injected faults, no ambient serve or telemetry
    env, and each package's probe timer at a fixed cost per family."""
    for k in ("AUTOSAGE_SERVE_BUDGET_MS", "AUTOSAGE_TELEMETRY_DIR", "AUTOSAGE_FAULT",
              "AUTOSAGE_PROBE_PALLAS", "AUTOSAGE_OBS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(probe_mod, "time_callable", _port_fixed_timer)
    monkeypatch.setattr(jx_probe, "time_callable", _jax_fixed_timer)
    faultinject.reset()
    obs.REGISTRY.reset()
    yield
    faultinject.reset()
    obs.REGISTRY.reset()
    telemetry.close_streams()


def _sage(path=None, replay=False):
    return AutoSage(cache=ScheduleCache(path=path, replay_only=replay), device="cpu",
                    probe_iters=1, probe_cap_ms=25, probe_frac=0.25)


def _server(path=None, replay=False, **kw):
    return GNNServer(BatchScheduler(_sage(path, replay), probe_budget_ms=10_000), **kw)


def _stream(n=12, regimes=2, seed=0):
    parents = [fixed_degree(1024, d, seed=seed + i) for i, d in enumerate((4, 16)[:regimes])]
    return sample_subgraph_stream(parents, n, rows_per_graph=192, seed=seed + 9)


# ----------------------------------------------------- tier semantics
def test_cold_bucket_serves_provisional_then_upgrades_to_warm():
    server = _server()
    stream = _stream(8, regimes=2)
    first = [server.submit(g, 16) for g in stream]
    assert all(r.tier == "provisional" for r in first[:2])
    assert all(not r.stalled for r in first)
    assert server.drain(timeout_s=30.0)
    assert server.upgrades >= 2  # both buckets upgraded in the background
    second = [server.submit(g, 16) for g in stream]
    assert all(r.tier == "warm" for r in second)
    stats = server.close()
    assert stats["stalls"] == 0
    assert stats["by_tier"].get("cold", 0) == 0


def test_provisional_answer_is_bit_identical_to_baseline_oracle():
    server = _server(background_probes=False)  # the bucket stays provisional
    g = _stream(1)[0]
    f = 16
    r = server.submit(g, f)
    assert r.tier == "provisional"
    b = torch.from_numpy(np.random.default_rng(0).standard_normal((g.n_cols, f))
                         .astype(np.float32))
    out = server.run(g, r.decision)(b)
    feat = InputFeatures.from_csr(g, f, "spmm")
    device = server.bs.sage.device
    base = registry.baseline(feat, server.bs.sage.hw, device)
    exp = base.build(base.prepare(g), device)(b)
    assert torch.equal(out, exp)
    server.close(finalize=False)


def test_upgrade_notification_carries_probe_event():
    server = _server()
    server.submit(_stream(1)[0], 16)
    assert server.drain(timeout_s=30.0)
    server.close()
    assert server.upgrades >= 1
    ev = server.upgrade_events[0]
    assert ev["bucket"] and ev["choice"]
    assert obs.REGISTRY.total("autosage_serve_upgrades_total") >= 1


def test_upgrade_callback_error_is_counted_and_the_upgrade_stands():
    bs = BatchScheduler(_sage(), probe_budget_ms=10_000, auto_pump=False)
    bs.on_upgrade = lambda event: 1 / 0
    g = _stream(1)[0]
    bs.decide(g, 16, "spmm")
    assert bs.pump() == 1
    assert obs.REGISTRY.total("autosage_serve_upgrade_cb_errors_total") == 1
    bs.decide(g, 16, "spmm")
    assert bs.last_source == "probe"


# ------------------------------------------------- hung-probe SLO test
def test_hung_probe_never_delays_a_request(monkeypatch):
    """Every probe hangs for 0.4 s; with the worker owning the probes, no
    request may exceed the decision budget."""
    monkeypatch.setenv("AUTOSAGE_FAULT", "probe::hang:")
    monkeypatch.setenv("AUTOSAGE_FAULT_HANG_S", "0.4")
    monkeypatch.setenv("AUTOSAGE_SERVE_BUDGET_MS", "200")
    faultinject.reset()
    server = _server()
    assert server.budget_ms == 200.0
    results = [server.submit(g, 16) for g in _stream(10, regimes=2)]
    assert all(r.latency_ms < server.budget_ms for r in results)
    assert all(not r.stalled for r in results)
    assert server.stalls == 0
    deadline = time.perf_counter() + 30.0
    while not faultinject.fired() and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert sum(faultinject.fired().values()) >= 1  # the injection really hit
    stats = server.close(timeout_s=5.0)
    assert stats["stalls"] == 0
    assert obs.REGISTRY.total(obs.PROBE_STALLS) == 0


def test_auto_pump_is_forced_off_for_serving():
    bs = BatchScheduler(_sage(), auto_pump=True)
    server = GNNServer(bs, background_probes=False)
    assert bs.auto_pump is False
    r = server.submit(_stream(1)[0], 16)
    assert not r.stalled
    server.close(finalize=False)


# ------------------------------------------------------- replay + cache
def test_served_stream_replays_bit_identically(tmp_path):
    path = str(tmp_path / "cache.json")
    stream = _stream(10, regimes=2)
    server = _server(path)
    for g in stream:
        server.submit(g, 16)
    assert server.drain(timeout_s=30.0)
    server.close()  # finalize pins every bucket decision
    finals = {r["bucket"]: r["choice"] for r in server.bs.bucket_stats()}

    replay = _server(path, replay=True)
    assert replay._worker is None  # replay never starts a prober
    res = [replay.submit(g, 16) for g in stream]
    assert replay.bs.stats()["probes_run"] == 0
    assert all(r.tier == "warm" for r in res)
    assert all(r.decision.choice == finals[r.bucket] for r in res)
    replay.close(finalize=False)


# ------------------------------------------------- metrics + telemetry
def test_serve_metrics_and_latency_table():
    server = _server()
    stream = _stream(6, regimes=2)
    for g in stream:
        server.submit(g, 16)
    server.drain(timeout_s=30.0)
    for g in stream:
        server.submit(g, 16)
    stats = server.close()
    assert stats["requests"] == 12
    assert obs.REGISTRY.total(obs.SERVE_REQUESTS) == 12
    assert obs.REGISTRY.total(obs.SERVE_REQUESTS, tier="warm") == 6
    rows = obs.serve_latency_table()
    assert sum(r["requests"] for r in rows) == 12
    for r in rows:
        assert r["p50_ms"] is not None and r["p99_ms"] >= r["p50_ms"] >= 0
        assert set(r["tiers"]) <= {"warm", "transfer", "provisional", "cold"}
    assert stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"] <= stats["max_ms"]


def test_serve_events_jsonl_stream(monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path))
    server = _server()
    server.submit(_stream(1)[0], 16)
    server.drain(timeout_s=30.0)
    server.close()
    telemetry.close_streams()
    lines = [json.loads(ln) for ln in (tmp_path / "serve_events.jsonl").read_text().splitlines()]
    kinds = [ln["event"] for ln in lines]
    assert "request" in kinds and "upgrade" in kinds and "summary" in kinds
    req = next(ln for ln in lines if ln["event"] == "request")
    assert req["tier"] == "provisional" and req["stalled"] is False
    assert req["latency_ms"] >= 0 and req["budget_ms"] > 0
    assert all("t_mono" in ln and ln["device_sig"] for ln in lines)


def test_serve_events_off_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    server = _server(background_probes=False)
    server.submit(_stream(1)[0], 16)
    server.close(finalize=False)
    assert not list(tmp_path.rglob("*.jsonl"))


# ----------------------------------------------------------------- CLI
def test_cli_default_subcommand_is_serve_gnn(capsys):
    rc = serve_mod.main(["--clients", "2", "--requests", "6", "--passes", "1",
                         "--regimes", "2", "--rows", "128", "--think-ms", "0",
                         "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve]" in out and "latency" in out and "device=cpu" in out


def test_budget_env_knob(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_SERVE_BUDGET_MS", "123.5")
    assert serve_mod._budget_ms() == 123.5
    monkeypatch.setenv("AUTOSAGE_SERVE_BUDGET_MS", "nonsense")
    assert serve_mod._budget_ms() == serve_mod.DEFAULT_SERVE_BUDGET_MS


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.run_serve_gnn(requests=2, quiet=True)
    server = GNNServer(device="cpu", background_probes=False)
    assert server.bs.sage.device.type == "cpu"
    server.close(finalize=False)


# --------------------------------------------------- against the JAX side
_TIMING = ("probe_overhead_ms", "budget_spent_ms")


def test_served_stream_matches_jax():
    """One 12-request stream through both packages' servers, with an
    explicit pump between the passes: the same (bucket, tier, source,
    choice) per request, the same upgrade events less their timing
    fields, the same counts, and served outputs within tolerance."""
    parents = [fixed_degree(1024, d, seed=i) for i, d in enumerate((4, 16))]
    jparents = [jx_fixed_degree(1024, d, seed=i) for i, d in enumerate((4, 16))]
    stream = sample_subgraph_stream(parents, 12, rows_per_graph=192, seed=9)
    jstream = jx_stream(jparents, 12, rows_per_graph=192, seed=9)
    server = _server(background_probes=False)
    jserver = JxServer(JxBatch(JxSage(cache=JxCache(path=None), probe_iters=1,
                                      probe_cap_ms=25, probe_frac=0.25),
                               probe_budget_ms=10_000), background_probes=False)
    seqs = {"port": [], "jax": []}
    outs = {"port": [], "jax": []}
    rng = np.random.default_rng(3)
    bs_ = [rng.standard_normal((g.n_cols, 16)).astype(np.float32) for g in stream]
    pumped = []
    for _ in range(2):
        for i, (g, jg) in enumerate(zip(stream, jstream)):
            for label, srv, graph, arr in (("port", server, g, torch.from_numpy(bs_[i])),
                                           ("jax", jserver, jg, jnp.asarray(bs_[i]))):
                r = srv.submit(graph, 16)
                seqs[label].append((r.bucket, r.tier, r.source, r.decision.choice))
                outs[label].append(np.asarray(srv.run(graph, r.decision)(arr)))
        pumped.append((server.bs.pump(), jserver.bs.pump()))
    assert pumped[0][0] >= 1 and pumped == [(n, n) for n, _ in pumped]
    assert seqs["port"] == seqs["jax"]
    assert {t for _, t, _, _ in seqs["port"]} == {"provisional", "warm"}
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))

    def strip(events):
        return [{k: v for k, v in e.items() if k not in _TIMING} for e in events]

    assert strip(server.upgrade_events) == strip(jserver.upgrade_events)
    stats, jstats = server.close(), jserver.close()
    keys = ("requests", "by_tier", "stalls", "over_budget", "upgrades", "budget_ms",
            "pending_buckets", "buckets")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}


# ------------------------------------------------ the worker's card faults
def _surfaced():
    return resilience.surface(RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 1"))


@pytest.mark.parametrize("make_exc, kept", [
    (_surfaced, True),  # what a kernel site on the card raises
    (lambda: RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (lambda: faultinject.InjectedFault("probe", "v", "raise"), False),
    (lambda: RuntimeError("probe machinery failed"), False),  # CPU: counted only
], ids=["card-fault", "sticky-cuda-error", "injected", "cpu-fault"])
def test_worker_keeps_a_card_fault_and_reraises_it(monkeypatch, make_exc, kept):
    """On a card a kernel's real fault in the probe worker re-raises at
    the next submit, drain and close, and the worker stops probing;
    injected faults, and faults on the CPU, are only counted, as in the
    JAX package."""
    exc = make_exc()
    server = _server()
    pumps = []

    def pump(max_probes=None):
        pumps.append(1)
        raise exc

    monkeypatch.setattr(server.bs, "pump", pump)
    g = _stream(1)[0]
    server.submit(g, 16)  # provisional: wakes the worker
    deadline = time.perf_counter() + 10.0
    while not pumps and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert pumps
    if kept:
        server._worker.join(10.0)
        assert not server._worker.is_alive()  # the worker stopped probing
        for call in (lambda: server.submit(g, 16), lambda: server.drain(1.0), server.close):
            with pytest.raises(type(exc)) as info:
                call()
            assert info.value is exc
    else:
        r = server.submit(g, 16)
        assert r.tier == "provisional"
        assert server._worker.is_alive()
        server.close(finalize=False)
    assert obs.REGISTRY.total("autosage_serve_probe_errors_total") >= 1


# ---------------------------------------------- thread-local decide views
def test_last_inline_probes_is_thread_local():
    """Each thread reads its own decide's inline probe count, and a warm
    decide resets it: a stale count would turn a warm request cold."""
    bs = BatchScheduler(_sage(), probe_budget_ms=10_000, auto_pump=True)
    stream = _stream(4, regimes=2)
    seen = {}
    cold_done, warm_done = threading.Event(), threading.Event()

    def cold():
        bs.decide(stream[0], 16, "spmm")  # a cold bucket: one inline probe
        seen["cold_first"] = bs.last_inline_probes
        cold_done.set()
        assert warm_done.wait(10.0)
        seen["cold_after"] = bs.last_inline_probes  # the other thread decided since
        bs.decide(stream[0], 16, "spmm")  # now warm
        seen["cold_warm"] = bs.last_inline_probes

    def warm():
        assert cold_done.wait(10.0)
        bs.decide(stream[0], 16, "spmm")  # the bucket the other thread probed
        seen["warm"] = bs.last_inline_probes
        warm_done.set()

    threads = [threading.Thread(target=cold), threading.Thread(target=warm)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert seen == {"cold_first": 1, "cold_after": 1, "warm": 0, "cold_warm": 0}

    bs.decide(stream[1], 16, "spmm")
    assert bs.last_inline_probes == 1
    server = GNNServer(bs, background_probes=False)  # auto_pump off from here
    r = server.submit(stream[1], 16)
    assert r.tier == "warm" and not r.stalled and server.stalls == 0
    server.close(finalize=False)


# ------------------------------------------------- memos under concurrency
def _hammer(fn, args_per_thread):
    """Run fn on each args tuple in its own thread, all released at once,
    with a short switch interval; returns the results in order."""
    out = [None] * len(args_per_thread)
    errors = []
    gate = threading.Barrier(len(args_per_thread))

    def work(i, args):
        try:
            gate.wait(10.0)
            out[i] = fn(*args)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i, a))
                   for i, a in enumerate(args_per_thread)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    return out


@pytest.mark.parametrize("resilience_on", ["0", "1"])
def test_build_runner_builds_once_per_key_under_concurrent_callers(monkeypatch,
                                                                   resilience_on):
    """Four threads, two per key: one build per key, no exception, and
    outputs equal to a single thread's."""
    monkeypatch.setenv("AUTOSAGE_RESILIENCE", resilience_on)
    sage = _sage()
    graphs = _stream(2, regimes=2)
    decisions = [sage.decide(g, 16, "spmm") for g in graphs]
    b = [torch.from_numpy(np.random.default_rng(i).standard_normal((g.n_cols, 16))
                          .astype(np.float32)) for i, g in enumerate(graphs)]
    want = [scheduler_mod._build_raw(g, d, "", sage.device)(bb)
            for g, d, bb in zip(graphs, decisions, b)]
    builds = []
    raw = scheduler_mod._build_raw

    def counting(csr, decision, graph_sig, device):
        builds.append(graph_sig)
        time.sleep(0.05)  # widen the race
        return raw(csr, decision, graph_sig, device)

    monkeypatch.setattr(scheduler_mod, "_build_raw", counting)
    picks = [0, 0, 1, 1]

    def build_and_run(i):
        return sage.build_runner(graphs[i], decisions[i])(b[i])

    got = _hammer(build_and_run, [(i,) for i in picks])
    assert sorted(builds) == sorted({s for s in builds}) and len(builds) == 2
    for i, out in zip(picks, got):
        assert torch.equal(out, want[i])
    assert len(sage._runners) == 2


def test_ragged_layout_memo_builds_once_per_key(monkeypatch):
    monkeypatch.setattr(registry, "LAYOUT_MEMO_MIN_NNZ", 0)
    registry.clear_layout_memo()
    g = fixed_degree(512, 8, seed=0)
    builds = []
    conv = registry.csr_to_ragged

    def counting(csr, rb, bc):
        builds.append((rb, bc))
        time.sleep(0.05)
        return conv(csr, rb, bc)

    monkeypatch.setattr(registry, "csr_to_ragged", counting)
    try:
        keys = [(8, 8), (8, 8), (16, 8), (16, 8)]
        got = _hammer(lambda rb, bc: registry.ragged_layout(g, rb, bc), keys)
        assert sorted(builds) == [(8, 8), (16, 8)]
        assert got[0] is got[1] and got[2] is got[3]
        want = conv(g, 8, 8)[0]
        assert np.array_equal(got[0][0].slot_colblk, want.slot_colblk)
    finally:
        registry.clear_layout_memo()
