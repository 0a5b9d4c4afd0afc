"""repro_torch's BatchScheduler, schedule buckets, stream generators and
minibatch training on the CPU, against the JAX package: bucket sigs and
keys, generator arrays, twins of tests/test_batch.py and
tests/test_drift.py, and the minibatch forward and three minibatch SGD
steps from the same weights.

The drift twins feed `observe` from a deterministic cost model, as
tests/test_drift.py does, and replace each package's probe timer with a
fixed per-family cost (monkeypatched in the test only), so no verdict
depends on wall-clock probes.

Tolerances: generators, sigs and keys exact; the minibatch forward and
three SGD steps rtol 1e-4, atol 1e-4 * max|ref| (fp32 matmuls and sparse
sums in another order, each step feeding the next); scheduled against
unscheduled in one package rtol 1e-5, atol 1e-5 * max|ref|."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.configs.gnn_sage import CONFIG
from repro.core import AutoSage as JxSage
from repro.core import BatchScheduler as JxBatch
from repro.core import InputFeatures as JxFeat
from repro.core import ScheduleBucket as JxBucket
from repro.core import ScheduleCache as JxCache
from repro.core import probe as jx_probe
from repro.core.probe import ProbeResult as JxProbeResult
from repro.models import gnn as jx_gnn
from repro.sparse import fixed_degree as jx_fixed_degree
from repro.sparse import generators as jx_gen
from repro.sparse import hub_skew as jx_hub_skew
from repro_torch import api
from repro_torch.core import (
    AutoSage,
    BatchScheduler,
    InputFeatures,
    ReplayMiss,
    ScheduleBucket,
    ScheduleCache,
)
from repro_torch.core import probe as probe_mod
from repro_torch.core.batch import _BucketState
from repro_torch.models.gnn import norm_csr, sage_minibatch_forward, sage_params_from_jax
from repro_torch.sparse import (
    fixed_degree,
    hub_skew,
    power_law,
    reddit_like,
    regime_shift_stream,
    sample_subgraph_stream,
    table10_graph,
)
from repro_torch.train_gnn import LR, make_data, minibatch_rows, train_minibatch

torch.set_num_threads(1)  # see test_torch_spmm.py


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _tiny_sage(path=None, **kw):
    return AutoSage(cache=ScheduleCache(path=path, **kw), device="cpu", probe_iters=1,
                    probe_cap_ms=25, probe_frac=0.25)


def _feat(n_rows=1024, nnz=4096, f=32, op="spmm", skew=1.0, density=1e-3):
    avg = nnz / n_rows
    return InputFeatures(
        n_rows=n_rows, n_cols=n_rows, nnz=nnz, avg_deg=avg, deg_p50=avg,
        deg_p90=avg, deg_p99=avg * skew, deg_max=avg * skew, skew=skew,
        density=density, f=f, op=op, graph_sig="t", f_mod_4=(f % 4 == 0),
    )


# --------------------------------------------------- against the JAX package
def _graph_pairs():
    return {
        "fixed_degree": (fixed_degree(2048, 12, seed=1), jx_fixed_degree(2048, 12, seed=1)),
        "hub_skew": (hub_skew(1500, 4, 0.05, 200, seed=2), jx_hub_skew(1500, 4, 0.05, 200,
                                                                       seed=2)),
        "table10": (table10_graph(2000, 400, 16, seed=3), jx_gen.table10_graph(2000, 400, 16,
                                                                                seed=3)),
        "reddit_sub": (reddit_like(0.01, seed=0).row_slice(np.arange(0, 2329, 3)),
                       jx_gen.reddit_like(0.01, seed=0).row_slice(np.arange(0, 2329, 3))),
    }


@pytest.mark.parametrize("op,f", [("spmm", 256), ("spmm_bwd_b", 41), ("attention", 64)])
def test_bucket_sig_and_key_equal_jax(op, f):
    for name, (g, jg) in _graph_pairs().items():
        b = ScheduleBucket.from_features(InputFeatures.from_csr(g, f, op), "dev")
        jb = JxBucket.from_features(JxFeat.from_csr(jg, f, op), device="dev")
        assert dataclasses.asdict(b) == dataclasses.asdict(jb), name
        assert b.sig() == jb.sig(), name
        assert (ScheduleCache.bucket_key("dev", b.sig(), f, op, 0.95)
                == JxCache.bucket_key("dev", jb.sig(), f, op, 0.95))


def test_bucket_sig_of_a_transposed_sample_equals_jax():
    """The minibatch backward's bucket: the transpose of a rectangular
    row sample (all columns, few rows)."""
    g = reddit_like(0.02, seed=0)
    jg = jx_gen.reddit_like(0.02, seed=0)
    rows = np.sort(np.random.default_rng(1).choice(g.n_rows, 512, replace=False))
    t, _ = norm_csr(g.row_slice(rows)).transpose_with_perm()
    jt = jx_gnn._norm_csr(jg.row_slice(rows)).transpose()
    b = ScheduleBucket.from_features(InputFeatures.from_csr(t, 256, "spmm_bwd_b"), "d")
    jb = JxBucket.from_features(JxFeat.from_csr(jt, 256, "spmm_bwd_b"), device="d")
    assert b.sig() == jb.sig()


def _same_csr(a, b):
    np.testing.assert_array_equal(a.rowptr, b.rowptr)
    np.testing.assert_array_equal(a.colind, b.colind)
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    assert a.val is None and b.val is None


def test_stream_generators_equal_jax():
    _same_csr(table10_graph(3000, 500, 32, seed=4), jx_gen.table10_graph(3000, 500, 32, seed=4))
    parents = [fixed_degree(512, 5, seed=0), hub_skew(600, 3, 0.1, 40, seed=1)]
    jparents = [jx_fixed_degree(512, 5, seed=0), jx_hub_skew(600, 3, 0.1, 40, seed=1)]
    for a, b in zip(sample_subgraph_stream(parents, 5, 100, seed=2),
                    jx_gen.sample_subgraph_stream(jparents, 5, 100, seed=2)):
        _same_csr(a, b)
    for a, b in zip(regime_shift_stream(12, 64, n=512, seed=3),
                    jx_gen.regime_shift_stream(12, 64, n=512, seed=3)):
        _same_csr(a, b)


# ------------------------------------------------------- canonicalization
def test_bucket_deterministic_across_samples():
    parent = fixed_degree(4096, 6, seed=0)
    subs = sample_subgraph_stream([parent], 8, rows_per_graph=512, seed=1)
    buckets = {ScheduleBucket.from_features(InputFeatures.from_csr(g, 32, "spmm"), "dev")
               for g in subs}
    assert len(buckets) == 1
    b = buckets.pop()
    again = ScheduleBucket.from_features(InputFeatures.from_csr(subs[0], 32, "spmm"), "dev")
    assert again == b and again.sig() == b.sig()


def test_bucket_monotone_binning():
    def bins(field, **kw):
        return getattr(ScheduleBucket.from_features(_feat(**kw), "d"), field)

    assert [bins("rows_bin", n_rows=n) for n in (1, 7, 64, 65, 1000, 4096, 10**6)] == sorted(
        bins("rows_bin", n_rows=n) for n in (1, 7, 64, 65, 1000, 4096, 10**6))
    z = [bins("nnz_bin", nnz=n) for n in (1, 100, 4096, 5000, 10**7)]
    d = [bins("density_bin", density=x) for x in (1e-9, 1e-6, 3e-4, 0.02, 0.5)]
    s = [bins("skew_bin", skew=x) for x in (0.5, 1.0, 2.5, 9.0, 200.0)]
    assert z == sorted(z) and d == sorted(d) and s == sorted(s)


def test_bucket_distinct_f_op_device_never_share():
    base = ScheduleBucket.from_features(_feat(f=32, op="spmm"), "dev_a")
    others = [ScheduleBucket.from_features(_feat(f=64), "dev_a"),
              ScheduleBucket.from_features(_feat(op="sddmm"), "dev_a"),
              ScheduleBucket.from_features(_feat(), "dev_b")]
    assert all(o != base for o in others)

    def key(b):
        return ScheduleCache.bucket_key(b.device, b.sig(), b.f, b.op, 0.95)

    assert all(key(o) != key(base) for o in others)


# ------------------------------------------------------- budgeted streams
@pytest.fixture(scope="module")
def regime_stream():
    parents = [
        fixed_degree(2048, 3, seed=0),
        fixed_degree(2048, 12, seed=1),
        fixed_degree(2048, 48, seed=2),
        hub_skew(2048, 6, 0.10, 60, seed=3),
    ]
    return sample_subgraph_stream(parents, 64, rows_per_graph=256, seed=4)


def _b(g, f=16, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((g.n_cols, f)).astype(np.float32))


def test_stream_probes_once_per_bucket(regime_stream):
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=10_000)
    for g in regime_stream:
        bs.decide(g, 16, "spmm")
    stats = bs.stats()
    assert stats["decides"] == 64
    assert stats["buckets"] <= 8
    assert stats["probes_run"] <= stats["buckets"]
    assert stats["probes_avoided"] >= 64 - 8
    g = regime_stream[-1]
    b = _b(g)
    out, _ = bs.spmm(g, b)
    _close(out, api.spmm(g, b), rtol=1e-5)


def test_zero_budget_serves_guardrail_safe_baseline(regime_stream):
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=0.0)
    assert {bs.decide(g, 16, "spmm").choice for g in regime_stream[:8]} == {"baseline"}
    assert bs.stats()["probes_run"] == 0
    assert len(bs.pending()) > 0  # buckets wait for budget, not dropped


def test_budget_prioritizes_traffic_weighted_gain():
    parents = [fixed_degree(2048, 3, seed=0), fixed_degree(2048, 48, seed=1)]
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=10_000, auto_pump=False)
    light, heavy = sample_subgraph_stream(parents, 2, rows_per_graph=256, seed=2)
    bs.decide(light, 16, "spmm")
    for _ in range(5):  # the heavy regime gets 5x the traffic
        bs.decide(heavy, 16, "spmm")
    pend = bs.pending()
    assert len(pend) == 2
    best = max(pend, key=_BucketState.priority)
    assert bs.pump(1) == 1
    assert best.probed and best.decision is not None


def test_decision_upgrades_in_place(regime_stream):
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=0.0)
    g = regime_stream[2]  # the deg-48 regime: challengers beat the baseline
    d0 = bs.decide(g, 16, "spmm")
    assert d0.choice == "baseline" and bs.pending()
    bs.probe_budget_ms = 10_000.0  # budget arrives
    assert bs.pump() >= 1
    d1 = bs.decide(g, 16, "spmm")
    assert bs.stats()["pending_buckets"] == 0
    assert d1.probe_ms  # probed, not the provisional decision
    sources = [e["source"] for e in bs.trace]
    assert sources[0] == "provisional" and sources[-1] == "probe"
    assert bs.last_source == "probe"


def test_stream_replay_bit_identical(tmp_path, regime_stream):
    path = str(tmp_path / "cache.json")
    with BatchScheduler(_tiny_sage(path=path), probe_budget_ms=10_000) as bs:
        for g in regime_stream:
            bs.decide(g, 16, "spmm")
    finals = {r["bucket"]: r["choice"] for r in bs.bucket_stats()}
    g = regime_stream[5]
    want, _ = bs.spmm(g, _b(g))

    def replay():
        rbs = BatchScheduler(_tiny_sage(path=path, replay_only=True))
        out = [rbs.decide(g, 16, "spmm").choice for g in regime_stream]
        assert rbs.stats()["probes_run"] == 0
        return out, rbs

    c1, rbs = replay()
    c2, _ = replay()
    assert c1 == c2
    for ev, choice in zip(rbs.trace, c1):
        assert choice == finals[ev["bucket"]] and ev["source"] == "bucket-cache"
    got, _ = rbs.spmm(g, _b(g))
    assert torch.equal(got, want)
    with pytest.raises(ReplayMiss):
        rbs.decide(hub_skew(3000, 4, 0.05, 300, seed=9), 16, "spmm")


def test_finalize_pins_unprobed_buckets(tmp_path, regime_stream):
    path = str(tmp_path / "cache.json")
    with BatchScheduler(_tiny_sage(path=path), probe_budget_ms=0.0) as bs:
        for g in regime_stream[:8]:
            bs.decide(g, 16, "spmm")
    entries = json.loads((tmp_path / "cache.json").read_text())
    assert entries and all(e["probed"] is False and k.startswith("bucket|")
                           for k, e in entries.items())
    rbs = BatchScheduler(_tiny_sage(path=path, replay_only=True))
    assert all(rbs.decide(g, 16, "spmm").choice == "baseline" for g in regime_stream[:8])


def test_runner_memo_bounded_for_streams(regime_stream):
    sage = _tiny_sage()
    sage._runner_cap = 4
    bs = BatchScheduler(sage, probe_budget_ms=0.0)  # baseline only: cheap
    b = _b(regime_stream[0])
    for g in regime_stream[:10]:
        bs.spmm(g, b)
    assert len(sage._runners) <= 4
    g = regime_stream[9]  # the newest graph is still memoized (LRU)
    d = bs.decide(g, 16, "spmm")
    r1 = bs.build_runner(g, d)
    assert bs.build_runner(g, d) is r1


def test_write_trace_and_stream_telemetry(tmp_path, monkeypatch, regime_stream):
    from repro_torch.core import telemetry

    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path / "tel"))
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=0.0)
    for g in regime_stream[:3]:
        bs.decide(g, 16, "spmm")
    bs.finalize()
    path = tmp_path / "trace.jsonl"
    bs.write_trace(str(path))
    bs.write_trace(str(path))  # replaces, never appends
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [e["i"] for e in lines] == [0, 1, 2]
    telemetry.close_streams()
    events = [json.loads(x)["event"]
              for x in (tmp_path / "tel" / "batch_stream.jsonl").read_text().splitlines()]
    assert events == ["decide"] * 3 + ["finalize"]


# ------------------------------------------------------------ cache
def test_cache_deferred_flush(tmp_path):
    path = tmp_path / "cache.json"
    c = ScheduleCache(path=str(path))
    with c:
        c.put("k1", {"choice": "baseline"})
        c.put("k2", {"choice": "row_ell"})
        assert not path.exists()  # deferred: no write per put
    assert set(json.load(open(path))) == {"k1", "k2"}  # one write on exit
    c.put("k3", {"choice": "dense"})  # eager outside the context
    assert "k3" in json.load(open(path))
    c.add_hits("k3", 4)
    c.update_stats("k3", ewma_ms=2.5, obs=None)
    assert json.load(open(path))["k3"]["stats"]["hits"] == 0  # stats are deferred
    c.flush()
    on_disk = json.load(open(path))["k3"]["stats"]
    assert on_disk["hits"] == 4 and on_disk["ewma_ms"] == 2.5 and on_disk["obs"] == 0
    assert c.stats("k3") == on_disk and c.contains("k3") and not c.contains("k4")
    with pytest.raises(ValueError):
        c.update_stats("k3", hits=1)


def test_cache_corrupt_file_recovers(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text('{"truncated": ')
    c = ScheduleCache(path=str(path))
    assert len(c) == 0
    backup = tmp_path / "cache.json.corrupt"
    assert backup.exists() and backup.read_text() == '{"truncated": '
    c.put("k", {"choice": "baseline"})
    assert "k" in json.load(open(path))
    path2 = tmp_path / "list.json"
    path2.write_text("[1, 2]")
    assert len(ScheduleCache(path=str(path2))) == 0
    assert (tmp_path / "list.json.corrupt").exists()


# ------------------------------------------------------------- drift
_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0}


def _family_ms(name):
    return _FAMILY_MS.get(name.split("[")[0], 6.0)


def _port_fixed_timer(fn, device, iters=1, cap_ms=0.0, name="?"):
    ms = _family_ms(name)
    return probe_mod.ProbeResult(name, ms, [ms], 1, False)


def _jax_fixed_timer(fn, iters=1, cap_ms=0.0, name="?"):
    ms = _family_ms(name)
    return JxProbeResult(name, ms, [ms], 1, False)


@pytest.fixture
def fixed_probe(monkeypatch):
    """Each package's probe timer replaced by a fixed cost per family."""
    monkeypatch.setattr(probe_mod, "time_callable", _port_fixed_timer)
    monkeypatch.setattr(jx_probe, "time_callable", _jax_fixed_timer)
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)


def _tiny_bs(probe_budget_ms=60_000, **knobs):
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=probe_budget_ms)
    for k, v in knobs.items():
        setattr(bs, k, v)
    return bs


def _pinned_cost_ms(g) -> float:
    """Deterministic stand-in for the observed runtime of the uniform
    regime's winner (row-ELL): padded work n_rows x deg_max."""
    return g.n_rows * max(float(g.degrees.max()), 1.0) / 1e3


def _run_stream(stream, bs, f=16):
    for g in stream:
        bs.decide(g, f, "spmm")
        bs.observe(bs.bucket_of(g, f, "spmm"), _pinned_cost_ms(g))
    return bs


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_drift_fires_on_alpha_ramp(fixed_probe, seed):
    stream = regime_shift_stream(96, 256, n=1024, alpha_lo=0.2, alpha_hi=0.45, avg_deg=8,
                                 seed=seed)
    s = _run_stream(stream, _tiny_bs(drift_min_obs=3, drift_ratio=1.4)).stats()
    assert s["drift_flags"] >= 1, s
    assert s["drift_reprobes"] >= 1, s
    assert s["probes_run"] > s["buckets"], s


@pytest.mark.parametrize("alpha", [0.0, 0.2])
def test_drift_never_fires_on_stationary_stream(fixed_probe, alpha):
    stream = regime_shift_stream(96, 256, n=1024, alpha_lo=alpha, alpha_hi=alpha,
                                 avg_deg=8, seed=0)
    s = _run_stream(stream, _tiny_bs(drift_min_obs=3, drift_ratio=1.4)).stats()
    assert s["drift_flags"] == 0 and s["drift_reprobes"] == 0, s


def _drift_twin():
    """The drift stream through both packages' BatchSchedulers, with the
    same injected observations: (port, JAX)."""
    kw = dict(n=1024, alpha_lo=0.2, alpha_hi=0.45, avg_deg=8, seed=2)
    stream = regime_shift_stream(64, 256, **kw)
    jstream = jx_gen.regime_shift_stream(64, 256, **kw)
    bs = _run_stream(stream, _tiny_bs(drift_min_obs=3, drift_ratio=1.4))
    jbs = JxBatch(JxSage(cache=JxCache(path=None), probe_iters=1, probe_cap_ms=25,
                         probe_frac=0.25), probe_budget_ms=60_000)
    jbs.drift_min_obs, jbs.drift_ratio = 3, 1.4
    for g in jstream:
        jbs.decide(g, 16, "spmm")
        jbs.observe(jbs.bucket_of(g, 16, "spmm"), _pinned_cost_ms(g))
    return bs, jbs


def test_drift_stream_matches_jax(fixed_probe):
    """Both packages, the same stream, the same injected observations and
    the same fixed probe costs: the same buckets, choices, flags,
    re-probes and flips, decide by decide."""
    bs, jbs = _drift_twin()
    keys = ("decides", "buckets", "probes_run", "pending_buckets", "drift_flags",
            "drift_reprobes", "drift_flips")
    assert {k: bs.stats()[k] for k in keys} == {k: jbs.stats()[k] for k in keys}
    assert bs.stats()["drift_flags"] >= 1
    assert ([(e["bucket"], e["choice"], e["source"]) for e in bs.trace]
            == [(e["bucket"], e["choice"], e["source"]) for e in jbs.trace])


def test_counter_views_equal_jax_on_the_drift_twin(fixed_probe):
    """The int properties over the counters read what JAX's read, and what
    stats() reports."""
    bs, jbs = _drift_twin()
    names = ("drift_flags", "drift_reprobes", "drift_flips", "transfers",
             "transfers_confirmed", "transfers_flipped", "transfer_probe_free")
    got = {n: getattr(bs, n) for n in names}
    assert all(type(v) is int for v in got.values()), got
    assert got == {n: getattr(jbs, n) for n in names}
    assert got == {n: bs.stats()[n] for n in names}
    assert got["drift_flags"] >= 1


def _force_flag(bs, g, f=16):
    bs.decide(g, f, "spmm")
    bucket = bs.bucket_of(g, f, "spmm")
    pinned = bs._by_bucket[bucket].decision.choice
    for _ in range(bs.drift_min_obs):
        bs.observe(bucket, 1.0)  # calibration: the fresh decision's pace
    for _ in range(bs.ewma_window):
        bs.observe(bucket, 50.0)  # the regime underneath shifted
    return bucket, pinned


def test_reprobe_respects_probe_budget(fixed_probe):
    bs = _tiny_bs()
    _force_flag(bs, fixed_degree(1024, 18, seed=0))
    bs.decide(fixed_degree(1024, 18, seed=3), 16, "spmm")  # auto-pump
    assert bs.stats()["drift_reprobes"] >= 1

    bs2 = _tiny_bs()
    _, pinned = _force_flag(bs2, fixed_degree(1024, 18, seed=1))
    bs2.probe_budget_ms = bs2.probe_spent_ms  # budget exhausted now
    assert bs2.pump() == 0
    s = bs2.stats()
    assert s["drift_flags"] == 1 and s["drift_reprobes"] == 0 and s["pending_buckets"] == 1
    d = bs2.decide(fixed_degree(1024, 18, seed=2), 16, "spmm")
    assert d.choice == pinned and bs2.last_source == "drift-pending"
    bs2.probe_budget_ms += 10_000  # budget arrives
    assert bs2.pump() >= 1
    assert bs2.stats()["drift_reprobes"] == 1


def test_reprobe_priority_decays(fixed_probe):
    bs = _tiny_bs(probe_budget_ms=0.0)  # keep both buckets pending
    a, b = fixed_degree(2048, 12, seed=0), fixed_degree(2048, 48, seed=1)
    bs.decide(a, 16, "spmm")
    bs.decide(b, 16, "spmm")
    sa = bs._by_bucket[bs.bucket_of(a, 16, "spmm")]
    sb = bs._by_bucket[bs.bucket_of(b, 16, "spmm")]
    sb.hits = sa.hits
    sb.est_gain_ms = sa.est_gain_ms = 1.0
    sb.has_challengers = sa.has_challengers = True
    assert sa.priority() == sb.priority()
    sb.reprobes = 1
    assert sb.priority() < sa.priority()
    bs.probe_budget_ms = 10_000
    assert bs.pump(1) == 1
    assert sa.probed and not sb.probed


@given(hits=st.integers(1, 10**6), reprobes=st.integers(0, 10))
@settings(max_examples=30)
def test_priority_decay_monotone(hits, reprobes):
    base = dict(bucket=None, key="k", rep_csr=None, rep_feat=None, base=None, by_name={},
                estimates_ms={}, est_gain_ms=2.5, has_challengers=True, hits=hits)
    fresh = _BucketState(**base, reprobes=reprobes)
    worn = _BucketState(**base, reprobes=reprobes + 1)
    assert worn.priority() < fresh.priority()
    flagged = _BucketState(**{**base, "est_gain_ms": 0.0}, drift_flagged=True)
    idle = _BucketState(**{**base, "est_gain_ms": 0.0})
    assert flagged.priority() > idle.priority()


def _observed_bucket(seq):
    bs = _tiny_bs(probe_budget_ms=0.0)  # no probing needed for stats
    g = fixed_degree(512, 12, seed=0)
    bs.decide(g, 16, "spmm")
    bucket = bs.bucket_of(g, 16, "spmm")
    for x in seq:
        bs.observe(bucket, float(x))
    return bs, bucket


@given(n_obs=st.integers(2, 16), seed=st.integers(0, 10**6))
@settings(max_examples=25)
def test_ewma_permutation_invariant_within_window(n_obs, seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.1, 20.0, size=n_obs)
    perm = rng.permutation(obs)

    def ewma_of(seq):
        bs, bucket = _observed_bucket(seq)
        return bs._by_bucket[bucket].ewma_ms

    assert ewma_of(obs) == pytest.approx(ewma_of(perm), rel=1e-9)
    assert ewma_of(obs) == pytest.approx(float(obs.mean()), rel=1e-9)


def test_ewma_forgets_old_regime_beyond_window():
    bs, _ = _observed_bucket([1.0] * 16 + [10.0] * 80)
    assert bs.bucket_stats()[0]["ewma_ms"] > 9.0


def test_observe_routes_by_full_bucket_not_sig():
    bs = _tiny_bs(probe_budget_ms=0.0)
    g = fixed_degree(512, 12, seed=0)
    bs.decide(g, 16, "spmm")
    bs.decide(g, 16, "sddmm")
    b_spmm, b_sddmm = bs.bucket_of(g, 16, "spmm"), bs.bucket_of(g, 16, "sddmm")
    assert b_spmm.sig() == b_sddmm.sig()  # the collision under test
    bs.observe(b_spmm, 7.0)
    assert bs._by_bucket[b_spmm].obs == 1 and bs._by_bucket[b_spmm].ewma_ms == 7.0
    assert bs._by_bucket[b_sddmm].obs == 0 and bs._by_bucket[b_sddmm].ewma_ms is None
    bs.observe(b_spmm.sig(), 99.0)  # an ambiguous sig: ignored
    assert bs._by_bucket[b_spmm].obs == 1 and bs._by_bucket[b_sddmm].obs == 0


def test_waste_bin_shift_flags_drift(fixed_probe):
    bs = _tiny_bs()
    g = fixed_degree(1024, 18, seed=0)
    bs.decide(g, 16, "spmm")
    stt = bs._by_bucket[bs.bucket_of(g, 16, "spmm")]
    assert stt.probed
    stt.waste_at_probe = 0.2  # probed under a low-padding representative
    feat = dataclasses.replace(InputFeatures.from_csr(g, 16, "spmm"), padding_waste=0.8)
    bs._check_waste_drift(stt, feat)
    assert stt.drift_flagged and not stt.probed and "padding_waste" in stt.drift_reason
    bs2 = _tiny_bs()
    bs2.decide(g, 16, "spmm")
    st2 = bs2._by_bucket[bs2.bucket_of(g, 16, "spmm")]
    st2.waste_at_probe = 0.55  # same-bin movement is not drift
    bs2._check_waste_drift(st2, dataclasses.replace(InputFeatures.from_csr(g, 16, "spmm"),
                                                    padding_waste=0.7))
    assert not st2.drift_flagged


# ------------------------------------------------- minibatch SAGE
def _sage_pair(in_dim=24, classes=6, d_model=32):
    cfg = dataclasses.replace(CONFIG, d_model=d_model)
    params = jx_gnn.init_gnn(cfg, jax.random.PRNGKey(0), in_dim, classes)
    model = sage_params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def test_minibatch_forward_matches_jax():
    params, model = _sage_pair()
    g = power_law(900, 1.2, avg_deg=6.0, seed=5)
    rows = np.sort(np.random.default_rng(0).choice(g.n_rows, 200, replace=False))
    sub = g.row_slice(rows)
    x = np.random.default_rng(1).standard_normal((g.n_rows, 24)).astype(np.float32)
    want = jx_gnn.sage_minibatch_forward(params, sub, rows, jnp.asarray(x), sage=None)
    with torch.no_grad():
        got = sage_minibatch_forward(model, sub, rows, torch.from_numpy(x))
        bs = BatchScheduler(_tiny_sage(), probe_budget_ms=10_000)
        sched = model.minibatch_forward(sub, rows, torch.from_numpy(x), sage=bs)
    _close(got.numpy(), np.asarray(want))
    _close(sched.numpy(), got.numpy(), rtol=1e-5)
    assert bs.stats()["decides"] == 1


def test_minibatch_sgd_steps_match_jax(monkeypatch):
    """Three minibatch steps (train_minibatch's row sequence, rng seed 1)
    through a BatchScheduler in each package, from the same weights."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    params, model = _sage_pair()
    graph = hub_skew(600, 4, 0.05, 80, seed=3)
    jgraph = jx_hub_skew(600, 4, 0.05, 80, seed=3)
    feats, labels = make_data(graph, 6, 24, seed=1)
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=10_000)
    losses = train_minibatch(model, graph, torch.from_numpy(feats), torch.from_numpy(labels),
                             bs, minibatch=200, log=lambda _: None)
    assert len(losses) == 3
    s = bs.stats()
    assert s["decides"] == 6 and s["probes_run"] >= 1  # spmm + spmm_bwd_b per step

    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS")
    # the JAX side's probes would time XLA kernels by wall clock on every
    # core while other test files time theirs (tests/test_drift.py); its
    # choices only pick which fp32 sum order the losses are held to, so
    # it probes at fixed per-family costs instead
    monkeypatch.setattr(jx_probe, "time_callable", _jax_fixed_timer)
    jbs = JxBatch(JxSage(cache=JxCache(path=None), probe_iters=1, probe_cap_ms=25,
                         probe_frac=0.25), probe_budget_ms=10_000)
    jx_, jy = jnp.asarray(feats), jnp.asarray(labels)
    jx_losses = []
    for rows in minibatch_rows(graph.n_rows, 200, 3, seed=1):
        sub, yb = jgraph.row_slice(rows), jy[jnp.asarray(rows)]

        def loss_fn(p):
            logp = jax.nn.log_softmax(
                jx_gnn.sage_minibatch_forward(p, sub, rows, jx_, sage=jbs))
            return -jnp.take_along_axis(logp, yb[:, None], 1).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        params = jax.tree.map(lambda p, gg: p - LR * gg, params, g)
        jx_losses.append(float(loss))
    _close(losses, jx_losses)
    for name in ("w_agg", "w_self"):
        for got, want in zip(getattr(model, name), params[name]):
            _close(got.detach().numpy(), want)


def test_attention_through_batch_scheduler(monkeypatch):
    """An op="attention" bucket probes through the pipeline-level
    decide_attention (the fused kernels' plain versions in the pool) and
    serves the reference's output."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    g = hub_skew(600, 4, 0.05, 60, seed=4).dedup_edges()
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((g.n_rows, 16)).astype(np.float32))
               for _ in range(3))
    bs = BatchScheduler(_tiny_sage(), probe_budget_ms=10_000)
    got = api.attention(g, q, k, v, sage=bs, differentiable=False)
    assert bs.stats()["probes_run"] == 1 and bs.last_source == "probe"
    assert bs.trace[0]["op"] == "attention"
    _close(got.numpy(), api.attention(g, q, k, v).numpy(), rtol=1e-5)
