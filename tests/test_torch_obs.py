"""repro_torch's flight recorder (core/obs.py) and obs_cli on the CPU:
twins of tests/test_obs.py and of tests/test_resilience.py's explain
test, then the same inputs through both packages: histogram quantiles,
the Prometheus text line for line, the JSON snapshot, the scorecard, the
serve-latency table and the summary text equal, and each package's
`obs_cli explain` reading the other's cache file (schema v6, one key
grammar) into the same narrative, apart from the device and the
timestamps.

Schedulers probe through a fixed per-family timer (monkeypatched in the
test only); the multiprocess test starts 2 writers, each with one
thread under `nice`.
"""
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import obs_cli as jx_obs_cli
from repro.core import AutoSage as JxSage
from repro.core import BatchScheduler as JxBatch
from repro.core import ScheduleCache as JxCache
from repro.core import obs as jx_obs
from repro.core import probe as jx_probe
from repro.core.probe import ProbeResult as JxProbeResult
from repro.sparse import fixed_degree as jx_fixed_degree
from repro_torch import obs_cli
from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache, obs, resilience, telemetry
from repro_torch.core import probe as probe_mod
from repro_torch.core.obs import Histogram, MetricsRegistry, ScopedCounter
from repro_torch.sparse import fixed_degree
from repro_torch.sparse.csr import TRANSPOSE_STATS, reset_transpose_stats

torch.set_num_threads(1)  # see test_torch_spmm.py

SRC = str(Path(__file__).resolve().parent.parent / "src")


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch, tmp_path):
    """A fresh recorder in both packages, an obs dir per test, and obs
    off unless the test opts in."""
    monkeypatch.delenv("AUTOSAGE_OBS", raising=False)
    monkeypatch.delenv("AUTOSAGE_REPLAY_ONLY", raising=False)
    monkeypatch.delenv("AUTOSAGE_TELEMETRY_DIR", raising=False)
    monkeypatch.setenv("AUTOSAGE_OBS_DIR", str(tmp_path / "obs"))
    obs.reset()
    jx_obs.reset()
    reset_transpose_stats()
    yield
    obs.reset()
    jx_obs.reset()
    reset_transpose_stats()


_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0}


def _family_ms(name):
    return _FAMILY_MS.get(name.split("[")[0], 6.0)


@pytest.fixture
def fixed_probe(monkeypatch):
    """Each package's probe timer replaced by a fixed cost per family."""
    def port(fn, device, iters=1, cap_ms=0.0, name="?"):
        return probe_mod.ProbeResult(name, _family_ms(name), [_family_ms(name)], 1, False)

    def jax_(fn, iters=1, cap_ms=0.0, name="?"):
        return JxProbeResult(name, _family_ms(name), [_family_ms(name)], 1, False)

    monkeypatch.setattr(probe_mod, "time_callable", port)
    monkeypatch.setattr(jx_probe, "time_callable", jax_)
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)


def _tiny_bs(path=None):
    return BatchScheduler(AutoSage(cache=ScheduleCache(path=path), device="cpu", probe_iters=1,
                                   probe_cap_ms=25, probe_frac=0.25),
                          probe_budget_ms=10_000)


# ------------------------------------------------------------- gating
def test_disabled_records_nothing_and_writes_nothing(tmp_path):
    with obs.span("decide", op="spmm"):
        with obs.span("probe"):
            pass
    assert obs.span_names() == []
    assert obs.flush() == {}
    assert not (tmp_path / "obs").exists()


def test_replay_only_disables_even_with_obs_set(monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setenv("AUTOSAGE_REPLAY_ONLY", "1")
    assert not obs.enabled()
    with obs.span("decide"):
        pass
    assert obs.span_names() == []
    assert obs.flush() == {}
    assert not (tmp_path / "obs").exists()


def test_enabled_is_read_per_call(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with obs.span("a"):
        pass
    monkeypatch.setenv("AUTOSAGE_OBS", "0")
    with obs.span("b"):
        pass
    assert obs.span_names() == ["a"]


# ----------------------------------------------------- spans + schema
def test_span_nesting_and_golden_schema(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with obs.span("decide", op="spmm", f=16):
        with obs.span("features", op="spmm"):
            pass
        with obs.span("probe", n_candidates=3):
            pass
    recs = {r["name"]: r for r in map(obs._render, obs._spans)}
    assert set(recs) == {"decide", "features", "probe"}
    for r in recs.values():
        assert r["schema"] == obs.OBS_SCHEMA == jx_obs.OBS_SCHEMA
        assert r["ph"] == "X"
        assert isinstance(r["ts_us"], int) and isinstance(r["dur_us"], int)
        assert r["dur_us"] >= 1
        assert isinstance(r["t_mono"], float)
        assert r["pid"] == os.getpid()
    assert recs["decide"]["parent"] is None and recs["decide"]["depth"] == 0
    assert recs["features"]["parent"] == "decide"
    assert recs["probe"]["parent"] == "decide" and recs["probe"]["depth"] == 1
    assert recs["decide"]["args"] == {"op": "spmm", "f": 16}
    assert recs["features"]["t_mono"] >= recs["decide"]["t_mono"]
    # the record carries the JAX package's keys, no more and no fewer
    with jx_obs.span("decide", op="spmm", f=16):
        pass
    assert set(jx_obs._render(jx_obs._spans[0])) == set(recs["decide"])


def test_flush_and_export_trace_load_as_chrome_json(monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with obs.span("decide", op="spmm"):
        with obs.span("probe"):
            pass
    paths = obs.flush()
    trace = json.loads(Path(paths["trace"]).read_text())
    assert {e["name"] for e in trace["traceEvents"]} == {"decide", "probe"}
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and e["cat"] == "autosage"
        assert e["ts"] > 0 and e["dur"] >= 1
    lines = Path(paths["spans"]).read_text().splitlines()
    assert len(lines) == 2
    assert all(json.loads(ln)["schema"] == obs.OBS_SCHEMA for ln in lines)
    out = tmp_path / "merged.json"
    merged = obs.export_trace(str(out))
    assert json.loads(out.read_text()) == merged
    assert len(merged["traceEvents"]) == 2
    obs.flush()  # a second flush appends nothing new
    assert len(Path(paths["spans"]).read_text().splitlines()) == 2
    # the JAX package's exporter reads the port's spans.jsonl
    assert jx_obs.export_trace(str(tmp_path / "jx.json"),
                               directory=str(Path(paths["spans"]).parent)) == merged


def test_span_cap_drops_not_grows(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setattr(obs, "_SPAN_CAP", 5)
    for _ in range(9):
        with obs.span("x"):
            pass
    assert len(obs._spans) == 5
    assert obs._spans_dropped == 4


# ------------------------------------------------- histogram math
def _samples():
    rng = np.random.default_rng(7)
    return {
        "lognormal": rng.lognormal(mean=0.0, sigma=1.5, size=4000),
        "uniform": rng.uniform(0.01, 50.0, size=4000),
        "powers": np.array([1.0, 2.0, 4.0, 8.0]),
        "constant": np.full(100, 3.7),
    }


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "powers", "constant"])
def test_histogram_percentiles_vs_exact_quantiles(dist):
    """Log-bucket quantiles land within one sqrt(2) bucket ratio of the
    exact nearest-rank quantile."""
    samples = _samples()[dist]
    h = Histogram()
    for v in samples:
        h.observe(float(v))
    for q in (0.50, 0.95, 0.99):
        exact = float(np.quantile(samples, q, method="inverted_cdf"))
        got = h.quantile(q)
        assert exact / math.sqrt(2) <= got <= exact * math.sqrt(2), (q, exact, got)
    assert h.mean() == pytest.approx(float(np.mean(samples)), rel=1e-9)
    assert Histogram().quantile(0.5) is None


def test_quantile_clamped_to_observed_range():
    h = Histogram()
    h.observe(2.0)
    h.observe(3.0)
    assert 2.0 <= h.quantile(0.01) <= 3.0
    assert 2.0 <= h.quantile(0.999) <= 3.0


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "powers", "constant"])
def test_histogram_equals_jax(dist):
    """The same samples give the same buckets, quantiles, mean and merge
    in both packages."""
    samples = _samples()[dist]
    h, jh = Histogram(), jx_obs.Histogram()
    for v in samples:
        h.observe(float(v))
        jh.observe(float(v))
    assert h.counts == jh.counts and (h.count, h.sum, h.vmin, h.vmax) == (
        jh.count, jh.sum, jh.vmin, jh.vmax)
    for q in (0.01, 0.25, 0.50, 0.90, 0.95, 0.99, 0.999, 1.0):
        assert h.quantile(q) == jh.quantile(q), q
    assert h.mean() == jh.mean()
    other, jother = Histogram(), jx_obs.Histogram()
    for v in samples[: len(samples) // 2] * 3.0:
        other.observe(float(v))
        jother.observe(float(v))
    h.merge(other)
    jh.merge(jother)
    assert h.counts == jh.counts and h.quantile(0.99) == jh.quantile(0.99)


# ------------------------------------------------- registry + exporters
def test_registry_counters_labels_and_totals():
    r = MetricsRegistry()
    r.inc("autosage_decides_total", op="spmm", tier="probe")
    r.inc("autosage_decides_total", op="spmm", tier="cache")
    r.inc("autosage_decides_total", 2, op="sddmm", tier="cache")
    assert r.get("autosage_decides_total", op="spmm", tier="probe") == 1
    assert r.total("autosage_decides_total") == 4
    assert r.total("autosage_decides_total", op="spmm") == 2
    assert r.total("autosage_decides_total", tier="cache") == 3
    assert r.get("autosage_decides_total", op="nope") is None


def test_prometheus_text_format_parses():
    r = MetricsRegistry()
    r.inc("autosage_decides_total", op="spmm", tier="probe")
    r.set_gauge("autosage_probe_budget_ms", 50.0)
    for v in (0.5, 1.0, 2.0, 400.0):
        r.observe("autosage_probe_ms", v, op="spmm")
    text = r.prometheus_text()
    assert 'autosage_decides_total{op="spmm",tier="probe"} 1' in text
    assert "# TYPE autosage_probe_ms histogram" in text
    assert 'autosage_probe_ms_bucket{op="spmm",le="+Inf"} 4' in text
    assert 'autosage_probe_ms_count{op="spmm"} 4' in text
    cum_prev = 0
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name_part, val = line.rsplit(" ", 1)
        float(val)
        if "_bucket{" in name_part and 'le="+Inf"' not in name_part:
            assert int(val) >= cum_prev
            cum_prev = int(val)
    assert text.endswith("\n")


def test_metrics_json_snapshot_schema():
    r = MetricsRegistry()
    r.inc("c", op="spmm")
    r.observe("h", 1.5)
    snap = json.loads(json.dumps(r.to_dict()))
    assert snap["schema"] == obs.OBS_SCHEMA
    assert isinstance(snap["t_mono"], float)
    assert snap["counters"]["c"] == [{"labels": {"op": "spmm"}, "value": 1.0}]
    row = snap["histograms"]["h"][0]
    assert row["count"] == 1 and row["min"] == 1.5 and row["max"] == 1.5
    assert row["p50"] == pytest.approx(1.5)


def _feed(reg):
    """One fixed sequence of writes, label quoting included."""
    rng = np.random.default_rng(11)
    for i in range(40):
        reg.inc("autosage_decides_total", op=("spmm", "sddmm")[i % 2], tier="probe")
    reg.inc("autosage_fallback_total", 3, **{"from": 'ragged "x"\\y', "to": "baseline"})
    reg.set_gauge("autosage_probe_budget_ms", 2500.0)
    reg.set_gauge("autosage_cache_entries", 7, shared="1")
    for v in rng.lognormal(0.0, 2.0, size=300):
        reg.observe("autosage_probe_ms", float(v), op="spmm")
    for v in rng.uniform(0.001, 3.0, size=50):
        reg.observe("autosage_decide_ms", float(v), op="attention", scheduler="batch")


def test_prometheus_text_and_snapshot_equal_jax():
    r, jr = MetricsRegistry(), jx_obs.MetricsRegistry()
    _feed(r)
    _feed(jr)
    assert r.prometheus_text().splitlines() == jr.prometheus_text().splitlines()
    snap, jsnap = r.to_dict(), jr.to_dict()
    for s in (snap, jsnap):
        del s["t_mono"]
    assert snap == jsnap
    assert r.quantile("autosage_probe_ms", 0.99, op="spmm") == jr.quantile(
        "autosage_probe_ms", 0.99, op="spmm")
    assert r.get("autosage_cache_entries", shared=1) == jr.get(
        "autosage_cache_entries", shared=1) == 7.0
    r.reset()
    assert r.prometheus_text() == "\n"


# ------------------------------------------------------------ scorecard
def test_scorecard_math():
    obs.record_estimate("spmm", "row_ell", est_ms=1.0, measured_ms=1.5)
    obs.record_estimate("spmm", "baseline", est_ms=2.0, measured_ms=1.0)
    obs.record_estimate("spmm_bwd_x", "row_ell", est_ms=None, measured_ms=1.0)
    card = obs.scorecard()
    row = card["spmm/probe"]
    assert row["pairs"] == 2
    assert row["mean_abs_err_ms"] == pytest.approx(0.75)
    assert row["mean_rel_err"] == pytest.approx((0.5 / 1.5 + 1.0) / 2)
    assert obs.REGISTRY.get(
        "autosage_est_pairs_total", family="spmm", source="probe",
        candidate_kind="baseline",
    ) == 1


def test_record_probe_estimates_maps_baseline():
    obs.record_probe_estimates(
        "spmm",
        probe_ms={"row_ell": 1.2, "baseline": 2.4},
        estimates_ms={"row_ell": 1.0, "gather_segsum": 2.0},
        baseline_name="gather_segsum",
    )
    assert obs.scorecard()["spmm/probe"]["pairs"] == 2


def test_scorecard_serve_table_and_summary_equal_jax():
    for mod in (obs, jx_obs):
        r = np.random.default_rng(5)
        for op in ("spmm", "spmm_bwd_b", "sddmm", "attention"):
            for _ in range(6):
                mod.record_estimate(op, "row_ell", float(r.uniform(0.1, 5)),
                                    float(r.uniform(0.1, 5)), source="probe")
            mod.record_estimate(op, "baseline", 2.0, float(r.uniform(0.1, 5)),
                                source="observe")
        for i in range(30):
            tier = ("provisional", "warm", "warm")[i % 3]
            mod.record_serve_request(f"b{i % 4}", tier, float(r.lognormal(-2, 1)), op="spmm")
        mod.record_probe_stall("cold")
        mod.REGISTRY.inc("autosage_probe_passes_total", 4, op="spmm")
    assert obs.scorecard() == jx_obs.scorecard()
    assert obs.serve_latency_table() == jx_obs.serve_latency_table()
    assert obs.summary_text() == jx_obs.summary_text()
    assert [r["bucket"] for r in obs.serve_latency_table()][0] in ("b0", "b1")


# ------------------------------------------- one accounting path parity
def test_batch_stats_backed_by_registry(fixed_probe):
    bs = _tiny_bs()
    for seed in range(3):
        bs.decide(fixed_degree(256, 4, seed=seed), 16, "spmm")
    stats = bs.stats()
    assert stats["decides"] == 3
    assert stats["decides"] == obs.REGISTRY.total("autosage_decides_total", scheduler="batch")
    assert stats["probes_run"] == obs.REGISTRY.total("autosage_bucket_probe_passes_total")
    assert stats["warm_cache_opens"] == obs.REGISTRY.total("autosage_bucket_warm_opens_total")


def test_transpose_stats_backed_by_registry():
    assert dict(TRANSPOSE_STATS) == {"built": 0, "hits": 0}
    TRANSPOSE_STATS["built"] += 1
    TRANSPOSE_STATS["hits"] += 2
    assert TRANSPOSE_STATS["built"] == 1 and TRANSPOSE_STATS["hits"] == 2
    assert obs.REGISTRY.get("autosage_transpose_total", event="built") == 1
    assert obs.REGISTRY.get("autosage_transpose_total", event="hits") == 2
    with pytest.raises(KeyError):
        TRANSPOSE_STATS["nope"]
    reset_transpose_stats()
    assert dict(TRANSPOSE_STATS) == {"built": 0, "hits": 0}


def test_scoped_counter_mirrors_registry():
    c = ScopedCounter("autosage_transfers_total")
    c.inc(op="spmm")
    c.inc(2, op="sddmm")
    assert c.value == 3
    assert obs.REGISTRY.total("autosage_transfers_total") == 3
    c2 = ScopedCounter("autosage_transfers_total")
    c2.inc(op="spmm")
    assert c2.value == 1
    assert obs.REGISTRY.total("autosage_transfers_total") == 4


# ----------------------------------------------- telemetry satellites
def test_telemetry_jsonl_records_carry_schema_and_t_mono(monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path))
    d = SimpleNamespace(op="spmm", choice="row_ell", from_cache=False, transfer=None)
    path = telemetry.emit_decide_event(d, torch.device("cpu"), graph_sig="cafe")
    telemetry.close_streams()
    rec = json.loads(Path(path).read_text().splitlines()[0])
    assert rec["schema"] == telemetry.JSONL_SCHEMA
    assert isinstance(rec["t_mono"], float)
    assert rec["graph_sig"] == "cafe" and rec["choice"] == "row_ell"


def test_meta_env_snapshot_taken_at_call_time(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_FAKE_KNOB", "before")
    assert telemetry._meta(torch.device("cpu"))["env"]["AUTOSAGE_FAKE_KNOB"] == "before"
    monkeypatch.setenv("AUTOSAGE_FAKE_KNOB", "after")
    assert telemetry._meta(torch.device("cpu"))["env"]["AUTOSAGE_FAKE_KNOB"] == "after"


# ------------------------------------------------- multi-process appends
_WRITER = r"""
import os, sys
sys.path.insert(0, sys.argv[3])
os.environ["AUTOSAGE_OBS"] = "1"
os.environ["AUTOSAGE_OBS_DIR"] = sys.argv[1]
from repro_torch.core import obs
wid = int(sys.argv[2])
for i in range(75):
    with obs.span("worker", wid=wid, i=i):
        pass
obs.flush()
"""
# one compute thread per writer: the suite runs its files in parallel
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def test_multiprocess_spans_jsonl_has_no_partial_lines(tmp_path):
    env = {**os.environ, **_ONE_THREAD}
    env.pop("AUTOSAGE_REPLAY_ONLY", None)
    procs = [
        subprocess.Popen(["nice", "-n", "10", sys.executable, "-c", _WRITER, str(tmp_path),
                          str(w), SRC], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for w in range(2)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    assert len(lines) == 150
    pids = set()
    for ln in lines:
        rec = json.loads(ln)  # every line parses: no interleaved partials
        assert rec["name"] == "worker"
        pids.add(rec["pid"])
    assert len(pids) == 2
    trace = obs.export_trace(str(tmp_path / "merged.json"), directory=str(tmp_path))
    assert len(trace["traceEvents"]) == 150
    assert {p.name for p in tmp_path.glob("metrics_*.json")} == {
        f"metrics_{pid}.json" for pid in pids}


# ------------------------------------------------------------- obs_cli
def test_obs_cli_explain_summary_export(monkeypatch, tmp_path, capsys, fixed_probe):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path / "t"))
    cache_path = str(tmp_path / "cache.json")
    bs = _tiny_bs(cache_path)
    for seed in range(2):
        bs.decide(fixed_degree(256, 4, seed=seed), 16, "spmm")
        bs.observe(bs.last_bucket, 0.4)
    bs.finalize()
    telemetry.close_streams()
    key = next(k for k in json.load(open(cache_path)) if k.startswith("bucket|"))
    text = obs_cli.explain(key, cache_path=cache_path, telemetry_dir=str(tmp_path / "t"))
    assert "tier: probe" in text
    assert "pinned choice:" in text
    assert "decides served" in text
    assert "EWMA=0.4000ms" in text
    miss = obs_cli.explain("bucket|nope", cache_path=cache_path)
    assert "no entry" in miss

    paths = obs.flush()
    base = str(Path(paths["prom"]).parent)
    assert "autosage_decides_total" in obs_cli.summary(base)
    assert obs_cli.main(["summary", "--obs", base]) == 0
    assert "autosage_decides_total" in capsys.readouterr().out
    assert obs_cli.main(["export-trace", "--obs", base, "--out", str(tmp_path / "tr.json")]) == 0
    trace = json.loads((tmp_path / "tr.json").read_text())
    assert {"decide", "features", "probe"} <= {e["name"] for e in trace["traceEvents"]}


def test_obs_cli_tier_naming():
    from repro_torch.obs_cli import _tier_of

    assert _tier_of({"probed": True, "stats": {"probes": 1}}) == "probe"
    assert _tier_of({"probed": True, "stats": {"probes": 3}}).startswith("drift (re-probed 2x)")
    assert _tier_of({"probed": False, "transfer": {"verdict": "confirmed"}}) == \
        "transfer (confirmed)"
    assert _tier_of({"probed": False}).startswith("provisional")


def test_explain_shows_quarantine_provenance(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "explain-dev")
    path = str(tmp_path / "c.json")
    cache = ScheduleCache(path=path)
    key = ScheduleCache.key("explain-dev", "abc123", 16, "spmm", 0.95)
    cache.put(key, {"choice": "row_ell", "probed": True, "stats": {"probed_at": 5.0}})
    br = resilience.CircuitBreaker(cache=cache, threshold=1, device="cpu")
    br.record_failure("row_ell", site="run", op="spmm")
    cache.flush()
    text = obs_cli.explain(key, cache_path=path)
    assert "quarantine records" in text
    assert "row_ell: active" in text
    assert "ReplayMiss" in text
    qtext = obs_cli.explain(ScheduleCache.quarantine_key("explain-dev", "row_ell"),
                            cache_path=path)
    assert "active" in qtext and "row_ell" in qtext
    assert text == jx_obs_cli.explain(key, cache_path=path)


def _normalize(text, device):
    """A narrative less its device and timestamps."""
    text = text.replace(device, "<device>")
    return re.sub(r"probed_at=[0-9.e+]+", "probed_at=<t>", text)


def test_explain_reads_caches_across_packages(tmp_path, fixed_probe):
    """Each package writes a cache for the same stream; each package's
    explain reads both files, and the narratives agree apart from the
    device and the timestamps."""
    port_path, jax_path = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    bs = _tiny_bs(port_path)
    jbs = JxBatch(JxSage(cache=JxCache(path=jax_path), probe_iters=1, probe_cap_ms=25,
                         probe_frac=0.25), probe_budget_ms=10_000)
    for seed, d in enumerate((4, 4, 16)):
        bs.decide(fixed_degree(256, d, seed=seed), 16, "spmm")
        bs.observe(bs.last_bucket, 0.5 + seed)
        jbs.decide(jx_fixed_degree(256, d, seed=seed), 16, "spmm")
        jbs.observe(jbs.last_bucket, 0.5 + seed)
    bs.finalize()
    jbs.finalize()
    narratives = {}
    for label, path in (("port", port_path), ("jax", jax_path)):
        keys = sorted(json.load(open(path)))
        assert len(keys) >= 4  # bucket and exact-graph entries
        texts = [obs_cli.explain(k, cache_path=path) for k in keys]
        assert texts == [jx_obs_cli.explain(k, cache_path=path) for k in keys]
        device = obs_cli.parse_key(keys[0]).device
        narratives[label] = sorted(_normalize(t, device) for t in texts)
    assert narratives["port"] == narratives["jax"]
    assert any("tier: probe" in t for t in narratives["port"])
