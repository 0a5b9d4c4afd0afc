"""repro_torch's spans on the profiler's timeline and on the device's
clock (core/obs.py): each recorded span is a ``record_function`` range,
and a span given a CUDA device folds its stream time into
``autosage_device_ms`` once its events have completed. On the CPU a
profiler records the ranges and stub events stand in for CUDA's; the
last test reads a real card and skips without one.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.core import AutoSage, ScheduleCache, obs
from repro_torch.core import probe as probe_mod
from repro_torch.models.gnn import norm_csr
from repro_torch.sparse import csr as csr_mod
from repro_torch.sparse import erdos_renyi, fixed_degree
from repro_torch.sparse.csr import reset_transpose_stats

torch.set_num_threads(1)  # see test_torch_spmm.py

CUDA = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch, tmp_path):
    """A fresh recorder, an obs dir per test, and obs off unless the test
    opts in."""
    monkeypatch.delenv("AUTOSAGE_OBS", raising=False)
    monkeypatch.delenv("AUTOSAGE_REPLAY_ONLY", raising=False)
    monkeypatch.delenv("AUTOSAGE_TELEMETRY_DIR", raising=False)
    monkeypatch.setenv("AUTOSAGE_OBS_DIR", str(tmp_path / "obs"))
    obs.reset()
    reset_transpose_stats()
    yield
    obs.reset()
    reset_transpose_stats()


def _annotations(prof, tmp_path):
    """The ``user_annotation`` events of a finished profile's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _device_series():
    return obs.REGISTRY.hist_series(obs.DEVICE_MS)


class StubEvent:
    """A CUDA event stand-in: completes when the test says so, and
    refuses to be read before."""

    def __init__(self, t_ms):
        self.t_ms, self.done = t_ms, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on an unfinished event"
        return end.t_ms - self.t_ms


@pytest.fixture
def stub_events(monkeypatch):
    """`obs._record_event` replaced by stub events on a clock that moves
    1 ms per event; returns the list of events made."""
    made = []

    def record(device):
        made.append(StubEvent(float(len(made))))
        return made[-1]

    monkeypatch.setattr(obs, "_record_event", record)
    return made


# ------------------------------------------------------------ ranges
def test_nested_spans_are_nested_ranges_in_the_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("decide", op="spmm", f=16):
            with obs.span("features", op="spmm"):
                torch.ones(4).sum()
    got = {e["name"]: e for e in _annotations(prof, tmp_path)}
    assert {"decide.spmm", "features.spmm"} <= set(got)
    outer, inner = got["decide.spmm"], got["features.spmm"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the spans themselves keep their names and schema
    assert obs.span_names() == ["decide", "features"]


@pytest.mark.parametrize("name, args, want", [
    ("decide", {"op": "attention_bwd_q", "f": 256}, "decide.attention_bwd_q"),
    ("features", {"op": "attention"}, "features.attention"),
    ("run", {"op": "attention_bwd_v", "choice": "ragged_ell_cuda[rb=8]"}, "run.attention_bwd_v"),
    ("prepare", {"op": "attention", "choice": "baseline"}, "prepare.attention"),
    ("fwd.attention", {"op": "attention"}, "fwd.attention"),
    ("bwd.attention_bwd_k", {"op": "attention_bwd_k"}, "bwd.attention_bwd_k"),
    ("csr.transpose", {}, "csr.transpose"),
    ("probe", {"n_candidates": 3}, "probe"),
])
def test_range_name_appends_the_op_unless_the_name_ends_in_it(name, args, want):
    assert obs._range_name(name, args) == want


# -------------------------------------------------------------- gating
@pytest.mark.parametrize("env", [{}, {"AUTOSAGE_OBS": "0"},
                                 {"AUTOSAGE_OBS": "1", "AUTOSAGE_REPLAY_ONLY": "1"}],
                         ids=["unset", "zero", "replay_only"])
def test_off_records_no_range_span_event_series_or_file(monkeypatch, tmp_path, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)

    def refuse(device):
        raise AssertionError("an event was recorded with obs off")

    monkeypatch.setattr(obs, "_record_event", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("decide", op="spmm"):
            with obs.span("run", CUDA, op="spmm", choice="row_ell"):
                torch.ones(4).sum()
    assert _annotations(prof, tmp_path) == []
    assert obs.span_names() == []
    assert _device_series() == {}
    assert obs.REGISTRY.to_dict()["histograms"].get(obs.DEVICE_MS) is None
    assert obs.flush() == {}
    assert not (tmp_path / "obs").exists()


# ------------------------------------------------------ device folding
def test_fold_takes_only_completed_pairs(monkeypatch, stub_events):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    for op in ("spmm", "sddmm", "attention"):
        with obs.span("run", CUDA, op=op, choice="c"):
            pass
    assert len(stub_events) == 6 and len(obs._pending) == 3
    assert _device_series() == {}  # nothing completed yet
    # the second pair completes first: a registry read folds it alone
    stub_events[2].done = stub_events[3].done = True
    series = _device_series()
    assert [dict(lk)["op"] for lk in series] == ["sddmm"]
    assert len(obs._pending) == 2
    # a new record folds the completed head only: the first pair, not the
    # third, whose start alone has completed
    stub_events[0].done = stub_events[1].done = stub_events[4].done = True
    with obs.span("run", CUDA, op="spmm", choice="c"):
        pass
    assert [p[2]["op"] for p in obs._pending] == ["attention", "spmm"]
    h = obs.REGISTRY.hist(obs.DEVICE_MS, span="run", op="spmm", choice="c")
    assert (h.count, h.sum) == (1, 1.0)
    # after the device has finished, one read folds the rest
    for ev in stub_events:
        ev.done = True
    snap = obs.REGISTRY.to_dict()["histograms"][obs.DEVICE_MS]
    assert sum(row["count"] for row in snap) == 4
    assert not obs._pending


def test_pending_pairs_stay_bounded_by_what_is_in_flight(monkeypatch, stub_events):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    for i in range(200):
        with obs.span("softmax.vjp", CUDA, op="attention"):
            pass
        if i >= 2:  # the device runs two calls behind the host
            stub_events[2 * (i - 2)].done = stub_events[2 * (i - 2) + 1].done = True
        assert len(obs._pending) <= 3
    h = obs.REGISTRY.hist(obs.DEVICE_MS, span="softmax.vjp", op="attention")
    assert h.count == 198 and h.sum == pytest.approx(198.0)


def test_a_span_that_raises_records_no_device_time(monkeypatch, stub_events):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with pytest.raises(ValueError):
        with obs.span("run", CUDA, op="spmm", choice="c"):
            raise ValueError("kernel fault")
    assert not obs._pending
    assert obs.span_names() == ["run"]


def test_cpu_spans_take_no_events(monkeypatch, stub_events):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    with obs.span("run", torch.device("cpu"), op="spmm", choice="c"):
        pass
    assert stub_events == [] and _device_series() == {}


# ------------------------------------------------ spans where work had none
def test_transpose_build_records_one_span_and_one_observation(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setattr(csr_mod, "_TRANSPOSE_BY_SIG", {})
    g = fixed_degree(64, 4, seed=11)
    g.transpose_with_perm()
    assert obs.span_names() == ["csr.transpose"]
    h = obs.REGISTRY.hist("autosage_transpose_ms")
    assert h.count == 1 and h.sum > 0
    g.transpose_with_perm()  # the object's memo
    fixed_degree(64, 4, seed=11).transpose_with_perm()  # the signature cache
    assert len(obs._spans) == 1
    assert obs.REGISTRY.hist("autosage_transpose_ms").count == 1


def test_norm_csr_records_its_span(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    norm_csr(fixed_degree(32, 3, seed=1))
    assert obs.span_names() == ["model.norm_csr"]


def test_attention_backward_records_the_softmax_spans(monkeypatch, tmp_path):
    def fixed(fn, device, iters=1, cap_ms=0.0, name="?"):
        return probe_mod.ProbeResult(name, 1.0, [1.0], 1, False)

    monkeypatch.setattr(probe_mod, "time_callable", fixed)
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    g = erdos_renyi(96, 5e-2, seed=4).dedup_edges()
    sage = AutoSage(cache=ScheduleCache(path=None), device="cpu", probe_iters=1,
                    probe_cap_ms=25, probe_frac=0.25)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((g.n_rows, 8)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.attention(g, q, k, v, sage=sage).sum().backward()
    names = obs.span_names()
    assert {"softmax.recompute", "softmax.vjp", "bwd.attention_bwd_e", "run"} <= set(names)
    recs = [obs._render(r) for r in obs._spans if r[0].startswith("softmax.")]
    assert all(r["args"] == {"op": "attention"} for r in recs)
    ranges = {e["name"] for e in _annotations(prof, tmp_path)}
    assert {"softmax.recompute.attention", "softmax.vjp.attention",
            "run.attention_bwd_q", "decide.attention_bwd_k"} <= ranges
    assert _device_series() == {}  # no events on the CPU


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_scheduled_spmm_reads_positive_device_time(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    g = norm_csr(fixed_degree(4096, 8, seed=2))
    sage = AutoSage(cache=ScheduleCache(path=str(tmp_path / "c.json")), device=CUDA,
                    probe_iters=1, probe_cap_ms=50)
    b = torch.randn(g.n_cols, 64, device=CUDA)
    for _ in range(2):
        api.spmm(g, b, sage=sage)
    torch.cuda.synchronize(CUDA)
    series = {lk: h for lk, h in _device_series().items() if dict(lk)["span"] == "run"}
    assert series, "no run span took device time"
    assert all(dict(lk)["op"] == "spmm" for lk in series)
    assert sum(h.count for h in series.values()) >= 2
    assert all(h.sum > 0 for h in series.values())
    assert not obs._pending
