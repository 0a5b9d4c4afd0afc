"""The readers of the per-layer metrics that read the port's own ranges
and device-time histogram, on a synthetic trace and synthetic histogram
snapshots; each gives None where its input is missing, as on a program
that records neither."""
import json

import pytest

from bench import harness, trace


def _reader(name):
    return harness.load_by_path(harness.BENCH / "metrics" / f"{name}.py")


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load_chrome_trace(path)


@pytest.fixture
def synthetic(tmp_path):
    events = [
        _ev("bench.window", "user_annotation", 100, 1000),
        _ev("sm80_gemm", "kernel", 100, 100),  # 100-200
        # gap 200-400: decide.attention covers 300-500, so half of it
        _ev("decide.attention", "user_annotation", 300, 200),
        _ev("features.attention", "user_annotation", 320, 100),
        _ev("attention_chunks_kernel", "kernel", 400, 200),  # 400-600
        # gap 600-800: two decides on two threads, overlapping: 650-750
        _ev("decide.attention_bwd_q", "user_annotation", 650, 60, tid=2),
        _ev("decide.attention_bwd_k", "user_annotation", 700, 50, tid=3),
        _ev("spmm_rows_kernel", "kernel", 800, 200),  # 800-1000
        # gap 1000-1100: no decide; a decide while the card is busy counts nothing
        _ev("decide.attention_bwd_v", "user_annotation", 850, 100),
        _ev("scheduler.decide", "user_annotation", 1020, 50),
    ]
    return _chrome(tmp_path, events)


def test_decide_idle_counts_the_part_of_each_gap_under_a_decide(synthetic):
    assert trace.idle_gaps(synthetic) == [(200.0, 400.0), (600.0, 800.0), (1000.0, 1100.0)]
    w = harness.Window(steps=2, trace=synthetic)
    got = _reader("decide_idle_ms.train").read(harness.Reading(None, w, {}, None))
    # 100 us of the first gap (half of it) and 100 us of the second, over 2 steps
    assert got == pytest.approx(200e-3 / 2)


def test_decide_idle_is_none_without_decide_ranges_or_trace(tmp_path):
    t = _chrome(tmp_path, [_ev("bench.window", "user_annotation", 0, 100),
                           _ev("scheduler.decide", "user_annotation", 10, 50),
                           _ev("k", "kernel", 70, 10)])
    reader = _reader("decide_idle_ms.train")
    assert reader.read(harness.Reading(None, harness.Window(steps=1, trace=t), {}, None)) is None
    assert reader.read(harness.Reading(None, harness.Window(steps=1), {}, None)) is None


def _lk(**labels):
    return tuple(sorted(labels.items()))


DEVICE_BEFORE = {"autosage_device_ms": {
    _lk(span="run", op="attention", choice="a"): (1, 10.0),
}}
DEVICE_AFTER = {"autosage_device_ms": {
    _lk(span="run", op="attention", choice="a"): (3, 40.0),
    _lk(span="run", op="attention", choice="b"): (1, 6.0),
    _lk(span="run", op="attention_bwd_e", choice="c"): (2, 12.0),
    _lk(span="run", op="attention_bwd_p", choice="c"): (2, 18.0),
    _lk(span="run", op="attention_bwd_q", choice="d"): (2, 20.0),
    _lk(span="run", op="attention_bwd_k", choice="d"): (2, 22.0),
    _lk(span="run", op="attention_bwd_v", choice="d"): (2, 24.0),
    _lk(span="softmax.recompute", op="attention"): (2, 4.0),
    _lk(span="softmax.vjp", op="attention"): (2, 6.0),
    _lk(span="run", op="spmm", choice="d"): (5, 99.0),
}}


@pytest.mark.parametrize("name, want", [
    ("attention_fwd_ms.train", (30.0 + 6.0) / 2),
    ("attention_bwd_sddmm_ms.train", (12.0 + 18.0) / 2),
    ("attention_bwd_spmm_ms.train", (20.0 + 22.0 + 24.0) / 2),
    ("softmax_bwd_ms.train", (4.0 + 6.0) / 2),
])
def test_device_ms_readers_take_the_window_delta_per_step(name, want):
    w = harness.Window(steps=2, hists_before=DEVICE_BEFORE, hists_after=DEVICE_AFTER)
    assert _reader(name).read(harness.Reading(None, w, {}, None)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["attention_fwd_ms.train", "attention_bwd_sddmm_ms.train",
                                  "attention_bwd_spmm_ms.train", "softmax_bwd_ms.train"])
def test_device_ms_readers_are_none_without_the_histogram(name):
    other = {"autosage_decide_ms": {_lk(op="attention", scheduler="exact"): (3, 9.0)}}
    for w in (harness.Window(steps=2), harness.Window(steps=2, hists_after=other),
              harness.Window(steps=0, hists_before=DEVICE_BEFORE, hists_after=DEVICE_AFTER)):
        assert _reader(name).read(harness.Reading(None, w, {}, None)) is None


def test_setup_layouts_sums_transposes_and_prepares_before_the_window():
    before = {
        "autosage_transpose_ms": {(): (2, 1500.0)},
        "autosage_prepare_ms": {_lk(op="attention", variant="x"): (3, 2500.0),
                                _lk(op="spmm", variant="y"): (1, 1000.0)},
        "autosage_decide_ms": {_lk(op="attention", scheduler="exact"): (3, 9000.0)},
    }
    after = {"autosage_transpose_ms": {(): (5, 99999.0)}}  # the window's are not set-up
    w = harness.Window(steps=2, hists_before=before, hists_after=after)
    assert _reader("setup_layouts_s.train").read(
        harness.Reading(None, w, {}, None)) == pytest.approx(5.0)


def test_setup_layouts_is_none_without_the_transpose_histogram():
    before = {"autosage_prepare_ms": {_lk(op="attention", variant="x"): (3, 2500.0)}}
    reader = _reader("setup_layouts_s.train")
    for w in (harness.Window(hists_before=before), harness.Window()):
        assert reader.read(harness.Reading(None, w, {}, None)) is None


def test_readers_read_the_ports_registry_through_the_snapshot(monkeypatch, tmp_path):
    """End to end on the CPU: a span given a (stub) CUDA device folds into
    autosage_device_ms, which the harness's snapshot reads."""
    import torch

    from repro_torch.core import obs

    class Done:
        def __init__(self, t):
            self.t = t

        def query(self):
            return True

        def elapsed_time(self, end):
            return end.t - self.t

    clock = iter(range(0, 100, 2))
    monkeypatch.setattr(obs, "_record_event", lambda device: Done(next(clock)))
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setenv("AUTOSAGE_OBS_DIR", str(tmp_path / "obs"))
    obs.reset()
    try:
        before = harness._hist_snapshot()
        for op in ("attention_bwd_q", "attention_bwd_k"):
            with obs.span("run", torch.device("cuda", 0), op=op, choice="bench_test"):
                pass
        w = harness.Window(steps=1, hists_before=before, hists_after=harness._hist_snapshot())
    finally:
        obs.reset()
    assert _reader("attention_bwd_spmm_ms.train").read(
        harness.Reading(None, w, {}, None)) == pytest.approx(4.0)
