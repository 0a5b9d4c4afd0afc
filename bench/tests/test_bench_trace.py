"""Idle share, busy time, gap labels and roofline shares on a synthetic
profiler trace."""
import json

import pytest

from bench import harness, roofline, trace
from bench.work import gnn as work


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load_chrome_trace(path)


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


@pytest.fixture
def synthetic(tmp_path):
    events = [
        _ev("bench.window", "user_annotation", 100, 1000),
        _ev("model.norm_csr", "user_annotation", 100, 200),
        _ev("aten::mm", "cpu_op", 300, 10),
        _ev("sm80_gemm", "kernel", 305, 95),  # 305-400
        _ev("spmm_rows_kernel<16, 8, true>", "kernel", 390, 110),  # overlaps: 390-500
        _ev("scheduler.decide", "user_annotation", 500, 300, tid=2),  # autograd thread
        _ev("features.extract", "user_annotation", 550, 100, tid=2),
        _ev("spmm_merge_kernel", "kernel", 800, 100),  # 800-900
        _ev("memcpy", "gpu_memcpy", 50, 100),  # clipped to 100-150
        _ev("cudaLaunchKernel", "cuda_runtime", 300, 5),
    ]
    return _chrome(tmp_path, events)


def test_busy_idle_and_gaps(synthetic):
    t = synthetic
    assert (t.t0, t.t1) == (100.0, 1100.0)
    assert t.window_s == pytest.approx(1e-3)
    # union: 100-150, 305-500, 800-900 = 50 + 195 + 100 us
    assert trace.busy_s(t) == pytest.approx(345e-6)
    assert trace.idle_gaps(t) == [(150.0, 305.0), (500.0, 800.0), (900.0, 1100.0)]
    reader = harness.load_by_path(harness.BENCH / "metrics" / "idle_share.train.py")
    r = harness.Reading(None, harness.Window(trace=t), {}, None)
    assert reader.read(r) == pytest.approx(100 * (1 - 345 / 1000))


def test_gap_labels_take_the_innermost_operation_of_any_thread(synthetic):
    b = trace.breakdown(synthetic)
    idle = dict((k, v) for k, v in b["idle_gaps"])
    # 150-305 (mid 227.5): norm_csr; 500-800 (mid 650): decide on thread 2,
    # features.extract ends at 650 and still counts; 900-1100 (mid 1000): none
    assert idle["model.norm_csr"] == pytest.approx(155e-6)
    assert idle["features.extract"] == pytest.approx(300e-6)
    assert idle["host"] == pytest.approx(200e-6)
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops["spmm_rows_kernel<16, 8, true>"] == pytest.approx(110e-6)
    assert ops["memcpy"] == pytest.approx(50e-6)  # clipped to the window


def test_roofline_share_counts_hand_calls_only(synthetic):
    spans = [
        {"name": "decide", "t_mono": 1.0, "tid": 7, "args": {"op": "spmm", "f": 256}},
        {"name": "run", "t_mono": 1.1, "tid": 7,
         "args": {"op": "spmm", "choice": "ragged_ell_cuda[bc=8,ragged=True,rb=16]"}},
        {"name": "decide", "t_mono": 1.2, "tid": 7, "args": {"op": "spmm", "f": 41}},
        {"name": "run", "t_mono": 1.3, "tid": 7, "args": {"op": "spmm", "choice": "baseline"}},
        {"name": "decide", "t_mono": 1.4, "tid": 8, "args": {"op": "spmm_bwd_b", "f": 41}},
        {"name": "run", "t_mono": 1.5, "tid": 8,
         "args": {"op": "spmm_bwd_b", "choice": "merge_path_cuda[rb=8]"}},
    ]
    assert roofline.scheduled_calls(spans) == [
        ("spmm", 256, "ragged_ell_cuda[bc=8,ragged=True,rb=16]"), ("spmm", 41, "baseline"),
        ("spmm_bwd_b", 41, "merge_path_cuda[rb=8]")]
    n, nnz = 1000, 20000
    peaks = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    w = harness.Window(trace=synthetic, spans=spans)
    r = harness.Reading(None, w, {"call": lambda op, f: work.call_work(op, f, n, n, nnz)}, peaks)
    want = sum(work.roofline_s(*work.call_work(op, f, n, n, nnz), 67e12, 3.35e12)
               for op, f in (("spmm", 256), ("spmm_bwd_b", 41)))
    # the spmm kernels' device time: 110 + 100 us
    assert roofline.share(r, ("spmm", "spmm_bwd_b"), ("spmm",)) == pytest.approx(
        100 * want / 210e-6)
    assert roofline.share(r, ("attention",), ("attention",)) is None
    assert roofline.share(harness.Reading(None, w, r.work, None), ("spmm",), ("spmm",)) is None


def test_window_histogram_delta():
    h_before = {"autosage_decide_ms": {(("op", "spmm"), ("scheduler", "exact")): (1, 0.5)}}
    h_after = {"autosage_decide_ms": {(("op", "spmm"), ("scheduler", "exact")): (4, 7.5),
                                      (("op", "spmm"), ("scheduler", "batch")): (3, 7.0)}}
    w = harness.Window(steps=2, hists_before=h_before, hists_after=h_after)
    d = w.hist_delta("autosage_decide_ms", scheduler="exact")
    assert (d.count, d.sum) == (3, 7.0)
    assert w.hist_delta("autosage_decide_ms").count == 6
    assert w.hist_delta("autosage_decide_ms", scheduler="serve").count == 0
    reader = harness.load_by_path(harness.BENCH / "metrics" / "decide_ms.train.py")
    assert reader.read(harness.Reading(None, w, {}, None)) == pytest.approx(3.5)


def test_histogram_snapshot_reads_the_ports_registry():
    from repro_torch.core import obs

    before = harness._hist_snapshot()
    obs.REGISTRY.observe("autosage_decide_ms", 2.5, op="bench_test", scheduler="exact")
    w = harness.Window(hists_before=before, hists_after=harness._hist_snapshot())
    d = w.hist_delta("autosage_decide_ms", op="bench_test")
    assert (d.count, d.sum) == (1, 2.5)
