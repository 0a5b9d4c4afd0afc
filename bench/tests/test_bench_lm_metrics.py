"""The readers of the LM cell's per-layer metrics on synthetic windows:
each reads what it is meant to and gives None where its input is
missing, as on a program without the spans (the parent of the PR that
added them)."""
import json

import pytest

from bench import harness, trace


def _reader(name):
    return harness.load_by_path(harness.BENCH / "metrics" / f"{name}.py")


def _lk(**labels):
    return tuple(sorted(labels.items()))


BEFORE = {"autosage_device_ms": {
    _lk(span="run", op="attention", choice="ragged_attention_cuda"): (10, 100.0),
    _lk(span="lm.moe"): (4, 40.0),
}}
AFTER = {"autosage_device_ms": {
    _lk(span="run", op="attention", choice="ragged_attention_cuda"): (14, 160.0),
    _lk(span="run", op="attention_bwd_e", choice="row_ell_cuda"): (2, 12.0),
    _lk(span="run", op="attention_bwd_p", choice="row_ell_cuda"): (2, 18.0),
    _lk(span="run", op="attention_bwd_q", choice="ragged_cuda"): (2, 20.0),
    _lk(span="run", op="attention_bwd_k", choice="ragged_cuda"): (2, 22.0),
    _lk(span="run", op="attention_bwd_v", choice="ragged_cuda"): (2, 24.0),
    _lk(span="softmax.recompute", op="attention"): (2, 4.0),
    _lk(span="softmax.vjp", op="attention"): (2, 6.0),
    _lk(span="lm.moe"): (12, 140.0),
    _lk(span="lm.swa_attention"): (6, 500.0),
    _lk(span="run", op="spmm", choice="x"): (5, 99.0),
}}


def _reading(steps=2, before=BEFORE, after=AFTER):
    w = harness.Window(steps=steps, hists_before=before, hists_after=after)
    return harness.Reading(None, w, {}, None)


def test_swa_attention_ms_sums_the_window_ops_and_the_softmax_spans():
    got = _reader("swa_attention_ms.lm").read(_reading())
    assert got == pytest.approx((60.0 + 12 + 18 + 20 + 22 + 24 + 4 + 6) / 2)


def test_moe_fwd_ms_reads_the_moe_spans():
    assert _reader("moe_fwd_ms.lm").read(_reading()) == pytest.approx(100.0 / 2)


@pytest.mark.parametrize("name", ["swa_attention_ms.lm", "moe_fwd_ms.lm"])
def test_span_readers_are_none_without_their_spans(name):
    other = {"autosage_decide_ms": {_lk(op="attention", scheduler="exact"): (3, 9.0)}}
    for r in (_reading(before={}, after={}), _reading(before={}, after=other),
              _reading(steps=0)):
        assert _reader(name).read(r) is None


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load_chrome_trace(path)


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_idle_share_and_mfu(tmp_path):
    t = _chrome(tmp_path, [_ev("bench.window", "user_annotation", 0, 1000),
                           _ev("sm90_gemm", "kernel", 0, 600), _ev("k", "kernel", 800, 100)])
    w = harness.Window(steps=4, trace=t, t_start=0.0, t_end=2.0)
    peaks = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    r = harness.Reading(None, w, {"step_flops": 1e11, "flops_peak": "fp32_flops"}, peaks)
    assert _reader("idle_share.lm").read(r) == pytest.approx(30.0)
    assert _reader("train_mfu.lm").read(r) == pytest.approx(100.0 * 1e11 / (0.5 * 1e12))
    none = harness.Reading(None, harness.Window(steps=4), {}, None)
    assert _reader("idle_share.lm").read(none) is None
    assert _reader("train_mfu.lm").read(none) is None


def test_swa_roofline_counts_hand_kernel_calls_over_their_kernels(tmp_path):
    t = _chrome(tmp_path, [_ev("bench.window", "user_annotation", 0, 10_000),
                           _ev("attention_chunks_kernel<8>", "kernel", 0, 1000),
                           _ev("spmm_rows_kernel<16,8>", "kernel", 2000, 3000),
                           _ev("sm90_gemm", "kernel", 6000, 3000)])
    spans = [{"name": "decide", "tid": 1, "args": {"op": "attention", "f": 128}},
             {"name": "run", "tid": 1, "args": {"op": "attention",
                                                "choice": "ragged_attention_cuda[bc=8]"}},
             {"name": "decide", "tid": 2, "args": {"op": "attention_bwd_q", "f": 128}},
             {"name": "run", "tid": 2, "args": {"op": "attention_bwd_q",
                                                "choice": "ragged_cuda[rb=16]"}},
             {"name": "run", "tid": 2, "args": {"op": "attention_bwd_q", "choice": "baseline"}}]
    w = harness.Window(steps=1, trace=t, spans=spans)
    work = {"call": lambda op, f: (1e9, 0.0)}
    peaks = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    got = _reader("swa_attention_roofline.lm").read(harness.Reading(None, w, work, peaks))
    # two hand calls of 1 ms each at the bound over 4 ms of the families' kernels
    assert got == pytest.approx(100.0 * 2e-3 / 4e-3)
    assert _reader("swa_attention_roofline.lm").read(
        harness.Reading(None, harness.Window(steps=1, trace=t, spans=[]), work, peaks)) is None
