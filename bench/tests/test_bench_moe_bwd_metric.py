"""The reader of moe_bwd_ms.lm on synthetic windows: it reads the MoE
backward's span per step, counts only the window's delta, and gives None
where the span is missing, as on a program without it."""
import pytest

from bench import harness


def _reader():
    return harness.load_by_path(harness.BENCH / "metrics" / "moe_bwd_ms.lm.py")


def _lk(**labels):
    return tuple(sorted(labels.items()))


BEFORE = {"autosage_device_ms": {_lk(span="lm.moe"): (4, 40.0)}}
AFTER = {"autosage_device_ms": {
    _lk(span="lm.moe"): (12, 140.0),
    _lk(span="lm.moe_bwd"): (6, 70.0),
    _lk(span="lm.swa_attention"): (6, 500.0),
}}


def _reading(steps=2, before=BEFORE, after=AFTER):
    w = harness.Window(steps=steps, hists_before=before, hists_after=after)
    return harness.Reading(None, w, {}, None)


@pytest.mark.parametrize("before_bwd, want", [(None, 70.0 / 2), ((2, 20.0), 50.0 / 2)])
def test_moe_bwd_ms_reads_the_window_delta_of_its_span(before_bwd, want):
    before = BEFORE
    if before_bwd is not None:   # a window that began after the first backward
        before = {"autosage_device_ms": {**BEFORE["autosage_device_ms"],
                                         _lk(span="lm.moe_bwd"): before_bwd}}
    assert _reader().read(_reading(before=before)) == pytest.approx(want)


@pytest.mark.parametrize("before, after, steps", [
    ({}, {}, 2),
    ({}, {"autosage_decide_ms": {_lk(op="attention", scheduler="exact"): (3, 9.0)}}, 2),
    (BEFORE, {"autosage_device_ms": {_lk(span="lm.moe"): (12, 140.0)}}, 2),
    (BEFORE, AFTER, 0),
], ids=["empty", "other_histogram", "forward_span_only", "no_steps"])
def test_moe_bwd_ms_is_none_without_its_span(before, after, steps):
    assert _reader().read(_reading(steps=steps, before=before, after=after)) is None
