"""repro_torch's resilience layer on the CPU: the twin of
tests/test_resilience.py (all but the obs_cli explain test, whose CLI is
not ported yet) and the torch exception taxonomy.

The chaos matrix: under every injected fault class every scheduler
surface ({AutoSage, BatchScheduler, shared-fleet BatchScheduler} x
{spmm, sddmm, attention}) still returns a runnable decision whose output
matches the port's kernels/ref.py oracle — bit for bit when every
injectable stage is dead (the reference stage serves), else within
rtol 5e-3, atol 5e-3 as in the JAX file. Then the circuit breaker's
lifecycle, the replay contract, the batch fault-retire path, the fault
telemetry and a kill -9 mid-probe against the shared cache.

Against the JAX package: the same AUTOSAGE_FAULT spec on the same seeded
graph, with the same pinned choice and the same device signature, gives
the same fault and fallback events, the same counter deltas and the same
quarantine records, and an output equal to the JAX package's within
rtol 1e-5, atol 1e-5 (the two sum in another order) and to the port's own
oracle bit for bit on the terminal stage. Every scheduler here has a
fixed probe timer or a pinned choice where a verdict could depend on
wall-clock probes, and every subprocess a timeout of its own.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import AutoSage as JxSage
from repro.core import ScheduleCache as JxCache
from repro.core import faultinject as jx_faultinject
from repro.core import obs as jx_obs
from repro.core import telemetry as jx_telemetry
from repro.sparse import hub_skew as jx_hub_skew
from repro_torch.core import AutoSage, BatchScheduler, InputFeatures, ScheduleCache
from repro_torch.core import faultinject, obs, resilience, telemetry
from repro_torch.core.cache import CacheLockTimeout, ReplayMiss
from repro_torch.kernels import ref
from repro_torch.sparse import hub_skew

torch.set_num_threads(1)  # see test_torch_spmm.py

REPO = Path(__file__).resolve().parent.parent
OPS = ("spmm", "sddmm", "attention")
SCHEDULERS = ("autosage", "batch", "batch-shared")

# fault-class name -> env to set; "exact" marks classes whose outputs
# must be bit-identical to the oracle (all non-reference stages dead)
FAULTS = {
    "prepare-fault": {"env": {"AUTOSAGE_FAULT": "prepare::oom:"}, "exact": True},
    "run-fault": {"env": {"AUTOSAGE_FAULT": "run::raise:"}, "exact": True},
    "probe-timeout": {
        "env": {
            "AUTOSAGE_FAULT": "probe::hang:",
            "AUTOSAGE_FAULT_HANG_S": "0.5",
            "AUTOSAGE_PROBE_TIMEOUT_S": "0.1",
        },
        "exact": False,
    },
    "lock-fault": {"env": {"AUTOSAGE_FAULT": "lock::raise:"}, "exact": False},
}


@pytest.fixture(autouse=True)
def _clean_injection():
    """Every test starts and ends with no compiled fault spec."""
    faultinject.reset()
    jx_faultinject.reset()
    yield
    faultinject.reset()
    jx_faultinject.reset()


def _graph(seed=0):
    return hub_skew(600, 4, 0.05, 24, seed=seed).dedup_edges()


def _sage(path=None, shared=False, **kw):
    return AutoSage(cache=ScheduleCache(path=path, shared=shared, **kw), device="cpu",
                    probe_iters=1, probe_cap_ms=25, probe_frac=0.25)


def _make_scheduler(kind, tmp_path):
    if kind == "autosage":
        return _sage()
    if kind == "batch":
        return BatchScheduler(_sage(), probe_budget_ms=10_000)
    if kind == "batch-shared":
        return BatchScheduler(_sage(str(tmp_path / "shared.json"), shared=True),
                              probe_budget_ms=10_000)
    raise KeyError(kind)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_op(sched, csr, op, f, rng):
    rowptr, colind = _t(csr.rowptr), _t(csr.colind)

    def rand(n):
        return _t(rng.standard_normal((n, f)).astype(np.float32))

    if op == "spmm":
        b = rand(csr.n_cols)
        out, d = sched.spmm(csr, b) if isinstance(sched, BatchScheduler) else _spmm(sched, csr, b)
        oracle = ref.spmm_ref(rowptr, colind, None, b)
    elif op == "sddmm":
        x, y = rand(csr.n_rows), rand(csr.n_cols)
        if isinstance(sched, BatchScheduler):
            out, d = sched.sddmm(csr, x, y)
        else:
            d = sched.decide(csr, f, "sddmm")
            out = sched.build_runner(csr, d)(x, y)
        oracle = ref.sddmm_ref(rowptr, colind, x, y)
    elif op == "attention":
        q, k, v = rand(csr.n_rows), rand(csr.n_cols), rand(csr.n_cols)
        out, d = sched.attention(csr, q, k, v)
        oracle = ref.csr_attention_ref(rowptr, colind, q, k, v)
    else:
        raise KeyError(op)
    return out, d, oracle


def _spmm(sage, csr, b):
    d = sage.decide(csr, int(b.shape[1]), "spmm")
    return sage.build_runner(csr, d)(b), d


# ------------------------------------------------- the chaos matrix
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", SCHEDULERS)
def test_chaos_decide_still_runnable_and_correct(kind, op, fault, tmp_path, monkeypatch):
    spec = FAULTS[fault]
    for k, v in spec["env"].items():
        monkeypatch.setenv(k, v)
    faultinject.reset()
    sched = _make_scheduler(kind, tmp_path)
    out, d, oracle = _run_op(sched, _graph(), op, 16, np.random.default_rng(0))
    assert d is not None and d.choice
    assert torch.isfinite(out).all()
    if spec["exact"]:
        assert torch.equal(out, oracle), f"{kind}/{op}/{fault} chose {d.choice}"
    else:
        np.testing.assert_allclose(out.numpy(), oracle.numpy(), rtol=5e-3, atol=5e-3,
                                   err_msg=f"{kind}/{op}/{fault} chose {d.choice}")
    # a faulting candidate is never pinned for replay
    sage = sched.sage if isinstance(sched, BatchScheduler) else sched
    for key, entry in sage.cache._data.items():
        if isinstance(entry, dict) and "quarantine" not in entry:
            choice = entry.get("choice")
            if isinstance(choice, str):
                assert not sage.breaker.is_quarantined(choice), (
                    f"{fault}: quarantined {choice!r} pinned at {key}")
    if fault == "lock-fault" and kind == "batch-shared":
        sched.finalize()  # the guarded flush swallows the lock fault
        path = tmp_path / "shared.json"
        assert not list(tmp_path.glob("*.lock")), "leaked lockfile"
        if path.exists():
            assert isinstance(json.load(open(path)), dict)


def test_chaos_injection_actually_fired(tmp_path, monkeypatch):
    """Each fault spec really triggers at its site on the spmm path."""
    for fault, spec in FAULTS.items():
        if fault == "lock-fault":
            continue  # fires on a shared flush only, checked below
        for k, v in spec["env"].items():
            monkeypatch.setenv(k, v)
        faultinject.reset()
        _run_op(_make_scheduler("autosage", tmp_path), _graph(), "spmm", 16,
                np.random.default_rng(0))
        site = spec["env"]["AUTOSAGE_FAULT"].split(":")[0]
        assert any(s == site for s, _ in faultinject.fired()), f"{fault} never fired"
        for k in spec["env"]:
            monkeypatch.delenv(k)
    monkeypatch.setenv("AUTOSAGE_FAULT", "lock::raise:")
    faultinject.reset()
    sched = _make_scheduler("batch-shared", tmp_path)
    _run_op(sched, _graph(), "spmm", 16, np.random.default_rng(0))
    sched.finalize()
    assert any(s == "lock" for s, _ in faultinject.fired())


# ------------------------------------------------ fault-injection DSL
def test_fault_spec_counts_and_match(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_FAULT", "run:row_ell:raise:2")
    faultinject.reset()
    for _ in range(2):
        with pytest.raises(faultinject.InjectedFault):
            faultinject.fault_point("run", name="row_ell.v1", op="spmm")
    faultinject.fault_point("run", name="row_ell.v1")  # count exhausted
    faultinject.fault_point("run", name="gather")  # match miss
    faultinject.fault_point("probe", name="row_ell.v1")  # site miss
    assert faultinject.fired() == {("run", "raise"): 2}


def test_fault_spec_wildcard_and_classes(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_FAULT", "*::oom:1;probe::raise:1")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault) as ei:
        faultinject.fault_point("prepare", name="x")
    assert ei.value.permanent
    assert resilience.classify(ei.value) == resilience.PERMANENT
    with pytest.raises(faultinject.InjectedFault) as ei:
        faultinject.fault_point("probe", name="x")
    assert not ei.value.permanent


def test_fault_prob_mode_is_seed_deterministic(monkeypatch):
    def run():
        faultinject.reset()
        hits = []
        for i in range(200):
            try:
                faultinject.fault_point("run", name=f"c{i}")
                hits.append(0)
            except faultinject.InjectedFault:
                hits.append(1)
        return hits

    monkeypatch.setenv("AUTOSAGE_FAULT", "prob:0.1:seed=8")
    a, b = run(), run()
    assert a == b and 0 < sum(a) < 200


def test_resilience_kill_switch(monkeypatch, tmp_path):
    """AUTOSAGE_RESILIENCE=0: no chain, so the run fault point never
    fires and a pinned runner runs raw."""
    monkeypatch.setenv("AUTOSAGE_RESILIENCE", "0")
    monkeypatch.setenv("AUTOSAGE_FAULT", "run::raise:")
    faultinject.reset()
    sage = _sage()
    csr = _graph()
    d = sage.decide(csr, 16, "spmm")
    assert sage.build_runner(csr, d)(torch.ones(csr.n_cols, 16)) is not None
    assert not faultinject.fired()


# ------------------------------------------------- circuit breaker
def test_breaker_quarantine_excludes_and_persists(tmp_path):
    path = str(tmp_path / "c.json")
    cache = ScheduleCache(path=path)
    br = resilience.CircuitBreaker(cache=cache, threshold=3, device="cpu")
    assert not br.record_failure("v1", site="run", op="spmm")
    assert not br.record_failure("v1", site="run", op="spmm")
    assert br.record_failure("v1", site="run", op="spmm")  # tips at 3
    assert br.is_quarantined("v1") and br.excluded_names() == {"v1"}
    assert br.record_failure("v2", site="prepare", op="spmm", permanent=True)
    for _ in range(10):  # the baseline is exempt no matter what
        assert not br.record_failure("baseline", site="run", op="spmm")
    cache.flush()
    peer = resilience.CircuitBreaker(cache=ScheduleCache(path=path), device="cpu")
    peer.maybe_sync()
    assert peer.is_quarantined("v1") and peer.is_quarantined("v2")


def test_breaker_ttl_half_open_recovery(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOSAGE_QUARANTINE_TTL_S", "0.05")
    cache = ScheduleCache(path=str(tmp_path / "c.json"))
    br = resilience.CircuitBreaker(cache=cache, threshold=1, device="cpu")
    br.record_failure("v1", site="run", op="spmm")
    assert br.is_quarantined("v1")
    time.sleep(0.06)
    # past the TTL: half-open, one recovery probe
    assert not br.is_quarantined("v1") and not br.is_excluded("v1")
    br.record_success("v1")
    assert not br.is_quarantined("v1")
    assert [r["state"] for r in dict(cache.quarantine_records()).values()] == ["cleared"]
    # a failed recovery probe re-quarantines at once
    br.record_failure("v2", site="run", op="spmm")
    time.sleep(0.06)
    assert not br.is_quarantined("v2")
    br.record_failure("v2", site="run", op="spmm")
    assert br.is_quarantined("v2")
    assert br.active_quarantine("v2")["reason"] == "recovery_failed"


def test_breaker_success_resets_consecutive_count():
    br = resilience.CircuitBreaker(cache=ScheduleCache(path=None), threshold=3, device="cpu")
    br.record_failure("v1")
    br.record_failure("v1")
    br.record_success("v1")
    assert not br.record_failure("v1")  # count restarted, not tipped
    assert not br.is_quarantined("v1")


def test_breaker_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resilience.CircuitBreaker(cache=None)


def _pin(sage, csr, f, op, choice):
    feat = InputFeatures.from_csr(csr, f, op)
    from repro_torch.core import device_sig

    key = ScheduleCache.key(device_sig(sage.device), feat.graph_sig, f, op, sage.alpha)
    sage.cache.put(key, {"choice": choice, "probe_ms": {}, "estimates_ms": {},
                         "probed": True, "stats": {"probed_at": 1.0}})
    return key


def test_repeated_run_faults_quarantine_and_serve_reference(tmp_path, monkeypatch):
    """A pinned candidate faulting at every run crosses the breaker
    threshold, lands in the shared cache's blacklist, and later
    schedulers leave it out of the shortlist."""
    path = str(tmp_path / "shared.json")
    csr = _graph()
    b = torch.ones(csr.n_cols, 16)
    s1 = _sage(path, shared=True)
    _pin(s1, csr, 16, "spmm", "row_ell")
    monkeypatch.setenv("AUTOSAGE_FAULT", "run::raise:")
    faultinject.reset()
    d1 = s1.decide(csr, 16, "spmm")
    assert d1.choice == "row_ell"
    runner = s1.build_runner(csr, d1)
    want = ref.spmm_ref(_t(csr.rowptr), _t(csr.colind), None, b)
    for _ in range(4):
        assert torch.equal(runner(b), want)  # every injectable stage faults
    s1.cache.flush()
    assert s1.breaker.is_quarantined("row_ell")
    monkeypatch.delenv("AUTOSAGE_FAULT")
    faultinject.reset()
    s2 = AutoSage(cache=ScheduleCache(path=path, shared=True), device="cpu", top_k=100)
    s2.breaker.maybe_sync()
    feat = InputFeatures.from_csr(csr, 24, "spmm")
    from repro_torch.core import registry

    _, short = s2.shortlist(feat, registry.candidates(feat, s2.hw, s2.device))
    assert short and "row_ell" not in [v.full_name() for v in short]


# ------------------------------------------------- replay contract
def test_replay_of_quarantined_pin_raises_replaymiss(tmp_path):
    path = str(tmp_path / "c.json")
    csr = _graph()
    sage = _sage(path)
    _pin(sage, csr, 16, "spmm", "row_ell")
    for _ in range(3):
        sage.breaker.record_failure("row_ell", site="run", op="spmm")
    sage.cache.flush()
    replay = AutoSage(cache=ScheduleCache(path=path, replay_only=True), device="cpu")
    with pytest.raises(ReplayMiss, match="quarantined"):
        replay.decide(csr, 16, "spmm")
    # outside replay the same state re-decides honestly instead
    fresh = _sage(path)
    fresh.breaker.maybe_sync()
    d2 = fresh.decide(csr, 16, "spmm")
    assert d2.choice != "row_ell" and not d2.from_cache


def test_replay_of_unconstructible_pin_raises_replaymiss(tmp_path):
    """The port's departure (ROADMAP Queue 3): a pin naming no local
    candidate raises ReplayMiss in replay mode and is re-decided
    otherwise; the JAX package serves the baseline under its name."""
    path = str(tmp_path / "c.json")
    csr = _graph()
    _pin(_sage(path), csr, 16, "spmm", "imaginary_cuda[z=1]")
    with pytest.raises(ReplayMiss, match="not a candidate"):
        AutoSage(cache=ScheduleCache(path=path, replay_only=True), device="cpu").decide(
            csr, 16, "spmm")
    d = _sage(path).decide(csr, 16, "spmm")
    assert not d.from_cache and d.choice != "imaginary_cuda[z=1]"


# ------------------------------------------- batch fault-retire path
def test_batch_reopens_bucket_when_pinned_choice_faults(tmp_path, monkeypatch):
    """A pinned choice that builds but faults at run time must not
    serve its fallback forever under the pinned name: the breaker's
    run-failure signal re-opens the bucket and the next pump re-probes
    it."""
    csr = _graph()
    sage = _sage()
    bs = BatchScheduler(sage, probe_budget_ms=10_000)
    b = torch.ones(csr.n_cols, 16)
    out, d = bs.spmm(csr, b)
    st = next(iter(bs._buckets.values()))
    # pin the bucket to a challenger, as a probe might have
    st.decision = type(d)(op=d.op, choice="row_ell", variant=st.by_name["row_ell"],
                          guardrail=None, from_cache=True, probe_ms={},
                          probe_overhead_ms=0.0, probe_iter_ms=0.0, estimates_ms={})
    probes_before = bs.stats()["probes_run"]
    runner = sage.build_runner(csr, st.decision)
    runner(b)  # builds the pinned stage: a later fault is a run-site one
    # the pinned choice faults past the retry budget (retries=1 -> 2
    # attempts): the chain serves the baseline, the breaker records it
    monkeypatch.setenv("AUTOSAGE_FAULT", "run:row_ell:raise:2")
    faultinject.reset()
    runner(b)
    assert sage.breaker.run_failures("row_ell") > 0
    monkeypatch.delenv("AUTOSAGE_FAULT")
    faultinject.reset()
    out2, d2 = bs.spmm(csr, b)
    probes_after = bs.stats()["probes_run"]
    assert probes_after > probes_before
    # the signal is consumed: the re-pinned choice has a clean count
    # (record_success on a re-pinned row_ell), so no further re-probe
    assert d2.choice != "row_ell" or sage.breaker.run_failures("row_ell") == 0
    bs.spmm(csr, b)
    assert bs.stats()["probes_run"] == probes_after
    np.testing.assert_allclose(out2.numpy(), ref.spmm_ref(
        _t(csr.rowptr), _t(csr.colind), None, b).numpy(), rtol=5e-3, atol=5e-3)


# ------------------------------------------------ fault observability
def test_faults_jsonl_and_metrics_emitted(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path / "tel"))
    monkeypatch.setenv("AUTOSAGE_FAULT", "run::raise:")
    faultinject.reset()
    before_faults = obs.REGISTRY.total("autosage_faults_total")
    before_fb = obs.REGISTRY.total("autosage_fallback_total")
    try:
        _run_op(_make_scheduler("autosage", tmp_path), _graph(), "spmm", 16,
                np.random.default_rng(0))
    finally:
        telemetry.close_streams()
    fpath = tmp_path / "tel" / "faults.jsonl"
    events = [json.loads(x) for x in fpath.read_text().splitlines() if x]
    assert any(e.get("site") == "run" for e in events)
    assert all(e["device_sig"] for e in events)
    assert obs.REGISTRY.total("autosage_faults_total", site="run") > 0
    assert obs.REGISTRY.total("autosage_faults_total") > before_faults
    assert obs.REGISTRY.total("autosage_fallback_total") > before_fb


# ------------------------------------------------- lock backoff knobs
def test_lock_backoff_grows_and_caps(monkeypatch):
    from repro_torch.core import cache as cache_mod

    monkeypatch.setenv("AUTOSAGE_LOCK_BACKOFF_BASE_MS", "2")
    monkeypatch.setenv("AUTOSAGE_LOCK_BACKOFF_MAX_MS", "16")
    monkeypatch.setenv("AUTOSAGE_LOCK_BACKOFF_JITTER", "0")
    waits = [cache_mod._lock_backoff_s(a) for a in range(8)]
    assert waits[:4] == [0.002, 0.004, 0.008, 0.016]
    assert all(w == 0.016 for w in waits[3:])  # capped
    monkeypatch.setenv("AUTOSAGE_LOCK_BACKOFF_JITTER", "0.5")
    jittered = [cache_mod._lock_backoff_s(0) for _ in range(50)]
    assert all(0.002 <= w <= 0.003 + 1e-12 for w in jittered)
    assert len(set(jittered)) > 1


def test_lock_contention_counts_metric(tmp_path):
    a = ScheduleCache(path=str(tmp_path / "c.json"), shared=True)
    a.put("k", {"choice": "x", "stats": {"probed_at": 1.0}})
    a.flush()
    outcomes = {dict(lk).get("outcome")
                for lk in obs.REGISTRY.hist_series("autosage_cache_lock_wait_ms")}
    assert outcomes & {"immediate", "waited"}


# ------------------------------------------- kill -9 mid-probe worker
_KILL_SCRIPT = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
from repro_torch.core import AutoSage, ScheduleCache
from repro_torch.sparse import hub_skew
csr = hub_skew(600, 4, 0.05, 24, seed=0).dedup_edges()
sage = AutoSage(cache=ScheduleCache(path=sys.argv[1], shared=True), device="cpu",
                probe_iters=50, probe_cap_ms=60_000, probe_frac=1.0)
print("probing", flush=True)
sage.decide(csr, 64, "spmm")
sage.cache.flush()
print("done", flush=True)
"""


def test_kill_mid_probe_leaves_shared_cache_loadable(tmp_path):
    """SIGKILL a fleet worker while it probes: the shared cache file (if
    any) stays valid JSON, and no .lock debris wedges the next worker."""
    path = str(tmp_path / "shared.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("AUTOSAGE_FAULT", "AUTOSAGE_REPLAY_ONLY")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")  # one core, as the suite shares them
    proc = subprocess.Popen(  # low priority: the suite shares the cores
        ["nice", "-n", "10", sys.executable, "-c",
         _KILL_SCRIPT.format(src=str(REPO / "src")), path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        assert proc.stdout.readline().strip() == "probing"
        time.sleep(0.3)  # into the probe loop
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    leftovers = [p.name for p in tmp_path.iterdir() if p.name != "shared.json"]
    assert not any(n.endswith(".lock") for n in leftovers), leftovers
    if os.path.exists(path):
        assert isinstance(json.load(open(path)), dict)
    sage = _sage(path, shared=True)
    assert sage.decide(_graph(), 16, "spmm").choice
    sage.cache.flush()
    assert isinstance(json.load(open(path)), dict)


# ------------------------------------------------ the torch taxonomy
class _AccelError(RuntimeError):
    """Stands in for torch.AcceleratorError, which carries error_code."""

    def __init__(self, msg, code):
        super().__init__(msg)
        self.error_code = code


@pytest.mark.parametrize("exc,cls,kind,fatal", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "permanent", "oom", False),
    (MemoryError(), "permanent", "oom", False),
    (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 1"),
     "permanent", "cuda_error", False),
    (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 701"),
     "permanent", "cuda_error", False),
    (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 700"),
     "permanent", "cuda_error", True),
    (RuntimeError("attention_chunks: CUDA launch failed with cudaError 719"),
     "permanent", "cuda_error", True),
    (_AccelError("CUDA error: an illegal memory access was encountered", 700),
     "permanent", "cuda_error", True),
    (RuntimeError("CUDA error: unspecified launch failure"), "permanent", "runtimeerror",
     True),
    (RuntimeError("CUDA error: device-side assert triggered"), "permanent", "runtimeerror",
     True),
    (RuntimeError("a transient hiccup"), "transient", "runtimeerror", False),
    (ValueError("bad shape"), "permanent", "valueerror", False),
    (resilience.ProbeTimeout("probe:x exceeded 1s"), "permanent", "timeout", False),
    (CacheLockTimeout("held"), "transient", "lock_timeout", False),
])
def test_torch_exception_classification(exc, cls, kind, fatal):
    """torch's OutOfMemoryError is a RuntimeError, which the JAX rule
    would retry: here it is permanent, kind "oom". A launcher's
    deterministic cudaError (invalid value 1, out of resources 701) is
    permanent; a sticky one (illegal address 700, launch failure 719 and
    their kin, by code or by torch's message) is fatal: no stage can run
    after it."""
    assert resilience.classify(exc) == cls
    assert resilience.fault_kind(exc) == kind
    assert resilience.is_fatal(exc) is fatal


def test_sticky_cuda_error_reraises_through_the_chain_and_decide():
    """A fatal error is not a fallback: the chain re-raises it at once
    (no fallback counted, the reference stage never runs), and so does
    decide's rescue."""
    sticky = RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 700")
    ran = []

    def boom(args):
        def run(*a):
            raise sticky
        return run

    stages = [("v", boom, True), ("baseline", lambda args: ran.append("b"), True),
              ("reference", lambda args: ran.append("r"), False)]
    before = obs.REGISTRY.total("autosage_fallback_total")
    run = resilience.chain_runner(stages, "spmm", device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        run(torch.ones(2, 2))
    assert not ran and obs.REGISTRY.total("autosage_fallback_total") == before

    sage = _sage()

    def sticky_impl(*a, **k):
        raise sticky

    sage._decide_impl = sticky_impl
    with pytest.raises(RuntimeError, match="cudaError 700"):
        sage.decide(_graph(), 16, "spmm")
    sage._decide_impl = lambda *a, **k: (_ for _ in ()).throw(KeyError("x"))
    assert sage.decide(_graph(), 16, "spmm").choice == "baseline"  # rescued


CARD = torch.device("cuda")  # a label here: nothing below touches a card


@pytest.mark.parametrize("exc,device,raises", [
    (RuntimeError("nvcc failed for spmm.cu"), CARD, True),
    (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 1"), CARD, True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), CARD, True),
    (ValueError("bad shape"), CARD, True),
    (faultinject.InjectedFault("run", "ragged_ell_cuda", "raise"), CARD, False),
    (faultinject.InjectedFault("prepare", "", "oom"), CARD, False),
    (resilience.ProbeTimeout("probe:x exceeded 1s"), CARD, False),
    (RuntimeError("nvcc failed for spmm.cu"), torch.device("cpu"), False),
    (ValueError("bad shape"), None, False),
    (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 700"),
     torch.device("cpu"), True),
])
def test_must_raise_on_a_card(exc, device, raises):
    """On a card a kernel's real fault (build, launch, OOM, anything not
    injected) must surface: only injected faults and watchdog timeouts
    may fall back there. CPU operands keep the JAX taxonomy; a sticky
    CUDA error raises everywhere."""
    assert resilience.must_raise(exc, device) is raises


@pytest.mark.parametrize("real", [True, False])
def test_chain_on_a_card_falls_back_only_from_injected_faults(real):
    """A real build or launch failure of the chosen kernel re-raises
    through the chain on a card: counted as a fault, no retry, no
    fallback, the baseline never built. An injected one walks on to the
    baseline, as on the CPU."""
    built, calls = [], []
    exc = (RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 1") if real
           else faultinject.InjectedFault("run", "v", "raise"))

    def kernel(args):
        def run(*a):
            calls.append("v")
            raise exc
        return run

    stages = [("v", kernel, True),
              ("baseline", lambda args: built.append("b") or (lambda *a: "base"), True),
              ("reference", lambda args: built.append("r"), False)]
    faults = obs.REGISTRY.total("autosage_faults_total")
    fallbacks = obs.REGISTRY.total("autosage_fallback_total")
    run = resilience.chain_runner(stages, "spmm", device=CARD)
    if real:
        with pytest.raises(RuntimeError, match="cudaError 1"):
            run(torch.ones(2, 2))
        assert built == [] and calls == ["v"]
        assert obs.REGISTRY.total("autosage_fallback_total") == fallbacks
    else:
        assert run(torch.ones(2, 2)) == "base"
        assert built == ["b"]
        assert obs.REGISTRY.total("autosage_fallback_total") == fallbacks + 1
    assert obs.REGISTRY.total("autosage_faults_total") > faults


def test_decide_rescue_lets_a_surfaced_kernel_fault_through():
    """A fault a kernel site re-raised on a card is marked, and decide's
    rescue lets it through; a fault of the decision machinery itself (the
    legacy op's estimate KeyError) is still rescued to the baseline."""
    sage = _sage()
    real = RuntimeError("spmm_ragged_ell: CUDA launch failed with cudaError 1")
    assert resilience.rescuable(real)
    sage._decide_impl = lambda *a, **k: (_ for _ in ()).throw(resilience.surface(real))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        sage.decide(_graph(), 16, "spmm")
    assert not resilience.rescuable(real)
    sage._decide_impl = lambda *a, **k: (_ for _ in ()).throw(KeyError("x"))
    assert sage.decide(_graph(), 16, "spmm").choice == "baseline"


# ------------------------------------------ against the JAX package
PARITY_SPECS = ("run::raise:", "run:row_ell:raise:2", "prepare::oom:", "run:row_ell:oom:1")


def _events(path):
    """fault/fallback/quarantine events of one faults.jsonl, without the
    fields that name the process (time, device, error text)."""
    out = []
    for line in Path(path).read_text().splitlines():
        e = json.loads(line)
        for k in ("t_mono", "device_sig", "schema", "error", "since", "device"):
            e.pop(k, None)
        out.append(e)
    return out


@pytest.mark.parametrize("spec", PARITY_SPECS)
def test_fault_sequence_matches_jax(spec, tmp_path, monkeypatch):
    """One spec, one seeded graph, one pinned library choice, four runner
    calls in each package: equal fault/fallback/quarantine events, equal
    counter deltas, equal quarantine records, equal outputs."""
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "parity-dev")
    monkeypatch.setenv("AUTOSAGE_FAULT", spec)
    csr, jcsr = _graph(), jx_hub_skew(600, 4, 0.05, 24, seed=0).dedup_edges()
    b = np.random.default_rng(3).standard_normal((csr.n_cols, 16)).astype(np.float32)
    results = {}
    for pkg in ("jax", "torch"):
        tel = tmp_path / f"tel_{pkg}"
        monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tel))
        path = str(tmp_path / f"{pkg}.json")
        if pkg == "jax":
            import jax.numpy as jnp

            jx_faultinject.reset()
            reg, Cache = jx_obs.REGISTRY, JxCache
            sage = JxSage(cache=JxCache(path=path), probe_iters=1, probe_cap_ms=25)
            g, arg = jcsr, jnp.asarray(b)
        else:
            faultinject.reset()
            reg, Cache = obs.REGISTRY, ScheduleCache
            sage = AutoSage(cache=ScheduleCache(path=path), device="cpu", probe_iters=1,
                            probe_cap_ms=25)
            g, arg = csr, torch.from_numpy(b)
        from repro.core.features import InputFeatures as JxFeat

        key = Cache.key("parity-dev", JxFeat.from_csr(jcsr, 16, "spmm").graph_sig, 16,
                        "spmm", sage.alpha)
        sage.cache.put(key, {"choice": "row_ell", "probe_ms": {}, "estimates_ms": {},
                             "probed": True, "stats": {"probed_at": 1.0}})
        before = {n: reg.total(n) for n in ("autosage_faults_total",
                                            "autosage_fallback_total")}
        d = sage.decide(g, 16, "spmm")
        assert d.from_cache and d.choice == "row_ell"
        runner = sage.build_runner(g, d)
        outs = [np.asarray(runner(arg)) for _ in range(4)]
        (jx_telemetry if pkg == "jax" else telemetry).close_streams()
        sage.cache.flush()
        recs = {k: {f: v for f, v in r.items() if f not in ("since", "device")}
                for k, r in sage.cache.quarantine_records()}
        results[pkg] = dict(
            events=_events(tel / "faults.jsonl") if (tel / "faults.jsonl").exists() else [],
            delta={n: reg.total(n) - before[n] for n in before},
            recs=recs, outs=outs,
        )
    jx, pt = results["jax"], results["torch"]
    assert pt["events"] == jx["events"]
    assert pt["events"], "the spec never fired"
    assert pt["delta"] == jx["delta"]
    assert pt["recs"] == jx["recs"]
    oracle = ref.spmm_ref(_t(csr.rowptr), _t(csr.colind), None, torch.from_numpy(b)).numpy()
    for o_pt, o_jx in zip(pt["outs"], jx["outs"]):
        np.testing.assert_allclose(o_pt, o_jx, rtol=1e-5, atol=1e-5)
    last = [e for e in pt["events"] if e.get("event") == "fallback"]
    if last and last[-1]["to"] == "reference":
        np.testing.assert_array_equal(pt["outs"][-1], oracle)  # terminal stage: the oracle


def test_a_dropped_scheduler_frees_its_chain_runners_without_gc():
    """The chain's stages close over the device, not the AutoSage: with
    the garbage collector off, dropping the scheduler frees it (and the
    layouts its runner memo holds), as with raw runners."""
    import gc
    import weakref

    csr = _graph()
    sage = _sage()
    d = sage.decide(csr, 16, "spmm")
    sage.build_runner(csr, d)(torch.ones(csr.n_cols, 16))
    ref_ = weakref.ref(sage)
    gc.disable()
    try:
        del sage, d
        assert ref_() is None
    finally:
        gc.enable()
