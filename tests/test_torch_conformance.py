"""repro_torch's scheduler conformance on the CPU: the twin of
tests/test_conformance.py. One invariant suite over every scheduler
surface x every op, {AutoSage, BatchScheduler, shared-cache
BatchScheduler} x {spmm, sddmm, attention}:

  1. decide -> build_runner -> run equals the `kernels/ref.py` oracle
     (and the JAX package's oracle on the same numpy inputs);
  2. guardrail fallback safety: a rejected probe falls back to the
     baseline, alpha <= 1, and an accepted challenger beat
     alpha * t_baseline on the probe;
  3. the returned decision is always runnable (choice resolves to a
     variant, outputs finite);
  4. re-deciding the same input is deterministic (cache / bucket hit,
     no second probe);
  5. a BatchScheduler with no probe budget serves the runnable baseline;
  6. on a hub-dominated input the merge-path family is in the pool
     (``AUTOSAGE_PROBE_PALLAS=1``: the CUDA families join it on the CPU
     and run their plain versions) and the result still equals the
     oracle.

Tolerances are the JAX file's: rtol 5e-3, atol 5e-3 against the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import AutoSage, BatchScheduler, HardwareSpec, InputFeatures, ScheduleCache
from repro_torch.core import registry
from repro_torch.kernels import ref
from repro_torch.sparse import hub_skew, single_hub

torch.set_num_threads(1)  # see test_torch_spmm.py

OPS = ("spmm", "sddmm", "attention")
SCHEDULERS = ("autosage", "batch", "batch-shared")
CPU = torch.device("cpu")


def _graph(seed=0):
    # dedup'd so the fused-attention gate stays open; hub-skewed so the
    # candidate pool is non-trivial for every op
    return hub_skew(800, 4, 0.05, 24, seed=seed).dedup_edges()


def _sage(path=None, shared=False):
    return AutoSage(cache=ScheduleCache(path=path, shared=shared), device="cpu",
                    probe_iters=1, probe_cap_ms=25, probe_frac=0.25)


def _make_scheduler(kind: str, tmp_path):
    if kind == "autosage":
        return _sage()
    if kind == "batch":
        return BatchScheduler(_sage(), probe_budget_ms=10_000)
    if kind == "batch-shared":
        return BatchScheduler(_sage(str(tmp_path / "shared.json"), shared=True),
                              probe_budget_ms=10_000)
    raise KeyError(kind)


def _run_op(sched, csr, op, f, rng):
    """Dispatch through the scheduler's convenience surface; returns
    (out, decision, oracle, the JAX package's oracle)."""
    rowptr, colind = torch.as_tensor(csr.rowptr), torch.as_tensor(csr.colind)
    jrp, jci = jnp.asarray(csr.rowptr), jnp.asarray(csr.colind)
    if op == "spmm":
        b = rng.standard_normal((csr.n_cols, f)).astype(np.float32)
        out, d = sched.spmm(csr, torch.from_numpy(b))
        oracle = ref.spmm_ref(rowptr, colind, None, torch.from_numpy(b))
        joracle = jref.spmm_ref(jrp, jci, None, jnp.asarray(b))
    elif op == "sddmm":
        x = rng.standard_normal((csr.n_rows, f)).astype(np.float32)
        y = rng.standard_normal((csr.n_cols, f)).astype(np.float32)
        out, d = sched.sddmm(csr, torch.from_numpy(x), torch.from_numpy(y))
        oracle = ref.sddmm_ref(rowptr, colind, torch.from_numpy(x), torch.from_numpy(y))
        joracle = jref.sddmm_ref(jrp, jci, jnp.asarray(x), jnp.asarray(y))
    elif op == "attention":
        q, k, v = (rng.standard_normal((n, f)).astype(np.float32)
                   for n in (csr.n_rows, csr.n_cols, csr.n_cols))
        out, d = sched.attention(csr, *map(torch.from_numpy, (q, k, v)))
        oracle = ref.csr_attention_ref(rowptr, colind, *map(torch.from_numpy, (q, k, v)))
        joracle = jref.csr_attention_ref(jrp, jci, *map(jnp.asarray, (q, k, v)))
    else:
        raise KeyError(op)
    return out, d, oracle, joracle


def _assert_oracle(out, oracle, joracle, msg):
    out = out.detach().numpy()
    assert np.isfinite(out).all(), msg
    np.testing.assert_allclose(out, oracle.numpy(), rtol=5e-3, atol=5e-3, err_msg=msg)
    np.testing.assert_allclose(out, np.asarray(joracle), rtol=5e-3, atol=5e-3, err_msg=msg)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", SCHEDULERS)
def test_decide_run_matches_oracle(kind, op, tmp_path):
    """Whatever variant any scheduler picks, the scheduled result equals
    both packages' oracles: choices may change speed, never values."""
    sched = _make_scheduler(kind, tmp_path)
    out, d, oracle, joracle = _run_op(sched, _graph(), op, 16, np.random.default_rng(0))
    _assert_oracle(out, oracle, joracle, f"{kind}/{op} chose {d.choice}")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", SCHEDULERS)
def test_guardrail_fallback_safety(kind, op, tmp_path):
    """Prop. 1 everywhere: alpha <= 1; a rejected probe serves exactly the
    baseline variant; an accepted challenger beat alpha * t_baseline on
    the probe distribution."""
    sched = _make_scheduler(kind, tmp_path)
    _, d, _, _ = _run_op(sched, _graph(seed=1), op, 16, np.random.default_rng(1))
    gr = d.guardrail
    if gr is None:
        # cached or provisional decision: no probe ran in this process
        assert d.from_cache or d.choice == "baseline"
        return
    assert gr.alpha <= 1.0
    if gr.accepted:
        assert d.choice == gr.choice != "baseline"
        assert gr.t_best_ms <= gr.alpha * gr.t_baseline_ms
        assert gr.speedup >= 1.0 / gr.alpha - 1e-9
    else:
        assert d.choice == "baseline"
        assert d.variant.is_baseline


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", SCHEDULERS)
def test_redecide_is_deterministic_and_probe_free(kind, op, tmp_path):
    """Second decide on the same input: same choice, zero extra probes
    (exact-key cache hit for AutoSage, bucket hit for BatchScheduler)."""
    sched = _make_scheduler(kind, tmp_path)
    rng = np.random.default_rng(2)
    csr = _graph(seed=2)
    _, d1, _, _ = _run_op(sched, csr, op, 16, rng)
    if isinstance(sched, BatchScheduler):
        probes_after_first = sched.stats()["probes_run"]
    _, d2, _, _ = _run_op(sched, csr, op, 16, rng)
    assert d2.choice == d1.choice
    if isinstance(sched, BatchScheduler):
        assert sched.stats()["probes_run"] == probes_after_first
    else:
        assert d2.from_cache and not d2.probe_ms


@pytest.mark.parametrize("op", OPS)
def test_zero_budget_batch_serves_runnable_baseline(op):
    """A BatchScheduler with no probe budget still serves correct,
    runnable decisions (the guardrail fallback), for every op."""
    bs = BatchScheduler(_sage(), probe_budget_ms=0.0)
    out, d, oracle, joracle = _run_op(bs, _graph(seed=3), op, 16, np.random.default_rng(3))
    assert d.choice == "baseline"
    _assert_oracle(out, oracle, joracle, op)
    assert bs.stats()["probes_run"] == 0


@pytest.mark.parametrize("op", ("spmm", "sddmm"))
def test_merge_path_in_pool_and_conformant_on_hub_graph(op, monkeypatch):
    """On a hub-dominated input the merge-path family is in the pool
    (the port's name for JAX's merge_path_pallas), and whatever the
    scheduler then picks, the result still equals the oracle."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    csr = single_hub(400, nnz_frac=0.9, seed=5)
    f = 32  # the spmm kernel pool gates on f >= 32, as JAX's
    feat = InputFeatures.from_csr(csr, f, op)
    hw = HardwareSpec.current(CPU)
    names = {v.name for v in registry.candidates(feat, hw, CPU)}
    assert "merge_path_cuda" in names, names
    assert registry.PORTED_FROM["merge_path_cuda"] == "merge_path_pallas"
    out, d, oracle, joracle = _run_op(_sage(), csr, op, f, np.random.default_rng(4))
    _assert_oracle(out, oracle, joracle, f"{op} chose {d.choice}")
