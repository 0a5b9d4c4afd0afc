"""The per-object memo of a graph's decide features (core/features.py):
`InputFeatures.from_csr` computes a CSR object's structure statistics
once, counts each reuse in ``autosage_features_total{event}``, and gives
field for field what a fresh computation gives, here and in the JAX
package, on the forward graph, its transpose, its structural view and
empty graphs; a warm training step of CSR attention builds nothing."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.features import InputFeatures as JxFeat
from repro.sparse import CSR as JxCSR
from repro_torch.core import AutoSage, InputFeatures, ScheduleCache, autodiff, obs
from repro_torch.sparse import hub_skew, power_law
from repro_torch.sparse.csr import CSR

torch.set_num_threads(1)  # see test_torch_spmm.py

PAIRS = ((256, "attention"), (256, "attention_bwd_e"), (41, "spmm"), (256, "spmm"),
         (64, "attention_bwd_q"), (32, "sddmm"))
ATTENTION_OPS = ("attention", "attention_bwd_e", "attention_bwd_v", "attention_bwd_p",
                 "attention_bwd_q", "attention_bwd_k")


def _counts():
    return {e: obs.REGISTRY.total(obs.FEATURES_TOTAL, event=e) for e in ("built", "hits")}


def _delta(before):
    now = _counts()
    return {e: now[e] - before[e] for e in now}


def _fresh(csr: CSR) -> CSR:
    """A new object over copies of the same arrays: no memo of any kind."""
    val = None if csr.val is None else csr.val.copy()
    return CSR(csr.rowptr.copy(), csr.colind.copy(), val, csr.n_rows, csr.n_cols)


def _jax(csr: CSR, f: int, op: str) -> dict:
    """The JAX package's features of the same arrays (the formula the port
    had before the memo)."""
    jcsr = JxCSR(csr.rowptr.copy(), csr.colind.copy(),
                 None if csr.val is None else csr.val.copy(), csr.n_rows, csr.n_cols)
    return dataclasses.asdict(JxFeat.from_csr(jcsr, f, op))


def _skewed() -> CSR:
    return hub_skew(600, 4, 0.05, 120, seed=3)


@pytest.mark.parametrize("graph", ["hub_skew", "power_law"])
def test_one_build_per_object_and_values_unchanged(graph):
    csr = _skewed() if graph == "hub_skew" else power_law(500, 1.5, avg_deg=6.0, n_cols=450,
                                                           seed=4)
    before = _counts()
    got = [InputFeatures.from_csr(csr, f, op) for f, op in PAIRS]
    assert _delta(before) == {"built": 1, "hits": len(PAIRS) - 1}
    for (f, op), feat in zip(PAIRS, got):
        assert feat == InputFeatures.from_csr(_fresh(csr), f, op)
        assert dataclasses.asdict(feat) == _jax(csr, f, op)
        assert (feat.f, feat.op, feat.f_mod_4) == (f, op, f % 4 == 0)
    assert got[0].dup_edges == csr.has_duplicate_edges()
    assert not any(feat.dup_edges for feat in got[1:])


def test_transpose_and_structural_view_compute_their_own():
    csr = _skewed()
    csr = CSR(csr.rowptr, csr.colind, np.linspace(0.5, 1.5, csr.nnz).astype(np.float32),
              csr.n_rows, csr.n_cols)
    fwd = InputFeatures.from_csr(csr, 64, "spmm")
    t = csr.transpose_with_perm()[0]
    s = csr.structural()
    assert s is not csr and t is not csr
    for view, op in ((t, "spmm_bwd_b"), (s, "attention_bwd_e")):
        before = _counts()
        feat = InputFeatures.from_csr(view, 64, op)
        assert _delta(before) == {"built": 1, "hits": 0}
        assert feat == InputFeatures.from_csr(_fresh(view), 64, op)
        assert dataclasses.asdict(feat) == _jax(view, 64, op)
    # the transpose's degrees are in-degrees: inheriting the forward
    # graph's statistics would show here
    feat_t = InputFeatures.from_csr(t, 64, "spmm")
    assert (feat_t.n_rows, feat_t.n_cols) == (csr.n_cols, csr.n_rows)
    assert (feat_t.deg_max, feat_t.padding_waste) != (fwd.deg_max, fwd.padding_waste)
    # the view shares the structure, so its statistics equal the parent's
    feat_s = InputFeatures.from_csr(s, 64, "spmm")
    assert feat_s == fwd


@pytest.mark.parametrize("shape", [(0, 5), (7, 9)], ids=["no_rows", "no_edges"])
def test_empty_graph_keeps_values(shape):
    n_rows, n_cols = shape
    csr = CSR(np.zeros(n_rows + 1, np.int32), np.zeros(0, np.int32), None, n_rows, n_cols)
    for f, op in PAIRS:
        feat = InputFeatures.from_csr(csr, f, op)
        assert dataclasses.asdict(feat) == _jax(csr, f, op)
        assert feat == InputFeatures.from_csr(_fresh(csr), f, op)
    assert (feat.padding_waste, feat.ell_width_est, feat.deg_max) == (0.0, 0.0, 0.0)


def test_warm_attention_step_builds_nothing(monkeypatch):
    csr = hub_skew(300, 4, 0.05, 60, seed=5).dedup_edges()
    sage = AutoSage(cache=ScheduleCache(path=None), device="cpu", probe_iters=1,
                    probe_cap_ms=50, probe_frac=0.3)
    picks = []
    decide = sage.decide

    def spy(graph, f, op, **kw):
        d = decide(graph, f, op, **kw)
        picks[-1][op] = d.choice
        return d

    monkeypatch.setattr(sage, "decide", spy)
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((csr.n_rows, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    deltas = []
    for _ in range(2):
        picks.append({})
        before = _counts()
        out = autodiff.attention(csr, q, k, v, sched=sage)
        (0.5 * (out ** 2).sum(dim=1).mean()).backward()
        with torch.no_grad():
            for w in (q, k, v):
                w -= 0.05 * w.grad
                w.grad = None
        deltas.append(_delta(before))
    assert sorted(picks[0]) == sorted(ATTENTION_OPS)
    assert picks[1] == picks[0]
    assert deltas[0]["built"] >= 2  # the structural view and its transpose
    assert deltas[1] == {"built": 0, "hits": len(ATTENTION_OPS)}
