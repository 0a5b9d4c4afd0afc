"""The port's GraphSAGE forward against repro.models.gnn.sage_forward
(sage=None), with the same weights carried over by sage_params_from_jax
and the same numpy graph and features: through the torch reference and
through the scheduler with every hand-kernel family in the pool (on the
CPU those run their plain versions).

Tolerance rtol 1e-4, atol 1e-4 * max|ref|: three layers of fp32 matmuls
and sums, taken in another order by XLA and by torch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.gnn_sage import CONFIG
from repro.models import gnn as jx_gnn
from repro.sparse import hub_skew as jx_hub_skew
from repro_torch.core import AutoSage, ScheduleCache
from repro_torch.models.gnn import SAGE, norm_csr, sage_params_from_jax
from repro_torch.sparse import hub_skew

torch.set_num_threads(1)  # see test_torch_spmm.py

IN_DIM, N_CLASSES = 24, 5


@pytest.fixture(scope="module")
def case():
    cfg = dataclasses.replace(CONFIG, d_model=32)
    params = jx_gnn.init_gnn(cfg, jax.random.PRNGKey(0), IN_DIM, N_CLASSES)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    jx_csr = jx_hub_skew(400, 4, 0.05, 80, seed=3)
    x = np.random.default_rng(3).standard_normal((400, IN_DIM)).astype(np.float32)
    want = np.asarray(jx_gnn.sage_forward(params, jx_csr, x))
    return params_np, hub_skew(400, 4, 0.05, 80, seed=3), x, want


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max())
    )


def test_reference_forward_matches_jax(case):
    params_np, csr, x, want = case
    model = sage_params_from_jax(params_np, device="cpu")
    assert [tuple(w.shape) for w in model.w_agg] == [(24, 32), (32, 32), (32, 5)]
    _close(model(csr, torch.from_numpy(x)), want)


def test_scheduled_forward_matches_jax(case, monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    params_np, csr, x, want = case
    model = sage_params_from_jax(params_np, device="cpu")
    sage = AutoSage(cache=ScheduleCache(path=str(tmp_path / "c.json")), device="cpu",
                    probe_iters=2, probe_cap_ms=100)
    with torch.no_grad():
        out = model(csr, torch.from_numpy(x), sage=sage)
    _close(out, want)
    # hidden layers share one F=32 decision, the head gets its own F=5 key
    assert len(sage.cache.keys_for_op("spmm")) == 2
    assert not sage.cache.keys_for_op("spmm_bwd_b")
    # with gradients enabled the backward SpMMs are decisions of their own
    model(csr, torch.from_numpy(x), sage=sage).sum().backward()
    assert len(sage.cache.keys_for_op("spmm_bwd_b")) == 2
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_norm_csr_matches_jax(case):
    _, csr, _, _ = case
    jx_csr = jx_hub_skew(400, 4, 0.05, 80, seed=3)
    assert np.array_equal(norm_csr(csr).val, jx_gnn._norm_csr(jx_csr).val)


def test_seeded_init_and_device_rule():
    a = SAGE(602, 41, seed=0, device="cpu")
    b = SAGE(602, 41, seed=0, device="cpu")
    assert [tuple(w.shape) for w in a.w_self] == [(602, 256), (256, 256), (256, 41)]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SAGE(602, 41)
