"""The port's GAT layer against repro.models.gnn.gat_layer (sage=None),
with the same weights carried over by gat_params_from_jax and the same
numpy graph (deduplicated) and features: through the torch reference,
through the scheduler with the fused kernels in the pool (on the CPU
they run their plain versions), and with each fused family pinned
through the schedule cache.

Tolerance rtol 1e-4, atol 1e-4 * max|ref|: fp32 projections, logits,
exponentials and sums, taken in another order by XLA and by torch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.gnn_sage import CONFIG
from repro.models import gnn as jx_gnn
from repro.sparse import hub_skew as jx_hub_skew
from repro_torch.core import AutoSage, InputFeatures, ScheduleCache, device_sig, registry
from repro_torch.models.gnn import GAT, gat_params_from_jax
from repro_torch.sparse import hub_skew

torch.set_num_threads(1)  # see test_torch_spmm.py

IN_DIM = 24
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    cfg = dataclasses.replace(CONFIG, d_model=32)
    params = jx_gnn.init_gat(cfg, jax.random.PRNGKey(0), IN_DIM)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.default_rng(3).standard_normal((300, IN_DIM)).astype(np.float32)
    jx_csr = jx_hub_skew(300, 3, 0.1, 40, seed=3).dedup_edges()
    want = np.asarray(jx_gnn.gat_layer(params, jx_csr, x))
    return params_np, hub_skew(300, 3, 0.1, 40, seed=3).dedup_edges(), x, want


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max())
    )


def _sage(path, **kw):
    return AutoSage(cache=ScheduleCache(path=path, **kw), device="cpu",
                    probe_iters=2, probe_cap_ms=100)


def test_reference_forward_matches_jax(case):
    params_np, csr, x, want = case
    model = gat_params_from_jax(params_np, device="cpu")
    assert [tuple(w.shape) for w in (model.wq, model.wk, model.wv)] == [(24, 32)] * 3
    _close(model(csr, torch.from_numpy(x)), want)


def test_scheduled_forward_matches_jax(case, monkeypatch, tmp_path):
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    params_np, csr, x, want = case
    model = gat_params_from_jax(params_np, device="cpu")
    sage = _sage(str(tmp_path / "c.json"))
    with torch.no_grad():
        out = model(csr, torch.from_numpy(x), sage=sage)
    _close(out, want)
    keys = sage.cache.keys_for_op("attention")
    assert len(keys) == 1 and "|F=32|" in keys[0]
    assert sage.cache.get(keys[0])["probe_ms"]
    # with gradients enabled the five backward ops are decisions of their own
    model(csr, torch.from_numpy(x), sage=sage).sum().backward()
    for op in ("attention_bwd_e", "attention_bwd_p", "attention_bwd_q",
               "attention_bwd_k", "attention_bwd_v"):
        assert len(sage.cache.keys_for_op(op)) == 1, op
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("family", ["fused_attention_cuda", "ragged_attention_cuda"])
def test_pinned_fused_family_matches_jax(case, monkeypatch, tmp_path, family):
    """Each fused family pinned through the cache (the replay path users
    rely on) runs inside the model and matches the reference."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    params_np, csr, x, want = case
    model = gat_params_from_jax(params_np, device="cpu")
    feat = InputFeatures.from_csr(csr.structural(), 32, "attention")
    hw = AutoSage(cache=ScheduleCache(path=None), device="cpu").hw
    names = [v.full_name() for v in registry.candidates(feat, hw, CPU) if v.name == family]
    assert len(names) == 1
    path = str(tmp_path / "pin.json")
    key = ScheduleCache.key(device_sig(CPU), feat.graph_sig, 32, "attention", 0.95)
    ScheduleCache(path=path).put(key, {"choice": names[0], "probe_ms": {},
                                       "estimates_ms": {}})
    pinned = _sage(path, replay_only=True)
    assert pinned.decide_attention(csr.structural(), 32).choice == names[0]
    with torch.no_grad():
        _close(model(csr, torch.from_numpy(x), sage=pinned), want)


def test_seeded_init_and_device_rule():
    a = GAT(602, seed=0, device="cpu")
    b = GAT(602, seed=0, device="cpu")
    assert tuple(a.wq.shape) == (602, 256)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.wq, a.wk)
    std = float(a.wq.detach().std())
    assert abs(std - 602 ** -0.5) < 0.1 * 602 ** -0.5  # normal x 1/sqrt(in_dim)
    with pytest.raises(ValueError, match="wk shape"):
        gat_params_from_jax({"wq": np.zeros((4, 8)), "wk": np.zeros((4, 9)),
                             "wv": np.zeros((4, 8))}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GAT(602)
