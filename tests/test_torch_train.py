"""Training in both packages from the same start: JAX's init_gnn and
init_gat weights carried over with sage_params_from_jax and
gat_params_from_jax, the same numpy graph, features and labels
(train_gnn.make_data is the JAX example's), then three SGD steps at
lr 0.05 (SAGE: mean log-softmax NLL, GAT: 0.5 * ||out||^2 / n_rows)
through an AutoSage in each package, every forward and backward op
scheduled. The losses of every step and the final weights must agree.

Tolerance rtol 1e-4, atol 1e-4 * max|ref|: three steps of fp32 chains
(matmuls, sparse sums, softmaxes) taken in another order by XLA and by
torch, each step feeding the next."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn_sage import CONFIG
from repro.core import AutoSage as JxSage
from repro.core import ScheduleCache as JxCache
from repro.models import gnn as jx_gnn
from repro.sparse import hub_skew as jx_hub_skew
from repro.sparse import reddit_like as jx_reddit_like
from repro_torch.core import AutoSage, ScheduleCache
from repro_torch.models.gnn import gat_params_from_jax, sage_params_from_jax
from repro_torch.sparse import hub_skew, reddit_like
from repro_torch.train_gnn import LR, make_data, nll_loss, sgd_step, train_full

torch.set_num_threads(1)  # see test_torch_spmm.py

_spec = importlib.util.spec_from_file_location(
    "jx_train_gnn_example", Path(__file__).resolve().parents[1] / "examples" / "train_gnn.py")
jx_example = importlib.util.module_from_spec(_spec)  # the JAX example's make_data
_spec.loader.exec_module(jx_example)

STEPS = 3


def _sage(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    return AutoSage(cache=ScheduleCache(path=None), device="cpu", probe_iters=2,
                    probe_cap_ms=100, probe_frac=0.1)


def _jx_sage(monkeypatch):
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    return JxSage(cache=JxCache(path=None), probe_iters=2, probe_cap_ms=100, probe_frac=0.1)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def test_make_data_matches_the_jax_example():
    graph = reddit_like(0.005, seed=0)
    feats, labels = make_data(graph, 16, 64)
    jf, jl = jx_example.make_data(jx_reddit_like(0.005, seed=0), 16, 64)
    np.testing.assert_array_equal(feats, np.asarray(jf))
    np.testing.assert_array_equal(labels, np.asarray(jl))


def test_sage_training_matches_jax(monkeypatch):
    cfg = dataclasses.replace(CONFIG, d_model=32)
    in_dim, classes = 24, 5
    params = jx_gnn.init_gnn(cfg, jax.random.PRNGKey(0), in_dim, classes)
    graph = hub_skew(400, 4, 0.05, 80, seed=3)
    jgraph = jx_hub_skew(400, 4, 0.05, 80, seed=3)
    feats, labels = make_data(graph, classes, in_dim, seed=1)

    model = sage_params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    losses = train_full(model, graph, x, y, sage=_sage(monkeypatch), epochs=STEPS,
                        log=lambda _: None)

    js = _jx_sage(monkeypatch)
    jx_, jy = jnp.asarray(feats), jnp.asarray(labels)

    def loss_fn(p):
        logp = jax.nn.log_softmax(jx_gnn.sage_forward(p, jgraph, jx_, sage=js))
        return -jnp.take_along_axis(logp, jy[:, None], 1).mean()

    jx_losses = []
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(loss_fn)(params)
        params = jax.tree.map(lambda p, gg: p - LR * gg, params, g)
        jx_losses.append(float(loss))
    _close(losses, jx_losses)
    assert losses[-1] < losses[0]
    for name in ("w_agg", "w_self"):
        for got, want in zip(getattr(model, name), params[name]):
            _close(got.detach().numpy(), want)


def test_gat_training_matches_jax(monkeypatch):
    cfg = dataclasses.replace(CONFIG, d_model=32)
    in_dim = 24
    params = jx_gnn.init_gat(cfg, jax.random.PRNGKey(0), in_dim)
    graph = hub_skew(300, 3, 0.1, 40, seed=3).dedup_edges()
    jgraph = jx_hub_skew(300, 3, 0.1, 40, seed=3).dedup_edges()
    x = np.random.default_rng(3).standard_normal((300, in_dim)).astype(np.float32)
    lr = LR / graph.n_rows

    model = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    sage = _sage(monkeypatch)
    xt = torch.from_numpy(x)
    losses = [sgd_step(model, lambda: 0.5 * (model(graph, xt, sage=sage) ** 2).sum(), lr)
              for _ in range(STEPS)]
    ops = {k.split("|")[3] for k in sage.cache._data}
    assert ops == {"attention", "attention_bwd_e", "attention_bwd_p", "attention_bwd_q",
                   "attention_bwd_k", "attention_bwd_v"}

    js = _jx_sage(monkeypatch)
    jx_ = jnp.asarray(x)

    def loss_fn(p):
        return 0.5 * (jx_gnn.gat_layer(p, jgraph, jx_, sage=js) ** 2).sum()

    jx_losses = []
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(loss_fn)(params)
        params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
        jx_losses.append(float(loss))
    _close(losses, jx_losses)
    assert losses[-1] < losses[0]
    for name in ("wq", "wk", "wv"):
        _close(getattr(model, name).detach().numpy(), params[name])


def test_nll_loss_and_sgd_step():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0]], requires_grad=True)
    y = torch.tensor([0, 1], dtype=torch.int32)
    want = -(torch.log_softmax(logits, -1)[[0, 1], [0, 1]]).mean()
    assert torch.allclose(nll_loss(logits, y), want)
    lin = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(1.0)
    loss = sgd_step(lin, lambda: lin(torch.ones(1, 2)).sum(), lr=0.5)
    assert loss == pytest.approx(2.0)
    assert torch.equal(lin.weight, torch.full((1, 2), 0.5))
