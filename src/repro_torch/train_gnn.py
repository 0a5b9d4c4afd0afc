"""Full-graph GraphSAGE training on a synthetic Reddit-shaped graph, with
every forward and backward aggregation scheduled by AutoSage.

Port of examples/train_gnn.py's ``make_data`` and ``train_full``:

    PYTHONPATH=src python -m repro_torch.train_gnn --epochs 30 --scale 0.01
    PYTHONPATH=src python -m repro_torch.train_gnn --device cpu --epochs 3

Each step runs the forward SpMMs ("spmm") and their backward
("spmm_bwd_b" on the memoized transpose) as scheduled decisions with
their own cache keys; the first step decides and prepares, later steps
replay from the cache and the runner memo. Plain SGD (lr 0.05) on the
mean log-softmax negative log-likelihood, as in the JAX example. The
JAX example's minibatch and fleet modes need the batch scheduler, which
the port does not have yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import AutoSage, ScheduleCache
from repro_torch.models.gnn import SAGE
from repro_torch.sparse import reddit_like
from repro_torch.sparse.csr import CSR, TRANSPOSE_STATS

LR = 0.05


def make_data(graph: CSR, classes: int, in_dim: int, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded node features (n, in_dim) float32 and labels (n,) int32
    with a graph-independent signal in feature 0: the JAX example's
    arrays for the same seed."""
    n = graph.n_rows
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, in_dim)).astype(np.float32)
    labels = feats[:, 0] * 3 + rng.standard_normal(n) * 0.3
    labels = np.digitize(
        labels, np.quantile(labels, np.linspace(0, 1, classes + 1)[1:-1])
    ).astype(np.int32)
    return feats, labels


def nll_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the log-softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def sgd_step(model: torch.nn.Module, loss_fn: Callable[[], torch.Tensor],
             lr: float = LR) -> float:
    """One step: loss, backward (scheduled where the model's ops are),
    p -= lr * grad. Returns the loss before the update."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad)
    return float(loss.detach())


def train_full(model: SAGE, graph: CSR, x: torch.Tensor, y: torch.Tensor,
               sage: Optional[AutoSage] = None, epochs: int = 30, lr: float = LR,
               log: Callable[[str], None] = print) -> List[float]:
    """Full-graph SGD; returns the loss of every step."""
    losses = []
    t0 = time.time()
    for epoch in range(epochs):
        losses.append(sgd_step(model, lambda: nll_loss(model(graph, x, sage=sage), y), lr))
        if epoch % 5 == 0 or epoch == epochs - 1:
            log(f"epoch {epoch:3d} loss {losses[-1]:.4f} ({time.time() - t0:.1f}s)")
    return losses


def decisions(sage: AutoSage, ops=("spmm", "spmm_bwd_b")) -> dict:
    """cache key -> choice of every cached decision of ``ops``."""
    return {k: sage.cache.get(k)["choice"] for op in ops for k in sage.cache.keys_for_op(op)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--cache", default="", help="schedule cache path; empty = in memory")
    args = ap.parse_args(argv)

    classes, in_dim = 16, 64
    graph = reddit_like(scale=args.scale)
    feats, labels = make_data(graph, classes, in_dim)
    sage = AutoSage(cache=ScheduleCache(path=args.cache or None), device=args.device)
    device = sage.device
    model = SAGE(in_dim, classes, seed=0, device=device)
    x, y = torch.from_numpy(feats).to(device), torch.from_numpy(labels).to(device)
    train_full(model, graph, x, y, sage=sage, epochs=args.epochs)
    for key, choice in decisions(sage).items():
        _, _, f, op, _ = key.split("|")
        print(f"{op} {f}: {choice}")
    print(f"csr transposes built={TRANSPOSE_STATS['built']} reused={TRANSPOSE_STATS['hits']}")


if __name__ == "__main__":
    main()
