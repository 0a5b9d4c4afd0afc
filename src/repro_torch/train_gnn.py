"""GraphSAGE training on a synthetic Reddit-shaped graph, with every
forward and backward aggregation scheduled.

Port of examples/train_gnn.py's ``make_data``, ``train_full``,
``train_minibatch`` and ``train_fleet``:

    PYTHONPATH=src python -m repro_torch.train_gnn --epochs 30 --scale 0.01
    PYTHONPATH=src python -m repro_torch.train_gnn --device cpu --epochs 3
    PYTHONPATH=src python -m repro_torch.train_gnn --minibatch 1024 \
        --probe-budget-ms 2000 --epochs 1 --scale 0.25
    PYTHONPATH=src python -m repro_torch.train_gnn --workers 2 \
        --minibatch 1024 --epochs 1 --scale 0.05 --cache fleet.json

Full-graph training runs the forward SpMMs ("spmm") and their backward
("spmm_bwd_b" on the memoized transpose) as scheduled decisions of one
`AutoSage` with their own cache keys; the first step decides and
prepares, later steps replay from the cache and the runner memo.
Minibatch training samples a sorted set of rows per step and trains on
their rectangular sub-adjacency (`SAGE.minibatch_forward`): one
`BatchScheduler` serves the whole stream, every subgraph's decisions
bucketed under one probe budget, and each step's wall time (synchronized
on a CUDA device) feeds `observe`. Plain SGD (lr 0.05) on the mean
log-softmax negative log-likelihood, as in the JAX example.

Fleet mode (``--workers N``) spawns N subprocess minibatch trainers
against ONE schedule cache (``--cache``, merge-on-flush under its
lockfile, AUTOSAGE_CACHE_SHARED=1): each opens the buckets its peers
probed warm (`ScheduleCache.maybe_reload`) and re-probes buckets whose
observed runtime drifts. Worker w samples its row sets with seed 1 + w,
runs on ``--device`` (the card by default) and writes its stream stats,
with its process's fault and fallback counts, to a JSON file; the parent
prints their sum and then one JSON line ``{"workers": [...], "cache":
...}``. All workers start at once, as in the JAX example.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache
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


def minibatch_rows(n_rows: int, minibatch: int, n_steps: int, seed: int = 1
                   ) -> List[np.ndarray]:
    """The sorted row sets of ``n_steps`` minibatch steps: the JAX
    example's sequence for the same seed (its worker 0 uses seed 1)."""
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(n_rows, size=minibatch, replace=False))
            for _ in range(n_steps)]


def minibatch_step(model: SAGE, graph: CSR, x: torch.Tensor, y: torch.Tensor,
                   rows: np.ndarray, sage=None, lr: float = LR,
                   update: bool = True) -> Tuple[float, float]:
    """One minibatch SGD step on ``rows`` (without the update when not
    ``update``: loss and gradients only). A `BatchScheduler` given as
    ``sage`` gets the step's wall time through ``observe`` for the
    bucket of the step's last decide. Returns (loss, step ms)."""
    sub = graph.row_slice(rows)
    yb = y[torch.from_numpy(rows.astype(np.int64)).to(y.device)]

    def loss_fn():
        return nll_loss(model.minibatch_forward(sub, rows, x, sage=sage), yb)

    t0 = time.perf_counter()
    if update:
        loss = sgd_step(model, loss_fn, lr)
    else:
        model.zero_grad(set_to_none=True)
        out = loss_fn()
        out.backward()
        loss = float(out.detach())
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    step_ms = (time.perf_counter() - t0) * 1e3
    if isinstance(sage, BatchScheduler):
        sage.observe(sage.last_bucket, step_ms)
    return loss, step_ms


def train_minibatch(model: SAGE, graph: CSR, x: torch.Tensor, y: torch.Tensor,
                    bs: BatchScheduler, minibatch: int, epochs: int = 1,
                    lr: float = LR, seed: int = 1,
                    log: Callable[[str], None] = print) -> List[float]:
    """Sampled-subgraph SGD, n_rows // minibatch steps per epoch, through
    one `BatchScheduler`; finalizes it at the end (every bucket decision
    pinned into its cache). Returns the loss of every step."""
    steps = max(1, graph.n_rows // minibatch)
    rows = minibatch_rows(graph.n_rows, minibatch, steps * epochs, seed)
    losses: List[float] = []
    t0 = time.time()
    with bs:
        for epoch in range(epochs):
            for r in rows[epoch * steps:(epoch + 1) * steps]:
                losses.append(minibatch_step(model, graph, x, y, r, bs, lr)[0])
            log(f"epoch {epoch:3d} loss {np.mean(losses[-steps:]):.4f} "
                f"({time.time() - t0:.1f}s)  stream={bs.stats()}")
    return losses


def train_fleet(args) -> list:
    """Spawn ``args.workers`` subprocess minibatch trainers against one
    shared schedule cache; returns their stats dicts (worker order).
    Raises SystemExit if a worker fails."""
    cache = os.path.abspath(args.cache or "fleet_cache.json")
    procs, stats_paths = [], []
    for w in range(args.workers):
        stats_path = f"{cache}.worker{w}.stats.json"
        stats_paths.append(stats_path)
        cmd = [
            sys.executable, "-m", "repro_torch.train_gnn",
            "--minibatch", str(args.minibatch), "--epochs", str(args.epochs),
            "--scale", str(args.scale), "--cache", cache, "--shared",
            "--probe-budget-ms", str(args.probe_budget_ms),
            "--worker-id", str(w), "--stats-json", stats_path,
        ]
        if args.device:
            cmd += ["--device", args.device]
        env = {**os.environ, "AUTOSAGE_CACHE_SHARED": "1"}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"worker exit codes: {rcs}")
    stats = []
    for sp in stats_paths:
        with open(sp) as fh:
            stats.append(json.load(fh))
        os.unlink(sp)
    totals = {k: sum(s.get(k, 0) for s in stats)
              for k in ("decides", "probes_run", "warm_cache_opens", "drift_reprobes",
                        "drift_flips")}
    print(f"fleet of {args.workers}: {totals['decides']} decides, "
          f"{totals['probes_run']} probes total, {totals['warm_cache_opens']} buckets "
          f"opened warm from peers, {totals['drift_reprobes']} drift re-probes "
          f"({totals['drift_flips']} flipped); merged cache: {cache}")
    print(json.dumps({"workers": stats, "cache": cache}, sort_keys=True), flush=True)
    return stats


def decisions(sage: AutoSage, ops=("spmm", "spmm_bwd_b")) -> dict:
    """cache key -> choice of every cached decision of ``ops``."""
    return {k: sage.cache.get(k)["choice"] for op in ops for k in sage.cache.keys_for_op(op)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--cache", default="", help="schedule cache path; empty = in memory")
    ap.add_argument("--minibatch", type=int, default=0,
                    help="rows per sampled subgraph; 0 = full-graph training")
    ap.add_argument("--probe-budget-ms", type=float, default=2000.0,
                    help="shared probe budget for the minibatch stream")
    ap.add_argument("--workers", type=int, default=0,
                    help="fleet mode: N subprocess trainers against one shared "
                         "cache (implies --minibatch 1024 unless given)")
    ap.add_argument("--shared", action="store_true",
                    help="merge-on-flush shared cache (set in fleet workers)")
    ap.add_argument("--worker-id", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--stats-json", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.workers:
        args.minibatch = args.minibatch or 1024
        train_fleet(args)
        return

    classes, in_dim = 16, 64
    graph = reddit_like(scale=args.scale)
    feats, labels = make_data(graph, classes, in_dim)
    cache = ScheduleCache(path=args.cache or None, shared=args.shared or None)
    if args.minibatch:
        sage = AutoSage(cache=cache, device=args.device, probe_iters=2,
                        probe_cap_ms=200, probe_frac=0.25)
    else:
        sage = AutoSage(cache=cache, device=args.device)
    device = sage.device
    model = SAGE(in_dim, classes, seed=0, device=device)
    x, y = torch.from_numpy(feats).to(device), torch.from_numpy(labels).to(device)
    if args.minibatch:
        bs = BatchScheduler(sage, probe_budget_ms=args.probe_budget_ms)
        train_minibatch(model, graph, x, y, bs, args.minibatch, epochs=args.epochs,
                        seed=1 + args.worker_id)
        s = bs.stats()
        if args.stats_json:
            from repro_torch.core import obs

            with open(args.stats_json, "w") as fh:
                json.dump({**s, **{name: obs.REGISTRY.total(name) for name in
                                   ("autosage_faults_total", "autosage_fallback_total")}},
                          fh)
        print(f"batched decide: {s['decides']} decides -> {s['buckets']} buckets, "
              f"{s['probes_run']} probes ({s['probes_avoided']} avoided, "
              f"{s['warm_cache_opens']} opened warm from the cache), drift: "
              f"{s['drift_flags']} flags / {s['drift_reprobes']} re-probes / "
              f"{s['drift_flips']} flips, probe budget spent "
              f"{s['probe_spent_ms']:.0f}/{s['probe_budget_ms']:.0f}ms")
        for row in bs.bucket_stats():
            print(f"  bucket {row['op']} {row['bucket']}: hits={row['hits']} "
                  f"choice={row['choice']}")
        return
    train_full(model, graph, x, y, sage=sage, epochs=args.epochs)
    for key, choice in decisions(sage).items():
        _, _, f, op, _ = key.split("|")
        print(f"{op} {f}: {choice}")
    print(f"csr transposes built={TRANSPOSE_STATS['built']} reused={TRANSPOSE_STATS['hits']}")


if __name__ == "__main__":
    main()
