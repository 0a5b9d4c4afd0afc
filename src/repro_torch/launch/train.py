"""End-to-end LLM training launcher with fault tolerance (port of
repro/launch/train.py):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_14b \\
        --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir ckpt/

It trains on the card unless ``--device cpu`` is given. Weights are
drawn from ``--seed`` by a torch generator (fp32, as the JAX launcher
trains), batches from (seed, step) by `data.synthetic.token_batch`, so
a resumed run sees the batches an uninterrupted one would.
  * periodic atomic checkpoints (weights, AdamW state and the data
    pipeline's state), the last three kept
  * auto-resume from the latest committed checkpoint
  * a simulated crash (--crash-at N, exit code 17) to show recovery
  * batches made by a double-buffered host prefetcher, so a slow host
    step overlaps the device's work

Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`` each rank joins the process group (nccl
where every local rank has a card of its own, else gloo), builds
`make_host_mesh` (1, N, 1) and trains data-parallel, MoE experts split
over 'data' (expert parallelism): every rank draws the same weights and
global batch, keeps its slices and rows, and rank 0 alone logs and
writes checkpoints. A checkpoint from any world size resumes on any
other. Without torch.distributed.run it trains on one device.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.core.features import resolve_device
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import PipelineState, token_batch
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step, shard_state

CRASH_EXIT = 17  # the simulated crash's exit code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=-1, help="simulate failure at step N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    mesh = None
    if collectives.launched():
        mesh = make_host_mesh(args.device)
        dev = collectives.rank_device(args.device)
    else:
        dev = resolve_device(args.device)
    lead = collectives.rank() == 0

    def log(msg):
        if lead:
            print(msg, flush=True)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5))
    step_fn = make_train_step(cfg, opt_cfg, device=dev, mesh=mesh)

    state = init_train_state(cfg, args.seed, torch.float32, device=dev)
    if mesh is not None:
        state = shard_state(state, cfg, mesh)
    pipe = PipelineState(seed=args.seed, step=0)

    # ---- auto-resume ------------------------------------------------
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt_mod.restore(state, args.ckpt_dir, device=dev, mesh=mesh)
        pipe = PipelineState(**extra["pipeline"])
        log(f"[train] resumed from step {int(state.step)}")

    start = int(state.step)
    t0 = time.time()
    prefetch = Prefetcher(
        lambda s: token_batch(cfg, args.batch, args.seq, PipelineState(pipe.seed, s)),
        start_step=pipe.step,
        depth=2,
    )
    try:
        for step in range(start, args.steps):
            if step == args.crash_at:
                log(f"[train] simulating crash at step {step}")
                return CRASH_EXIT
            pipe.step, batch = next(prefetch)
            pipe.step += 1
            state, metrics = step_fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                log(
                    f"[train] step={step} loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"({(time.time() - t0):.1f}s)"
                )
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt_mod.save(state, args.ckpt_dir, step + 1,
                              extra={"pipeline": {"seed": pipe.seed, "step": pipe.step}},
                              mesh=mesh)
                if lead:
                    ckpt_mod.prune_old(args.ckpt_dir, keep=3)
    finally:
        prefetch.close()
    if args.ckpt_dir:
        ckpt_mod.save(state, args.ckpt_dir, args.steps,
                      extra={"pipeline": {"seed": pipe.seed, "step": pipe.step}}, mesh=mesh)
    log(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    # under torch.distributed.run, a failing rank's traceback goes into
    # the launcher's failure summary
    from torch.distributed.elastic.multiprocessing.errors import record

    rc = record(main)()
    collectives.finish()
    sys.exit(rc)
