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
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

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

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5))
    step_fn = make_train_step(cfg, opt_cfg, device=dev)

    state = init_train_state(cfg, args.seed, torch.float32, device=dev)
    pipe = PipelineState(seed=args.seed, step=0)

    # ---- auto-resume ------------------------------------------------
    if args.ckpt_dir and ckpt_mod.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt_mod.restore(state, args.ckpt_dir, device=dev)
        pipe = PipelineState(**extra["pipeline"])
        print(f"[train] resumed from step {int(state.step)}", flush=True)

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
                print(f"[train] simulating crash at step {step}", flush=True)
                return CRASH_EXIT
            pipe.step, batch = next(prefetch)
            pipe.step += 1
            state, metrics = step_fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(
                    f"[train] step={step} loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"({(time.time() - t0):.1f}s)",
                    flush=True,
                )
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt_mod.save(state, args.ckpt_dir, step + 1,
                              extra={"pipeline": {"seed": pipe.seed, "step": pipe.step}})
                ckpt_mod.prune_old(args.ckpt_dir, keep=3)
    finally:
        prefetch.close()
    if args.ckpt_dir:
        ckpt_mod.save(state, args.ckpt_dir, args.steps,
                      extra={"pipeline": {"seed": pipe.seed, "step": pipe.step}})
    print(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
