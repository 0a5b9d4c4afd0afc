#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an H100, the CUDA toolkit
(nvcc) and PyTorch built for CUDA. No arguments, no network. Phases, in
order; any failure raises and the script exits non-zero:

1. Environment: the card's name and power limit, torch/CUDA versions,
   TF32 off, and the build of every kernel source (one nvcc per source,
   started together) with its time and ptxas report.
2. SpMM kernels against their plain versions, at the SpMM slice's shapes
   (Reddit-0.25: the normalized adjacency of reddit_like(0.25, seed=0),
   F = 256 and 41) and on edge cases (row blocks with only the dummy
   slot, explicit-zero edges, a single hub spanning many merge tiles, a
   partial last tile, tile_slots 3/8/16, merge runs of one tile and of
   many, every blocking, F = 41, 256 and 602), and on the inf/NaN trap:
   B holding +-inf and NaN in rows that tiles pair only with zero values,
   where the kernels must match the CSR product ref.spmm_ref (the plain
   versions, like the Pallas kernels, give NaN there). At Reddit-0.25 every blocking
   the registry offers (8x8, 16x8, 8x16) is checked and timed, since
   decide may pick any of them. Tolerance: |kernel - plain| <=
   1e-4 * |plain| + 1e-4 * max|plain| — both sum the same fp32 products
   in another order. Dense-W must equal ragged bit for bit, and two
   merge-path launches must give the same bits. Times (CUDA events,
   median after a warm-up, by the probe's own timer
   core.probe.time_callable) of each kernel, its plain version and
   torch.sparse.mm on the same CSR product (a yardstick the port never
   calls), beside the bound: the
   larger of the bytes one call must move (each array of its layout
   read once, B read once, C written once) over the HBM rate and the
   product's 2 * nnz * F FLOPs over the fp32 peak.
3. SpMM main path: GraphSAGE (configs/gnn_sage: 3 layers, width 256)
   with Reddit's input width 602 and 41 classes, random weights and
   features from seed 0, forward under torch.no_grad through AutoSage on
   the card: decide per layer width (features -> estimate -> shortlist
   -> probe -> guardrail -> cache), logits held against the torch
   reference path (sage=None) on the card, then a fresh replay-only
   AutoSage must replay the same choices.
4. Each SpMM kernel family inside the model: ragged_ell_cuda,
   block_ell_cuda, merge_path_cuda and hub_ragged_cuda pinned in turn
   through the schedule cache (the replay path users rely on); each
   forward must launch its kernel and match the reference logits.
5. Attention kernels against their plain versions, on edge cases (row
   blocks with only the dummy slot, rows without edges inside non-empty
   row blocks, one hub over 2048 slots, a deduplicated hub_skew graph,
   block-diagonal cliques whose tiles are fully live; D = 41, 64, 256
   and 602, the first and last not 16-byte aligned; logits rising by ~40
   along each row, so later slots raise a row's max and the rescale
   carries the result), on the inf/NaN trap (v holding +-inf and NaN in
   rows that tiles pair only with masked cells, where the kernels must
   match the CSR oracle ref.csr_attention_ref; the plain versions, like
   the Pallas kernels, give NaN there), and at the attention slice's
   shapes (reddit_like(0.25, seed=0).dedup_edges(), D = 256), same
   tolerance (an online softmax against the plain version's two-pass
   one); dense-W must equal ragged bit for bit, a second launch must
   give the same bits and rows without edges must be 0. Times of each
   kernel and its plain version beside the bound (the mask tiles and
   index arrays read once, q, k, v read once, out written once;
   4 * nnz * D FLOPs); of the library composition
   torch.sparse.sampled_addmm -> torch.sparse.softmax -> torch.sparse.mm
   (``library_pipe_ms``, held against the plain version on rows with
   edges; the port never calls it); and of the composed CSR pipeline
   (gather SDDMM -> row softmax -> gather SpMM), the guardrail's
   baseline (``baseline_pipe_ms``). No single PyTorch call computes CSR
   attention, so ``library_ms`` is null. HardwareSpec.attn_step_s fitted
   against estimate.py's terms, with both fused estimates. Then both
   kernels in the wrappers' chunks and unsplit (the measurement behind
   kernels/attention.py's chunks).
6. Attention main path: a GAT layer (configs/gnn_sage width 256, input
   width 602) with seeded random weights and features on the
   deduplicated Reddit-0.25 graph, forward under torch.no_grad through
   AutoSage.decide_attention (features -> estimate -> shortlist -> probe
   -> guardrail -> cache), held against the sage=None reference on the
   card; a fresh replay-only AutoSage replays the choice; then
   fused_attention_cuda and ragged_attention_cuda are pinned in turn
   through the cache, each forward must launch its kernel and match the
   reference, and the two outputs must be equal bit for bit.

7. SDDMM kernels against their plain versions, on edge cases (row blocks
   with only the dummy slot, explicit-zero edges, a hub over many merge
   tiles, partial last merge tiles, block-diagonal cliques whose tiles
   are fully live; F = 16, 41, 256 and 602; X and Y holding -0.0 in
   whole rows, whose live cells must read +0.0; Y holding +-inf and NaN
   in rows that only masked cells pair with, which must stay +0.0) and
   at the training slice's shapes (the deduplicated Reddit-0.25 graph,
   D = 256, phase 5's 8x8 mask tables plus a 16x8 blocking; merge
   tile_slots 8 and 16), same tolerance. Live tiles are equal bit for
   bit across dense-W, ragged and merge; padded, dummy, tail and masked
   cells are +0.0 and no -0.0 appears; a second launch gives the same
   bits. Times of each kernel, its plain version,
   torch.sparse.sampled_addmm on the same pattern (the one PyTorch call
   that computes the same function; the port never calls it) and the
   guardrail's SDDMM baseline gather_dot (``baseline_ms``) beside the
   bound (the mask tiles and index arrays read once, X and Y read once,
   the tiles written once; 2 * nnz * D FLOPs).
8. SAGE training: three full-graph SGD steps (train_gnn.train_full's
   step: lr 0.05, mean log-softmax NLL) of the phase-3 model on
   Reddit-0.25 with train_gnn.make_data's features and labels, through
   AutoSage: the first step decides spmm and spmm_bwd_b at F = 256 and
   F = 41, and its weight gradients are held against the sage=None
   reference (the explicit backward oracles) on the card within
   1e-3 * |ref| + 1e-3 * max|ref|. A fresh replay-only AutoSage replays
   the four decisions and gives the same gradients bit for bit.
9. GAT training: the phase-6 layer, loss 0.5 * ||out||^2, SGD at
   lr 0.05 / n_rows (the loss sums over every node). The first step's
   wq, wk and wv gradients are held against the sage=None reference
   (csr_attention_bwd_ref, chunked) on the card, then two more SGD
   steps; a replay-only AutoSage replays all six decisions
   (attention and attention_bwd_e/_p/_q/_k/_v) with bit-equal
   gradients. Then the SDDMM families are pinned in turn for
   attention_bwd_e/_p through the cache (ragged and merge-path on
   Reddit-0.25; dense-W, which its memory gate shuts out there, on
   products_like(0.02, seed=0).dedup_edges() in a leg of its own): each
   pinned step must launch its kernel and match the reference.

10. The kernel-level entry point (kernels/ops.py) at full size, on the
   deduplicated Reddit-0.25 graph, D = 256, 8x8 (nrb = W = 7,281): the
   paper's composed pipeline from three hand kernels,
   ops.sddmm(impl="cuda") -> logits / sqrt(D) -> ops.row_softmax ->
   the dense-W SpMM kernel over the probability tiles with B = v, held
   against ops.csr_attention(impl="cuda") (the fused kernel); the row
   softmax kernel against its plain version (chunked), padded tiles
   +0.0, a second launch bit-equal, and the probabilities gathered back
   to CSR order against baselines.row_softmax on the CSR logits; times
   of the kernel, its plain version and torch.sparse.softmax on a COO
   tensor of the real edges' logits (the one PyTorch call that computes
   the same function; the port never calls it) beside the bound (logits
   and mask read once, probabilities written once). On small graphs:
   ops.spmm ("cuda", "ragged") and ops.csr_attention("ragged") against
   impl="ref", and the row softmax kernel on its traps at 8x8, 16x8 and
   8x16 (masked rows and row blocks, NaN/inf on masked cells, logits x5
   and +-80, a row of finfo.min logits, mask values -1/0.5/2; W = 1, 3
   and 2048).
11. Minibatch SAGE training through BatchScheduler, at full width: the
   phase-3 model on train_gnn.make_data's Reddit-0.25 data, one epoch of
   56 steps of 1,024 sampled rows (train_gnn.minibatch_rows, seed 1)
   through one BatchScheduler (probe budget 2,000 ms; AutoSage with
   probe_iters 2, probe_cap_ms 200, probe_frac 0.25), each step's
   synchronized wall time fed to observe, finalize() pinning the bucket
   decisions; step 1's gradients against the sage=None reference within
   1e-3 * |ref| + 1e-3 * max|ref|. A replay-only BatchScheduler replays
   every decision of the 56 row sets and gives step-1 gradients bit-equal
   to the deciding scheduler's. Then ragged_ell_cuda and merge_path_cuda
   are pinned in turn through the bucket entries of spmm and spmm_bwd_b
   for 3 steps each (each step launches its kernel and matches the
   reference), and a drift leg runs regime_shift_stream(64, 1024,
   seed=0) at F = 256 with every scheduled aggregation timed by CUDA
   events and fed to observe (re-probes <= flags; no probe starts once
   the budget is spent).
12. Fleet and cross-device, at full width (F = D = 256):
   a. Fault injection through the resilience chain: ragged_ell_cuda
      pinned for spmm on the Reddit-0.25 normalized graph, then
      AUTOSAGE_FAULT run faults on it (retries 0, AUTOSAGE_BREAKER_N 3):
      each faulted call serves the baseline, autosage_faults_total and
      autosage_fallback_total rise by exactly the injected count, the
      kernel does not launch, the output matches the reference; the
      candidate is quarantined with its quarantine| record in the cache
      file, a fresh AutoSage leaves it out of its shortlist, a
      replay-only one raises ReplayMiss on the pin; after a short
      AUTOSAGE_QUARANTINE_TTL_S the half-open call launches the kernel
      again and clears the record. Then the first probe of a cold decide
      hangs (AUTOSAGE_FAULT_HANG_S above AUTOSAGE_PROBE_TIMEOUT_S): the
      watchdog abandons it and decide returns.
   b. The legacy "csr_attention" op on the deduplicated Reddit-0.25
      graph, D = 256: decide gives the baseline, as the JAX package
      does, and its output matches ref.csr_attention_ref; a legacy-key
      entry pinned to ragged_attention_cuda replays the fused kernel
      within the tolerance.
   c. Decision transfer: the port on the CPU (device='cpu', kernel
      families included) probes spmm on products_like(0.02) into a
      cache file; the card decides the same key on that file with the
      transfer tier on, then on a copy with AUTOSAGE_TRANSFER=0. Tier,
      probe passes, predicted ms against the card's probe and the cold
      decide times are printed; outputs match the reference, and a
      confident transfer runs no probe.
   d. Fleet: `python -m repro_torch.train_gnn --workers 2 --shared
      --minibatch 1024` at reddit_like(0.05) on one shared
      cache, then one worker alone on a fresh cache: both exit 0, the
      merged file loads in a third process, the fleet opens buckets
      warm, its probes stay below twice the lone worker's, and no worker
      falls back.
   Phases 3 and 6 also time the warm SAGE and GAT forwards through two
   replay-only AutoSage instances built with AUTOSAGE_RESILIENCE=0 (raw
   runners) and =1 (the chain), side by side, outside the counted runs.
13. Serving (launch/serve.py), with AUTOSAGE_OBS=1 and AUTOSAGE_OBS_DIR
   and AUTOSAGE_TELEMETRY_DIR in the phase's directory (restored after
   it); the metrics registry is cleared first, so its counters are phase
   13's alone:
   a. benchmarks/tables.py serve_smoke's contract at F = 256: its four
      parent regimes (launch.serve._serve_parents(2048, 4)), 48 sampled
      subgraphs of 256 rows, 3 client threads, 2 passes,
      AUTOSAGE_SERVE_BUDGET_MS=250, AutoSage(probe_iters=1,
      probe_cap_ms=25, probe_frac=0.25), BatchScheduler(probe_budget_ms=
      10,000) behind a GNNServer whose background worker probes; then a
      replay-only server over the same stream. Gates: no stall and no
      cold request, p99 decision latency under the budget, at least one
      upgrade and one bucket provisional in pass 1 and warm in pass 2;
      the replay runs no probe, serves every request warm, and each
      choice equals the bucket's final one.
   b. Full width: four client threads, two passes and a replay pass of
      40 requests each: 16 SpMM requests on 1,024-row sub-adjacencies of
      Reddit-0.25 (train_gnn.minibatch_rows, seed 1, normalized as phase
      11's), 16 on products_like(0.02) (seed 2), both at F = 256 with one
      shared B each, and 8 attention requests on
      sliding_window_csr(16384, 16384, W, n_global=4), W = 256 and 512,
      four each, D = 128 (configs/qwen3_14b's head dimension). Each
      client submits, runs the served decision on the request's operands
      and the output is held against ref.spmm_ref / ref.csr_attention_ref
      (same tolerance); the replay's outputs equal pass 2's bit for bit
      where the choice is the same. Logged: tiers, decision latency
      percentiles against the default 50 ms budget (measured, not
      gated), upgrades, each bucket's final choice and probe ms, the
      launches of each pass. Gates: no stall, no cold request, the serve
      probe-error and upgrade-callback-error counters, faults and
      fallbacks all 0, the replay probe-free and warm, and at least one
      bucket upgraded to a CUDA kernel family whose kernel launched in
      pass 2.
   c. obs.flush() writes spans.jsonl, trace_<pid>.json and
      metrics_<pid>.{prom,json}; `python -m repro_torch.obs_cli
      export-trace` merges them into one Chrome trace holding decide,
      probe and run spans; `obs_cli summary` prints the serve counters;
      `obs_cli explain` prints an attention bucket's narrative; and
      serve_events.jsonl holds one request record per request served, at
      least one upgrade and one summary.
14. LLM serving (models/api.py, train/step.py, demo-lm), fp32, TF32 off;
   no hand-written kernel is on this path (the JAX LLM stack reaches no
   Pallas kernel), so it adds no launches and no kernels record:
   a. configs/qwen3_14b at its published widths, cut to 4 of 40 layers,
      weights drawn on the card from a seeded generator: api.prefill of
      8 x 1,024 random tokens (cold, then warm on a fresh cache), then
      32 greedy api.decode_steps into a cache of 1,056. Every step's
      logits equal api.forward over the prompt and the tokens so far
      (teacher forcing) within LM_RTOL; a REPRO_ATTN=chunked prefill of
      2 x 2,048 (two query chunks) equals the naive one (logits and
      every k/v row). Printed: prefill ms against its FLOP bound, decode
      ms/step and tokens/s against the step's byte bound, and a
      torch.profiler window of 8 decode steps (kernel time, the
      device's busy share, the top kernels).
   b. The long_500k shape (batch 1, a 524,288-position fp32 cache) at
      full width, cut to 2 layers; the cache is filled from a seeded
      generator to pos 524,272 (a prefill of 524 k tokens is O(S.L)),
      then 16 decode_step(long_ctx=True) calls, each held against a
      plain evaluation over the whole cache with the band's mask (the
      sinks unmasked, the window less the sinks). The band step and the
      full-cache step (long_ctx=False) at pos 524,272 are timed with
      CUDA events (band, full, full, band) and profiled. A short leg
      prefills 4,352 tokens, so that the window of 4,096 slides past the
      128 sinks, then takes 8 band steps against the same evaluation.
   c. The nine other LM configs at reduced(): prefill, 4 decode and 2
      long_ctx steps on the card against the port's CPU run from the
      same weights (RTOL); then `python -m repro_torch.launch.serve
      demo-lm --arch qwen3_14b --reduced --long-ctx` as a process, which
      runs on the card by default and must exit 0.
   Peak device memory is printed per leg.
15. LLM training (train/loss.py, optim/adamw.py, train/step.py,
   data/, checkpoint/ckpt.py, launch/train.py), fp32, TF32 off; like
   phase 14 it reaches no hand-written kernel (the JAX training path
   reaches no Pallas kernel), so it adds no launches and no record:
   a. configs/qwen3_14b at its published widths, cut to 4 of 40 layers,
      weights drawn on the card from a seeded generator: 6 steps of
      make_train_step (AdamW at lr 3e-4, the launcher's warmup) on
      token_batch batches of 8 x 256 (seed 0). Printed per step: ms
      (host clock after a sync), tokens/s, loss, grad norm, lr and
      AdamW's ms (CUDA events around its update); then the warm step
      against its bound (matrix and attention FLOPs with remat's second
      forward / 67 TFLOP/s, plus AdamW's 7 passes over the weights'
      bytes / 3.35 TB/s), AdamW's share, the loss trend and the peak
      memory. Fails on a non-finite loss or grad norm.
   b. The ten LM configs at reduced(): the same weights and batch (2 x
      32) on the CPU and, carried over by train_state_to_numpy /
      train_state_from_jax, on the card; one train step (AdamW lr 1e-4)
      and one eval step each, loss, nll, z_loss, grad norm, lr, weights,
      m and v within 1e-4 of max |ref| (a weight whose gradient is below
      1e-4 of its leaf's max within 2 lr: AdamW's first step moves it by
      lr * g / (|g| + eps), ~lr of either sign). Then 60 steps of reduced
      qwen3_14b at lr 3e-3 (4 x 64) on the card: the mean loss of the
      last 5 steps at least 0.2 below the first 5's.
   c. `python -m repro_torch.launch.train --arch qwen3_14b --reduced
      --steps 30 --batch 2 --seq 32 --ckpt-every 10` as a process (the
      card by default) with --crash-at 25: exit 17, step 20 committed;
      again without it: "resumed from step 20", exit 0, step 30
      committed; its arrays within 1e-6 of max |ref| of an
      uninterrupted run's (launch.train.main in-process). **Cut:**
      reduced size, since a full-width checkpoint is 46 GB.
16. The multi-device paths (distributed/, launch/mesh.py,
   optim/compress.py, the EP MoE, the sharded CSR window attention, the
   steps and launchers on a mesh), 4 ranks sharing the one card over
   gloo (fewer cards than local ranks), fp32 (TF32 off); no hand-written
   kernel is on these paths. a-c run in one `python -m
   torch.distributed.run --nproc-per-node 4 chip_smoke.py --mesh-legs
   DIR` process group, each leg printing its times, errors and every
   rank's peak memory:
   a. One MoE layer of configs/qwen3_moe_235b_a22b at its published
      widths (d_model 4096, 128 experts, top-8, d_expert 1536), experts
      drawn per expert from seeded generators, on mesh (1, 2, 2): each
      rank holds 64 experts x half the hidden width (2.42 GB) and 4 x
      512 of the 8 x 512 tokens. Capacity factor 2 (the 'data' size, so
      nothing drops): the output and dx within RTOL / 1e-3 of max |ref|
      of moe_ffn_ref over the whole experts (9.66 GB, rank 0), each
      slice's gradient of sum(out * r) within 1e-3 of a plain loop over
      the rank's experts. Then the default capacity factor (1.25) with
      every token routed to data rank 0's experts: the card within RTOL
      of the same ranks on the CPU, the drop counts equal.
   b. csr_window_attention_sharded at configs/qwen3_14b's widths over
      the long_500k cache (batch 1, 524,288 positions, bf16, filled from
      seeded generators) in 4 slices of 131,072: decode at pos 524,272
      and at 262,144 (a slice's first row) within RTOL of
      csr_window_attention over the whole cache on rank 0 (its values in
      fp32, so that path's probabilities are not rounded to bf16; the
      sharded path rounds the new token's k/v row to the cache's bf16,
      which the output, an average of ~4,200 random rows, shows at
      ~5e-5 of its max); only the owning slice writes its row; the
      step's time.
   c. compressed_psum over 'pod' on (4, 1, 1), one 5120 x 17408 fp32
      tensor (Qwen3-14B's w_up) per rank: err1 after one reduction, the
      drift after 20 with error feedback, which must be below err1 / 2.
   d. `python -m torch.distributed.run --nproc-per-node 4 -m
      repro_torch.launch.train --arch qwen3_moe_235b_a22b --reduced
      --steps 8 --ckpt-every 2 --crash-at 5`, resumed with 2 ranks;
      the final loss within 1e-4 (as printed) of a one-rank run's
      (REPRO_MOE_CF=8 in all three), its moments within 1e-4 of max
      |ref| and its weights within 2 lr per step (AdamW's first steps
      move a weight whose gradient is at rounding level by ~lr of either
      sign).
      **Cut:** reduced widths (four replicated full-width states would
      not fit on one card).
   e. `demo-lm --arch qwen3_14b --reduced --long-ctx` with
      REPRO_LONG_ATTN=sharded on 4 ranks: rank 0's greedy tokens equal a
      one-rank run's.

The main path is every forward of phases 3, 4 and 6, every training
step of phases 8, 9 and 11, the ops chain of phase 10, the runner
calls of phases 12a-c and the served runs of phase 13b (background
probes included), through the entry points a user calls: decide
(probes included) + two forwards or the training steps, the replay run,
and each pinned run. The launch counters of every kernel are set to 0
just before each of these runs and read just after it; a kernel's
``launches`` is the sum over them, and every kernel must have launched.
Resilience is on (the default) throughout: after each of phases 2-11
and 13 the smoke reads autosage_faults_total and autosage_fallback_total
and fails unless both are 0, so no kernel of the main path hid behind a
fallback. The host/device breakdown of a warm forward is timed outside
these runs and is not counted. Peak device memory is printed per phase.
The second-to-last line is the kernels JSON, the last line the result
JSON.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
IN_DIM, N_CLASSES = 602, 41  # Reddit's feature width and class count
SCALE = 0.25  # reddit_like node count: a quarter of Reddit's 232,965
RTOL = 1e-4  # fp32 sums in another order
# single_hub rows for the edge cases: the hub owns 2048 slots (256 merge
# tiles at tile_slots 8), so its carry chain spans many runs; with
# MERGE_MAX_RUNS = 64 the runs hold many tiles each
HUB_N = 16384
BLOCKINGS = ((8, 8), (16, 8), (8, 16))  # (rb, bc) the registry offers
REPLACES = {
    "spmm_block_ell": "src/repro/kernels/spmm_pallas.py:79",
    "spmm_ragged_ell": "src/repro/kernels/spmm_pallas.py:128",
    "spmm_merge_path": "src/repro/kernels/spmm_pallas.py:220",
    "fused_csr_attention": "src/repro/kernels/attention_pallas.py:60",
    "fused_ragged_attention": "src/repro/kernels/attention_pallas.py:141",
    "sddmm_block_ell": "src/repro/kernels/sddmm_pallas.py:53",
    "sddmm_ragged_ell": "src/repro/kernels/sddmm_pallas.py:109",
    "sddmm_merge_path": "src/repro/kernels/sddmm_pallas.py:199",
    "row_softmax_block_ell": "src/repro/kernels/softmax_pallas.py:31",
}
# src/repro_torch/csrc/<name>.cu
KERNEL_SOURCES = ("spmm", "attention", "sddmm", "softmax")
GRAD_RTOL = 1e-3  # training gradients: long fp32 chains in another order
LR = 0.05  # train_gnn's SGD step
SDDMM_FAMILY_KERNEL = {
    "ragged_ell_cuda": "sddmm_ragged_ell",
    "merge_path_cuda": "sddmm_merge_path",
    "block_ell_cuda": "sddmm_block_ell",
}
D_ATTN = 256  # configs/gnn_sage width: the GAT layer's head dimension
ATTN_FAMILY_KERNEL = {
    "fused_attention_cuda": "fused_csr_attention",
    "ragged_attention_cuda": "fused_ragged_attention",
}
# the dense-W SDDMM leg of phase 9: OGBN-Products' average degree at a
# node count whose dense-W table its memory gate admits (48,980 nodes)
PRODUCTS_SCALE = 0.02
FAMILIES = ("ragged_ell_cuda", "block_ell_cuda", "merge_path_cuda", "hub_ragged_cuda")
FAMILY_KERNEL = {
    "ragged_ell_cuda": "spmm_ragged_ell",
    "block_ell_cuda": "spmm_block_ell",
    "merge_path_cuda": "spmm_merge_path",
    "hub_ragged_cuda": "spmm_ragged_ell",
}


def log(*args) -> None:
    print(*args, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_close(name, got, want, rtol=RTOL) -> float:
    """Raise unless got ~= want within rtol * |want| + rtol * max|want|;
    returns max |got - want|. Works in chunks of elements, so a 13.6 GB
    tile table needs no full-size temporaries."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.reshape(-1), want.reshape(-1)
    step = 1 << 26
    chunks = range(0, g.numel(), step)
    scale = max((float(w[i:i + step].abs().max()) for i in chunks), default=0.0)
    worst, n_bad = 0.0, 0
    for i in chunks:
        gc, wc = g[i:i + step], w[i:i + step]
        if not bool(torch.isfinite(gc).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = (gc - wc).abs()
        n_bad += int((err > rtol * wc.abs() + rtol * scale).sum())
        worst = max(worst, float(err.max()))
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} entries outside tolerance, max err {worst}")
    return worst


def check_equal(name, a, b) -> None:
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"{name}: not bit-equal, max diff {float((a - b).abs().max())}")


# the resilience layer's counters (core/resilience.py, the JAX names):
# every phase 2-11 must leave both at 0, so no kernel of the main path
# hid behind a fallback
FAULT_COUNTERS = ("autosage_faults_total", "autosage_fallback_total")


def fault_counts() -> dict:
    from repro_torch.core import obs

    return {name: obs.REGISTRY.total(name) for name in FAULT_COUNTERS}


class env:
    """Set (value str) or unset (value None) environment variables for
    the body, restoring the previous values after it."""

    def __init__(self, **kv):
        self.kv, self.old = kv, {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.old[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resilience_ab(label, forward_off, forward_on, device, reps=5) -> None:
    """Warm forwards of one model through two AutoSage instances on the
    same decisions, built and run with AUTOSAGE_RESILIENCE=0 (raw
    runners) and =1 (the fallback chain), alternating; prints the
    medians. Not a counted run."""
    import torch

    times = {"0": [], "1": []}
    with torch.no_grad():
        for i in range(reps + 1):  # the first round builds each runner
            for flag, fn in (("0", forward_off), ("1", forward_on)):
                with env(AUTOSAGE_RESILIENCE=flag):
                    t0 = time.perf_counter()
                    fn()
                    sync(device)
                    if i:
                        times[flag].append(time.perf_counter() - t0)
    log(f"warm {label} forward, AUTOSAGE_RESILIENCE=0 vs 1 ({reps} each, alternating): "
        f"median {statistics.median(times['0']):.4f} s vs "
        f"{statistics.median(times['1']):.4f} s; all {json.dumps(times)}")


def _kernel_modules():
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import sddmm as ksd
    from repro_torch.kernels import softmax as ksm
    from repro_torch.kernels import spmm as ks

    return ks, ka, ksd, ksm


def reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def launches() -> dict:
    return {k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()}


def counted(label, fn, totals, device, grad=False):
    """fn() (under torch.no_grad unless ``grad``) with every launch count
    set to 0 just before it and read just after; the counts join the main
    path's ``totals``. Returns (fn's result, the counts)."""
    import torch

    reset_launches()
    with torch.enable_grad() if grad else torch.no_grad():
        out = fn()
    sync(device)
    got = launches()
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    log(f"launches in {label}: {json.dumps(got)}")
    return out, got


# ------------------------------------------------------------ phase 2
def _layouts(csr, device, rb=8, bc=8, tile_slots=(8,)):
    """Host conversion + upload of the dense-W, ragged and merge layouts."""
    import torch

    from repro_torch.sparse import build_merge_path, csr_to_block_ell

    def up(a):
        return torch.from_numpy(a).to(device)

    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    rag = bell.to_ragged()
    out = {
        "dense": (up(bell.colblk), up(bell.vals)),
        "ragged": (up(rag.blkptr), up(rag.slot_colblk), up(rag.slot_vals)),
        "nrb": bell.n_row_blocks, "width": bell.width, "n_slots": rag.n_slots,
        "merge": {},
    }
    del bell
    if rb == bc == 8:
        for ts in tile_slots:
            mp = build_merge_path(rag, tile_slots=ts)
            out["merge"][ts] = (
                up(mp.blkptr), up(mp.slot_colblk), up(mp.tile_rowblk),
                up(mp.tile_offset), up(mp.tile_vals), mp.n_slots, mp.n_tiles,
            )
    return out


def _run_all(lay, b, n_rows):
    """label -> (kernel name, tile_slots, kernel call, plain call): each
    kernel (wrappers on a CUDA tensor) and its plain version."""
    from repro_torch.kernels import spmm as ks

    out = {}
    colblk, vals = lay["dense"]
    blkptr, slot_colblk, slot_vals = lay["ragged"]
    out["spmm_block_ell"] = (
        "spmm_block_ell", 8,
        lambda: ks.spmm_block_ell(colblk, vals, b, n_rows=n_rows),
        lambda: ks.spmm_block_ell_plain(colblk, vals, b, n_rows=n_rows),
    )
    out["spmm_ragged_ell"] = (
        "spmm_ragged_ell", 8,
        lambda: ks.spmm_ragged_ell(blkptr, slot_colblk, slot_vals, b, n_rows=n_rows),
        lambda: ks.spmm_ragged_ell_plain(blkptr, slot_colblk, slot_vals, b, n_rows=n_rows),
    )
    for ts, m in lay["merge"].items():
        out[f"spmm_merge_path[ts={ts}]"] = (
            "spmm_merge_path", ts,
            lambda m=m: ks.spmm_merge_path(*m[:5], b, m[5], n_rows=n_rows),
            lambda m=m: ks.spmm_merge_path_plain(m[0], m[1], m[4], b, m[5], n_rows=n_rows),
        )
    return out


def check_layouts(tag, csr, lay, b, device) -> dict:
    """Every kernel against its plain version on one graph and B; dense-W
    == ragged bit for bit; merge-path twice bit-equal. Returns max errors."""
    fns = _run_all(lay, b, csr.n_rows)
    errs, outs = {}, {}
    for label, (name, _, kern, plain) in fns.items():
        got = kern()
        sync(device)
        want = plain()
        errs[label] = check_close(f"{tag} {label}", got, want)
        outs[label] = got
        if name == "spmm_merge_path":
            check_equal(f"{tag} {label} run twice", got, kern())
        del want
    check_equal(f"{tag} dense-W vs ragged", outs["spmm_block_ell"], outs["spmm_ragged_ell"])
    return errs


def edge_cases(device) -> None:
    """Small graphs that hit the layouts' corners, at every blocking and
    F = 41, 256 and 602; merge-path also with MERGE_MAX_RUNS = 64, so runs
    hold many tiles and rows straddle them; then the inf/NaN trap."""
    import numpy as np
    import torch

    from repro_torch.kernels import spmm as ks
    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32),
                rng.standard_normal(int(deg.sum())).astype(np.float32), deg.size, 70)
    hub = single_hub(HUB_N, nnz_frac=0.9, seed=1)
    skew = hub_skew(3000, 4, 0.05, 300, seed=2)
    zval = rng.standard_normal(skew.nnz).astype(np.float32)
    zval[::3] = 0.0  # explicit-zero edges: tiles whose real edges hold 0.0
    zeros = CSR(skew.rowptr, skew.colind, zval, skew.n_rows, skew.n_cols)
    cases = (("empty-blocks", empty), ("single-hub", hub), ("hub-skew", skew),
             ("explicit-zeros", zeros))
    default_runs = ks.MERGE_MAX_RUNS
    for tag, csr in cases:
        for rb, bc in BLOCKINGS:
            lay = _layouts(csr, device, rb, bc, tile_slots=(3, 8, 16))
            if rb == bc == 8:
                partial = [ts for ts, m in lay["merge"].items() if m[5] % ts]
                if not partial:
                    raise AssertionError(f"{tag}: no case with a partial last tile")
                if tag == "single-hub" and int((lay["merge"][8][2] == 0).sum()) < 32:
                    raise AssertionError("single-hub: the hub spans too few merge tiles")
            for f in (41, 256, IN_DIM):
                b = torch.randn(csr.n_cols, f, generator=torch.Generator().manual_seed(f)).to(device)
                for max_runs in ((default_runs, 64) if rb == bc == 8 else (default_runs,)):
                    ks.MERGE_MAX_RUNS = max_runs
                    try:
                        check_layouts(f"{tag} rb={rb} bc={bc} F={f} runs<={max_runs}", csr,
                                      lay, b, device)
                    finally:
                        ks.MERGE_MAX_RUNS = default_runs
    log("edge cases: empty row blocks, explicit-zero edges, single hub over many merge "
        "tiles, partial last tiles, tile_slots 3/8/16, merge runs <= 8192 and <= 64, "
        f"blockings 8x8/16x8/8x16 at F=41,256,{IN_DIM}: ok")
    inf_nan_trap(skew, device)


def inf_nan_trap(graph, device) -> None:
    """B holds +inf, -inf and NaN in rows that no edge reads but that share
    a column block with rows that edges do read (graph's column j moved to
    2j: every odd column is unread). The plain versions multiply whole
    tiles and give NaN (0 * inf), as the Pallas kernels do; the kernels
    skip the zeros and must agree with the CSR product (ref.spmm_ref)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.sparse import CSR

    val = graph.val if graph.val is not None else np.ones(graph.nnz, np.float32)
    csr = CSR(graph.rowptr, graph.colind * 2, val, graph.n_rows, 2 * graph.n_cols)
    up = {k: torch.from_numpy(a).to(device) for k, a in
          (("rowptr", csr.rowptr), ("colind", csr.colind), ("val", val))}
    for f in (41, 256):
        b = torch.randn(csr.n_cols, f, generator=torch.Generator().manual_seed(f)).to(device)
        b[1::2] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                               device=device).repeat(csr.n_cols)[: csr.n_cols // 2, None]
        want = ref.spmm_ref(up["rowptr"], up["colind"], up["val"], b)
        if not bool(torch.isfinite(want).all()):
            raise AssertionError("inf/NaN trap: the CSR product is not finite")
        for rb, bc in BLOCKINGS:
            lay = _layouts(csr, device, rb, bc, tile_slots=(8,))
            for label, (_, _, kern, plain) in _run_all(lay, b, csr.n_rows).items():
                check_close(f"inf/NaN trap rb={rb} bc={bc} F={f} {label}", kern(), want)
                if label == "spmm_ragged_ell" and not bool(torch.isnan(plain()).any()):
                    raise AssertionError("inf/NaN trap: the plain version gave no NaN")
    log("inf/NaN trap: B rows paired only with zero tile values hold +-inf/NaN; every "
        "kernel and blocking matches ref.spmm_ref on the CSR (the plain versions give NaN): ok")


def kernel_phase(csr, device, reps: int) -> dict:
    """Phase 2 at the slice's shapes, for every blocking. Returns the
    kernel records (8x8 and tile_slots 8 on top, the other blockings and
    tile_slots 16 under "variants")."""
    import torch

    from repro_torch.core.probe import time_callable
    from repro_torch.kernels import spmm as ks
    from repro_torch.kernels.baselines import prepare_csr, spmm_gather_segsum

    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(csr.rowptr).to(device), torch.from_numpy(csr.colind).to(device),
        torch.from_numpy(csr.val).to(device), size=(csr.n_rows, csr.n_cols),
        check_invariants=False,
    )
    bs = {f: torch.randn(csr.n_cols, f, generator=torch.Generator().manual_seed(f)).to(device)
          for f in (41, 256)}
    f = 256
    lib_ms = time_callable(lambda: torch.sparse.mm(a_lib, bs[f]), device, iters=reps).median_ms
    del a_lib
    records = {}
    for rb, bc in BLOCKINGS:
        t0 = time.perf_counter()
        lay = _layouts(csr, device, rb, bc, tile_slots=(8, 16))
        sync(device)
        log(f"layouts rb={rb} bc={bc}: nrb={lay['nrb']} W={lay['width']} "
            f"slots={lay['n_slots']} ({time.perf_counter() - t0:.1f} s host conversion + upload)")
        errs = {}
        for fb, b in bs.items():
            errs[fb] = check_layouts(f"reddit rb={rb} bc={bc} F={fb}", csr, lay, b, device)
            log(f"reddit-{SCALE} rb={rb} bc={bc} F={fb}: max |kernel - plain| "
                f"{json.dumps(errs[fb])}; dense-W == ragged bit for bit"
                + ("; merge-path twice bit-equal" if lay["merge"] else ""))
        for key, (name, ts, kern, plain) in _run_all(lay, bs[f], csr.n_rows).items():
            byts, flops = _work(name, lay, csr, f, ts)
            rec = {
                "max_abs_err": errs[f][key],
                "ms": time_callable(kern, device, iters=reps).median_ms,
                "plain_ms": time_callable(plain, device, iters=1).median_ms,
                "bound_ms": max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
                "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                else "operations",
            }
            if (rb, bc, ts) == (8, 8, 8):
                records[name] = {
                    "name": name, "route": "cuda", "source": "src/repro_torch/csrc/spmm.cu",
                    "replaces": REPLACES[name], "launches": 0, **rec,
                    "library_ms": lib_ms, "variants": {},
                }
            else:
                label = f"tile_slots={ts}" if name == "spmm_merge_path" else f"rb={rb},bc={bc}"
                records[name]["variants"][label] = rec
            log(f"  {key} rb={rb} bc={bc} F={f}: {json.dumps(rec)}")
        if (rb, bc) == (8, 8):
            # the estimate's per-step charge: time beyond the bound, per
            # (slot, feature tile) step (HardwareSpec.h100.step_s)
            rec = records["spmm_ragged_ell"]
            steps = lay["n_slots"] * math.ceil(f / ks.f_tile(f))
            log(f"ragged_s_per_step (F={f}, f_tile={ks.f_tile(f)}): "
                f"{(rec['ms'] - rec['bound_ms']) * 1e-3 / steps:.4e}")
        del lay
        if device.type == "cuda":
            torch.cuda.empty_cache()
    aux = {k: torch.from_numpy(v).to(device) for k, v in prepare_csr(csr).items()}
    base_ms = time_callable(lambda: spmm_gather_segsum(aux, bs[f]), device, iters=reps).median_ms
    log(f"gather_segsum (guardrail baseline) F={f}: {base_ms} ms; torch.sparse.mm: {lib_ms} ms")
    return records


def _work(name, lay, csr, f, ts) -> tuple:
    """(bytes, flops) one call must move and do: each array of its
    layout read once, B read once and C written once; 2 * nnz * F FLOPs,
    the product's own multiply-adds (the zeros the tiles pad with are
    the layout's cost, not the product's)."""
    arrays = {
        "spmm_block_ell": lambda: lay["dense"],
        "spmm_ragged_ell": lambda: lay["ragged"],
        "spmm_merge_path": lambda: lay["merge"][ts][:5],
    }[name]()
    byts = sum(a.numel() * a.element_size() for a in arrays)
    return byts + (csr.n_cols + csr.n_rows) * f * 4, 2.0 * csr.nnz * f


# ------------------------------------------------------- phases 3 & 4
def _warm_breakdown(model, graph, x, sage, device) -> None:
    """Where a warm scheduled forward spends its time: host work per
    layer (normalize, decide from the cache, runner lookup) against the
    device work (matmuls + SpMM runner, CUDA events)."""
    import torch

    from repro_torch.core.probe import time_callable
    from repro_torch.models.gnn import norm_csr

    with torch.no_grad():
        t0 = time.perf_counter()
        a = norm_csr(graph)
        norm_s = time.perf_counter() - t0
        host, dev = [], []
        h = x
        for i in range(len(model.w_agg)):
            t0 = time.perf_counter()
            d = sage.decide(a, model.w_agg[i].shape[1], "spmm")
            run = sage.build_runner(a, d)
            host.append(time.perf_counter() - t0)
            hw = h @ model.w_agg[i]
            dev.append(time_callable(lambda: run(hw), device, iters=3).median_ms)
            h = run(hw) + h @ model.w_self[i]
            h = torch.relu(h) if i < len(model.w_agg) - 1 else h
    log(f"warm forward breakdown: norm_csr {norm_s * 1e3:.1f} ms; per layer host "
        f"decide+lookup ms {[round(s * 1e3, 1) for s in host]}; SpMM runner ms "
        f"{[round(m, 2) for m in dev]}")


def model_phase(graph, device, workdir: Path) -> dict:
    """Decide + forward + replay, then each family pinned. Returns the
    launch counts summed over these runs."""
    import torch

    from repro_torch.core import AutoSage, ScheduleCache
    from repro_torch.core.features import InputFeatures
    from repro_torch.core import registry
    from repro_torch.kernels import spmm as ks
    from repro_torch.models.gnn import SAGE, norm_csr

    model = SAGE(IN_DIM, N_CLASSES, seed=0, device=device)
    x = torch.randn(graph.n_rows, IN_DIM, generator=torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref_logits = model(graph, x)
        sync(device)
        log(f"reference forward (sage=None): {time.perf_counter() - t0:.2f} s, "
            f"logits {tuple(ref_logits.shape)}")
    if not torch.isfinite(ref_logits).all():
        raise AssertionError("reference logits not finite")

    cache_path = workdir / "cache.json"
    totals = dict.fromkeys(ks.LAUNCHES, 0)

    def counted_(label, fn):
        return counted(label, fn, totals, device)

    sage = AutoSage(device=device, cache=ScheduleCache(path=str(cache_path)))
    times = []

    def two_forwards():
        outs = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(model(graph, x, sage=sage))
            sync(device)
            times.append(time.perf_counter() - t0)
        return outs

    (logits, logits_warm), _ = counted_("decide + 2 forwards", two_forwards)
    err = check_close("scheduled vs reference logits", logits, ref_logits)
    check_close("scheduled forward, second call", logits_warm, logits)
    log(f"scheduled forward: cold {times[0]:.2f} s (decide + probe + prepare), warm "
        f"{times[1]:.3f} s; max |logits - reference| {err:.3e}; second call "
        f"bit-equal: {bool(torch.equal(logits, logits_warm))}")
    cache = json.loads(cache_path.read_text())
    choices = {}
    for key, entry in sorted(cache.items()):
        f = key.split("|")[2]
        choices[key] = entry["choice"]
        ests = sorted(entry["estimates_ms"].items(), key=lambda kv: kv[1])[:4]
        log(f"decision {f}: choice={entry['choice']} probe_ms={json.dumps(entry['probe_ms'])} "
            f"top estimates_ms={json.dumps(dict(ests))} "
            f"guardrail={'accepted' if entry['choice'] != 'baseline' else 'kept baseline'}")
    _warm_breakdown(model, graph, x, sage, device)  # not a counted run

    replay = AutoSage(device=device, cache=ScheduleCache(path=str(cache_path), replay_only=True))
    logits_r, _ = counted_("replay forward", lambda: model(graph, x, sage=replay))
    for key, choice in choices.items():
        f = int(key.split("|")[2][2:])
        d = replay.decide(norm_csr(graph), f, "spmm")
        if not d.from_cache or d.choice != choice:
            raise AssertionError(f"replay of {key}: {d.choice} != {choice}")
    check_close("replayed logits", logits_r, logits)
    log(f"replay-only AutoSage: same choices {sorted(set(choices.values()))}; logits "
        f"bit-equal: {bool(torch.equal(logits_r, logits))}")
    raw = AutoSage(device=device, cache=ScheduleCache(path=str(cache_path), replay_only=True))
    resilience_ab("SAGE", lambda: model(graph, x, sage=raw), lambda: model(graph, x, sage=replay),
                  device)
    del raw

    a = norm_csr(graph)
    for family in FAMILIES:
        pinned_path = workdir / f"pinned_{family}.json"
        pins = ScheduleCache(path=str(pinned_path))
        for key in choices:
            f = int(key.split("|")[2][2:])
            feat = InputFeatures.from_csr(a, f, "spmm")
            names = [v.full_name() for v in registry.candidates(feat, sage.hw, device)
                     if v.name == family and v.knobs.get("bc", 8) == 8
                     and v.knobs.get("rb", 8) == 8 and v.knobs.get("tile_slots", 8) == 8]
            if len(names) != 1:
                raise AssertionError(f"{family} at F={f}: candidates {names}")
            pins.put(key, {"choice": names[0], "probe_ms": {}, "estimates_ms": {}})
        pinned = AutoSage(device=device, cache=ScheduleCache(path=str(pinned_path), replay_only=True))
        t0 = time.perf_counter()
        out, got = counted_(f"{family} pinned forward", lambda: model(graph, x, sage=pinned))
        kernel = FAMILY_KERNEL[family]
        if got[kernel] < len(choices):
            raise AssertionError(f"{family}: {kernel} launched {got[kernel]} times in the forward")
        err = check_close(f"{family} logits vs reference", out, ref_logits)
        log(f"pinned {family}: {kernel} +{got[kernel]} launches, max |logits - reference| "
            f"{err:.3e}, {time.perf_counter() - t0:.1f} s incl. prepare")
        del pinned, out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    log(f"SpMM main-path launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ------------------------------------------------------- phases 5 & 6
def _attn_layouts(csr, device) -> dict:
    """Dense-W and ragged 8x8 layouts of a structural, deduplicated CSR,
    uploaded. Without duplicate edges every block value is already the
    0/1 mask, so the tiles go up as they are: no second host copy of the
    dense-W table (13.6 GB at Reddit-0.25)."""
    import torch

    from repro_torch.sparse import csr_to_block_ell

    def up(a):
        return torch.from_numpy(a).to(device)

    bell = csr_to_block_ell(csr.structural())
    rag = bell.to_ragged()
    out = {
        "ragged": (up(rag.blkptr), up(rag.slot_colblk), up(rag.slot_vals)),
        "dense": (up(bell.colblk), up(bell.vals)),
        "nrb": bell.n_row_blocks, "width": bell.width, "n_slots": rag.n_slots,
    }
    del bell, rag
    return out


def _qkv(csr, d, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.randn(csr.n_rows, d, generator=g).to(device),
            torch.randn(csr.n_cols, d, generator=g).to(device),
            torch.randn(csr.n_cols, d, generator=g).to(device))


def _attn_run_all(lay, q, k, v, n_rows, cs=None):
    """kernel name -> (kernel call in chunks of cs slots (default: the
    wrappers'), plain call)."""
    from repro_torch.kernels import attention as ka

    dense, ragged = lay["dense"], lay["ragged"]
    return {
        "fused_csr_attention": (
            lambda: ka.fused_csr_attention(*dense, q, k, v, n_rows=n_rows, cs=cs),
            lambda: ka.fused_csr_attention_plain(*dense, q, k, v, n_rows=n_rows),
        ),
        "fused_ragged_attention": (
            lambda: ka.fused_ragged_attention(*ragged, q, k, v, n_rows=n_rows, cs=cs),
            lambda: ka.fused_ragged_attention_plain(*ragged, q, k, v, n_rows=n_rows),
        ),
    }


def check_attention(tag, csr, lay, q, k, v, device, cs=None) -> dict:
    """Both attention kernels (in chunks of cs slots, default the
    wrappers') against their plain versions; dense-W == ragged bit for
    bit; a second launch gives the same bits; rows without edges come out
    0. Returns max errors."""
    import torch

    errs, outs = {}, {}
    for name, (kern, plain) in _attn_run_all(lay, q, k, v, csr.n_rows, cs).items():
        got = kern()
        sync(device)
        errs[name] = check_close(f"{tag} {name}", got, plain())
        check_equal(f"{tag} {name} run twice", got, kern())
        outs[name] = got
    check_equal(f"{tag} attention dense-W vs ragged", outs["fused_csr_attention"],
                outs["fused_ragged_attention"])
    empty = torch.from_numpy(csr.degrees == 0).to(device)
    if bool(outs["fused_ragged_attention"][empty].any()):
        raise AssertionError(f"{tag}: a row without edges has nonzero attention output")
    return errs


def _ramp_qkv(csr, d, device, seed):
    """q, k, v whose logits rise with the column, by ~40 over the columns:
    a row's later slots raise its max by a large margin, so the online
    rescale (alpha ~ exp(-40) at the extreme) carries the result."""
    import torch

    q, k, v = _qkv(csr, d, device, seed)
    u = torch.nn.functional.normalize(torch.ones(d, device=device), dim=0)
    ramp = torch.arange(csr.n_cols, device=device, dtype=torch.float32) / csr.n_cols
    q = q * 0.1 + u
    k = k * 0.1 + (40.0 * d ** 0.5) * ramp[:, None] * u
    return q, k, v


def _most_chunks(lay, cs) -> int:
    """The most chunks of cs slots a row block of lay's ragged layout is
    split into: above 1, the kernels' combine runs."""
    import torch

    from repro_torch.kernels import attention as ka

    return int(torch.diff(ka.ragged_chunk_table(lay["ragged"][0], cs)[0]).max())


def attention_edge_cases(device) -> None:
    """Small deduplicated graphs that hit the attention kernels' corners:
    D = 41 and 602 (rows not 16-byte aligned), fully live clique tiles, a
    ramp of logits that makes later slots raise a row's max, then the
    inf/NaN trap on v rows."""
    import numpy as np

    from repro_torch.kernels import attention as ka
    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    deg[2] = deg[45] = 0  # rows without edges inside row blocks that have some
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32), None, deg.size, 70)
    # a hub row block of at least two chunks at every D
    hub = single_hub(max(HUB_N, 16 * ka.chunk_slots(IN_DIM)), nnz_frac=0.9, seed=1)
    skew = hub_skew(3000, 4, 0.05, 300, seed=2)
    cases = (("empty-blocks/rows", empty), ("single-hub", hub), ("hub-skew", skew),
             ("cliques", _cliques(25, 16)))
    for tag, csr in cases:
        csr = csr.dedup_edges()
        lay = _attn_layouts(csr, device)
        if tag == "single-hub" and lay["width"] < hub.n_cols // 8:
            raise AssertionError(f"single-hub: the hub spans {lay['width']} slots only")
        if tag == "cliques" and not bool((lay["ragged"][2] == 1).all()):
            raise AssertionError("cliques: a stored tile is not fully live")
        for d in (41, 64, 256, IN_DIM):
            if tag == "single-hub" and _most_chunks(lay, ka.chunk_slots(d)) < 2:
                raise AssertionError(f"single-hub D={d}: the hub row block is not split")
            q, k, v = _qkv(csr, d, device, seed=d)
            check_attention(f"{tag} D={d}", csr, lay, q, k, v, device)
            if d != 64:  # every row block of more than 32 slots split
                check_attention(f"{tag} D={d} chunks of 32", csr, lay, q, k, v, device, cs=32)
        if tag in ("single-hub", "hub-skew"):
            for d in (64, 256):
                check_attention(f"{tag} ramp D={d}", csr, lay,
                                *_ramp_qkv(csr, d, device, seed=d), device)
    log("attention edge cases: empty row blocks (dummy slot), rows without edges in "
        f"non-empty blocks, single hub over {hub.n_cols // 8} slots (split at every D), "
        f"hub_skew, fully live clique tiles; D=41,64,256,{IN_DIM}, also in chunks of 32 "
        "slots; logits rising by ~40 along rows: ok")
    attention_inf_nan_trap(skew.dedup_edges(), device)


def attention_inf_nan_trap(graph, device) -> None:
    """v holds +inf, -inf and NaN in rows that no edge reads but that share
    a column block with rows that edges do read (graph's column j moved to
    2j: every odd column is unread). The plain versions multiply whole
    tiles and give NaN (0 * inf), as the Pallas kernels do; the kernels
    never read those rows and must agree with the CSR oracle
    (ref.csr_attention_ref)."""
    import torch

    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import ref
    from repro_torch.sparse import CSR

    csr = CSR(graph.rowptr, graph.colind * 2, None, graph.n_rows, 2 * graph.n_cols)
    lay = _attn_layouts(csr, device)
    rp, ci = (torch.from_numpy(a).to(device) for a in (csr.rowptr, csr.colind))
    for d in (41, 256):
        q, k, v = _qkv(csr, d, device, seed=d + 1)
        v[1::2] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                               device=device).repeat(csr.n_cols)[: csr.n_cols // 2, None]
        want = ref.csr_attention_ref(rp, ci, q, k, v)
        if not bool(torch.isfinite(want).all()):
            raise AssertionError("attention inf/NaN trap: the CSR oracle is not finite")
        for name, (kern, plain) in _attn_run_all(lay, q, k, v, csr.n_rows).items():
            check_close(f"attention inf/NaN trap D={d} {name}", kern(), want)
        if not bool(torch.isnan(ka.fused_ragged_attention_plain(
                *lay["ragged"], q, k, v, n_rows=csr.n_rows)).any()):
            raise AssertionError("attention inf/NaN trap: the plain version gave no NaN")
    log("attention inf/NaN trap: v rows paired only with masked cells hold +-inf/NaN; both "
        "kernels match ref.csr_attention_ref (the plain versions give NaN): ok")


def _library_pipe(graph, device, scale):
    """torch.sparse.sampled_addmm (scaled) -> torch.sparse.softmax (dim 1,
    COO) -> torch.sparse.mm on graph's pattern: the library calls that
    compose CSR attention (no single call computes it). The port never
    calls them. Returns fn(q, k, v)."""
    import torch

    rowptr = torch.from_numpy(graph.rowptr).to(device)
    colind = torch.from_numpy(graph.colind).to(device)
    pattern = torch.sparse_csr_tensor(rowptr, colind, torch.ones(graph.nnz, device=device),
                                      size=(graph.n_rows, graph.n_cols),
                                      check_invariants=False)
    coo_idx = torch.stack([torch.repeat_interleave(
        torch.arange(graph.n_rows, device=device), torch.diff(rowptr.long())), colind.long()])
    size = (graph.n_rows, graph.n_cols)

    def run(q, k, v):
        logits = torch.sparse.sampled_addmm(pattern, q, k.t(), beta=0.0, alpha=scale)
        probs = torch.sparse.softmax(torch.sparse_coo_tensor(
            coo_idx, logits.values(), size, is_coalesced=True), 1)
        return torch.sparse.mm(torch.sparse_csr_tensor(
            rowptr, colind, probs.values(), size=size, check_invariants=False), v)

    return run


def attention_kernel_phase(graph, lay, device, reps: int) -> dict:
    """Phase 5 at the slice's shapes: the deduplicated Reddit-0.25 graph,
    D = 256, on its uploaded 8x8 layouts ``lay``. Returns the kernel
    records."""
    import torch

    from repro_torch.core.probe import time_callable
    from repro_torch.core.registry import _dev
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import baselines as kb

    q, k, v = _qkv(graph, D_ATTN, device, seed=7)
    errs = check_attention(f"reddit D={D_ATTN}", graph, lay, q, k, v, device)
    log(f"reddit-{SCALE} dedup D={D_ATTN}: max |kernel - plain| {json.dumps(errs)}; "
        "dense-W == ragged bit for bit; second launch bit-equal")
    aux = _dev(kb.prepare_csr(graph), device)
    base_ms = time_callable(lambda: kb.attention_csr(aux, q, k, v), device,
                            iters=reps).median_ms
    log(f"composed CSR pipeline (guardrail baseline) D={D_ATTN}: {base_ms} ms")
    del aux
    lib = _library_pipe(graph, device, 1.0 / D_ATTN ** 0.5)
    has = torch.from_numpy(graph.degrees > 0).to(device)
    got = lib(q, k, v)
    lib_err = check_close("library pipe vs plain (rows with edges)", got[has],
                          ka.fused_ragged_attention_plain(*lay["ragged"], q, k, v,
                                                          n_rows=graph.n_rows)[has])
    del got
    lib_pipe_ms = time_callable(lambda: lib(q, k, v), device, iters=reps).median_ms
    log(f"library composition sampled_addmm -> sparse.softmax -> sparse.mm D={D_ATTN}: "
        f"{lib_pipe_ms} ms; max |library - plain| on rows with edges {lib_err:.3e}")
    del lib
    _empty_cache(device)
    records = {}
    io_bytes = (2 * graph.n_rows + 2 * graph.n_cols) * D_ATTN * 4  # q, k, v, out
    flops = 4.0 * graph.nnz * D_ATTN
    for name, (kern, plain) in _attn_run_all(lay, q, k, v, graph.n_rows).items():
        arrays = lay["dense" if name == "fused_csr_attention" else "ragged"]
        byts = sum(a.numel() * a.element_size() for a in arrays) + io_bytes
        rec = {
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": errs[name],
            "ms": time_callable(kern, device, iters=reps).median_ms,
            "plain_ms": time_callable(plain, device, iters=1).median_ms,
            "bound_ms": max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations",
            "library_ms": None, "library_pipe_ms": lib_pipe_ms, "baseline_pipe_ms": base_ms,
        }
        records[name] = rec
        log(f"  {name} D={D_ATTN}: {json.dumps(rec)}")
    attn_step_fit(graph, records, device)
    chunk_vs_unsplit(graph, lay, q, k, v, device, reps)
    _empty_cache(device)
    return records


def attn_step_fit(graph, records, device) -> None:
    """HardwareSpec.attn_step_s fitted on the ragged kernel against
    estimate.py's own terms: (measured - the estimate at attn_step_s = 0)
    / the slots it charges. Then both fused estimates beside the measured
    times, on the h100 profile and on the whole-tile model charged
    step_s per slot (the JAX package's, and the h100 profile's before
    attn_live_gathers)."""
    import dataclasses
    import functools

    from repro_torch.core import HardwareSpec, InputFeatures, estimate, registry

    feat = InputFeatures.from_csr(graph, D_ATTN, "attention")
    hw = HardwareSpec.h100()
    whole_tile = dataclasses.replace(hw, attn_live_gathers=False, attn_step_s=hw.step_s)
    knobs = {v.name: v.knobs for v in registry.candidates(feat, hw, device,
                                                          include_kernels=True)}
    for name, variant in (("fused_ragged_attention", "ragged_attention_cuda"),
                          ("fused_csr_attention", "fused_attention_cuda")):
        est = functools.partial(estimate.estimate, feat, variant=variant,
                                knobs=knobs[variant])
        e0 = est(dataclasses.replace(hw, attn_step_s=0.0))
        slots = est(dataclasses.replace(hw, attn_step_s=1.0)) - e0
        ms = records[name]["ms"]
        if name == "fused_ragged_attention":
            log(f"{name} s per slot beyond the estimate's roofline "
                f"(HardwareSpec.attn_step_s): {max(0.0, (ms * 1e-3 - e0) / slots):.4e} "
                f"({e0 * 1e3} ms roofline, {slots:.0f} slots)")
        log(f"{name} D={D_ATTN}: estimate {est(hw) * 1e3} ms (h100 profile), "
            f"{est(whole_tile) * 1e3} ms (whole-tile model at step_s); measured {ms} ms")


def chunk_vs_unsplit(graph, lay, q, k, v, device, reps: int) -> None:
    """Both kernels in the wrappers' chunks and with every row block in
    one chunk (the tail that chunks remove): each held bit-equal across
    layouts, unsplit within tolerance of chunked, and both timed; plus the
    longest chains that bound the unsplit kernel."""
    import numpy as np

    from repro_torch.core.probe import time_callable

    slots = np.diff(lay["ragged"][0].cpu().numpy())
    deg = graph.degrees
    log(f"chunks: slots per row block max {int(slots.max())}, mean {slots.mean():.1f}; "
        f"edges per row max {int(deg.max())}, mean {deg.mean():.1f}")
    outs, times = {}, {}
    for label, cs in (("chunked", None), ("unsplit", 1 << 30)):
        fns = _attn_run_all(lay, q, k, v, graph.n_rows, cs)
        got = {name: kern() for name, (kern, _) in fns.items()}
        check_equal(f"{label} dense-W vs ragged", *got.values())
        outs[label] = got["fused_ragged_attention"]
        del got
        times[label] = {name: time_callable(kern, device, iters=reps).median_ms
                        for name, (kern, _) in fns.items()}
    check_close("unsplit vs chunked", outs["unsplit"], outs["chunked"])
    log(f"chunked vs unsplit row blocks D={D_ATTN}: {json.dumps(times)}")


def _empty_cache(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def gat_phase(graph, device, workdir: Path) -> dict:
    """Phase 6: decide + forward + replay, then each fused family pinned.
    Returns the launch counts summed over these runs."""
    import torch

    from repro_torch.core import AutoSage, InputFeatures, ScheduleCache, obs, registry
    from repro_torch.models.gnn import GAT

    model = GAT(IN_DIM, D_ATTN, seed=0, device=device)
    x = torch.randn(graph.n_rows, IN_DIM, generator=torch.Generator().manual_seed(2)).to(device)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref_out = model(graph, x)
        sync(device)
    log(f"GAT reference forward (sage=None): {time.perf_counter() - t0:.2f} s, "
        f"out {tuple(ref_out.shape)}")
    if not torch.isfinite(ref_out).all():
        raise AssertionError("GAT reference output not finite")
    totals: dict = {}
    cache_path = workdir / "gat_cache.json"
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(cache_path)))
    times = []

    def two_forwards():
        outs = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(model(graph, x, sage=sage))
            sync(device)
            times.append(time.perf_counter() - t0)
        return outs

    # the flight recorder's spans split the cold forward (decide: features,
    # estimate, probe, guardrail; then prepare and run); ~µs per span
    os.environ["AUTOSAGE_OBS"] = "1"
    spans_before = obs.span_totals_ms()
    (out, out_warm), _ = counted("GAT decide + 2 forwards", two_forwards, totals, device)
    del os.environ["AUTOSAGE_OBS"]
    spans = {k: round(v - spans_before.get(k, 0.0), 1)
             for k, v in obs.span_totals_ms().items()}
    err = check_close("GAT scheduled vs reference", out, ref_out)
    check_close("GAT scheduled forward, second call", out_warm, out)
    log(f"GAT scheduled forward: cold {times[0]:.2f} s (decide + probe + prepare), warm "
        f"{times[1]:.3f} s; max |out - reference| {err:.3e}; span ms over both "
        f"forwards {json.dumps(spans)}")
    (key, entry), = json.loads(cache_path.read_text()).items()
    choice = entry["choice"]
    ests = sorted(entry["estimates_ms"].items(), key=lambda kv: kv[1])
    log(f"attention decision: choice={choice} probe_ms={json.dumps(entry['probe_ms'])} "
        f"estimates_ms={json.dumps(dict(ests))} "
        f"guardrail={'accepted' if choice != 'baseline' else 'kept baseline'}")
    hw = sage.hw
    log(f"layout budget {hw.layout_budget_bytes:.4g} B; gate expressions: dense-W "
        "n_rows*deg_max*bc, ragged nnz*64*4")
    del sage
    replay = AutoSage(device=device,
                      cache=ScheduleCache(path=str(cache_path), replay_only=True))
    out_r, _ = counted("GAT replay forward", lambda: model(graph, x, sage=replay),
                       totals, device)
    d = replay.decide_attention(graph.structural(), D_ATTN)
    if not d.from_cache or d.choice != choice:
        raise AssertionError(f"replay of {key}: {d.choice} != {choice}")
    check_close("GAT replayed output", out_r, out)
    log(f"replay-only AutoSage: same choice {choice}; output bit-equal: "
        f"{bool(torch.equal(out_r, out))}")
    raw = AutoSage(device=device,
                   cache=ScheduleCache(path=str(cache_path), replay_only=True))
    resilience_ab("GAT", lambda: model(graph, x, sage=raw), lambda: model(graph, x, sage=replay),
                  device)
    del replay, raw, out_r
    _empty_cache(device)

    feat = InputFeatures.from_csr(graph.structural(), D_ATTN, "attention")
    pinned_out = {}
    for family, kernel in ATTN_FAMILY_KERNEL.items():
        names = [v.full_name() for v in registry.candidates(feat, hw, device)
                 if v.name == family]
        if len(names) != 1:
            raise AssertionError(f"{family}: candidates {names}")
        pinned_path = workdir / f"pinned_{family}.json"
        ScheduleCache(path=str(pinned_path)).put(
            key, {"choice": names[0], "probe_ms": {}, "estimates_ms": {}})
        pinned = AutoSage(device=device,
                          cache=ScheduleCache(path=str(pinned_path), replay_only=True))
        t0 = time.perf_counter()
        o, got = counted(f"{family} pinned GAT forward",
                         lambda: model(graph, x, sage=pinned), totals, device)
        if got[kernel] < 1:
            raise AssertionError(f"{family}: {kernel} did not launch in the forward")
        err = check_close(f"{family} output vs reference", o, ref_out)
        log(f"pinned {family}: {kernel} +{got[kernel]} launches, max |out - reference| "
            f"{err:.3e}, {time.perf_counter() - t0:.1f} s incl. prepare")
        pinned_out[family] = o
        del pinned
        _empty_cache(device)
    check_equal("GAT pinned dense-W vs ragged", *pinned_out.values())
    log(f"GAT main-path launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ------------------------------------------------------------ phase 7
def _sddmm_layouts(csr, device, rb, bc, attn_lay=None) -> dict:
    """Uploaded SDDMM tables of a structural CSR at (rb, bc): dense-W
    (colblk, mask), ragged (slot_rowblk, slot_colblk, mask) and blkptr.
    ``attn_lay``: phase 5's uploaded 8x8 layouts of the same deduplicated
    graph, whose tiles already are the 0/1 mask (no second conversion)."""
    import numpy as np
    import torch

    from repro_torch.sparse import csr_to_block_ell

    if attn_lay is not None:
        blkptr, slot_colblk, rmask = attn_lay["ragged"]
        colblk, dmask = attn_lay["dense"]
        nslots = torch.diff(blkptr.long())
        slot_rowblk = torch.repeat_interleave(
            torch.arange(nslots.shape[0], device=device, dtype=torch.int32),
            torch.clamp(nslots, min=1))
        return {"ragged": (slot_rowblk, slot_colblk, rmask), "dense": (colblk, dmask),
                "blkptr": blkptr, "nslots": nslots.cpu().numpy()}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    bell = csr_to_block_ell(csr.structural(), rb=rb, bc=bc)
    rag = bell.to_ragged()
    out = {
        "ragged": (up(rag.slot_rowblk), up(rag.slot_colblk),
                   up(np.minimum(rag.slot_vals, 1.0, out=rag.slot_vals))),
        "dense": (up(bell.colblk), up(np.minimum(bell.vals, 1.0, out=bell.vals))),
        "blkptr": up(rag.blkptr), "nslots": bell.nslots,
    }
    del bell, rag
    return out


def _merge_tables(lay, ts, device) -> tuple:
    """The merge-path SDDMM operands at tile_slots ``ts``, cut from the
    uploaded ragged tables on the device: (blkptr, tail-padded
    slot_colblk, tile_rowblk, tile_mask), n_slots."""
    import torch

    from repro_torch.sparse.merge import merge_tiling

    _, slot_colblk, mask = lay["ragged"]
    blkptr = lay["blkptr"]
    n_slots, rb, bc = mask.shape
    tiling = merge_tiling(blkptr.cpu().numpy(), n_slots, ts)
    n_tiles = tiling["tile_rowblk"].shape[0]
    pad = n_tiles * ts - n_slots
    colblk = torch.cat([slot_colblk, slot_colblk.new_zeros(pad)])
    tmask = torch.cat([mask, mask.new_zeros((pad, rb, bc))]).reshape(n_tiles, ts, rb, bc)
    return (blkptr, colblk, torch.from_numpy(tiling["tile_rowblk"]).to(device), tmask), n_slots


def _no_negative_zero(name, t) -> None:
    import torch

    if bool((torch.signbit(t) & (t == 0)).any()):
        raise AssertionError(f"{name}: a -0.0 where the rule writes +0.0")


def _sddmm_run_all(lay, x, y, device, merge_ts):
    """label -> (kernel name, kernel call, plain call, operands read)."""
    from repro_torch.kernels import sddmm as ksd

    ragged, dense = lay["ragged"], lay["dense"]
    out = {
        "sddmm_ragged_ell": ("sddmm_ragged_ell",
                             lambda: ksd.sddmm_ragged_ell(*ragged, x, y),
                             lambda: ksd.sddmm_ragged_ell_plain(*ragged, x, y), ragged),
        "sddmm_block_ell": ("sddmm_block_ell",
                            lambda: ksd.sddmm_block_ell(*dense, x, y),
                            lambda: ksd.sddmm_block_ell_plain(*dense, x, y), dense),
    }
    for ts in merge_ts:
        tables, _ = _merge_tables(lay, ts, device)
        out[f"sddmm_merge_path[ts={ts}]"] = (
            "sddmm_merge_path",
            lambda t=tables: ksd.sddmm_merge_path(*t, x, y),
            lambda t=tables: ksd.sddmm_merge_path_plain(*t, x, y), tables)
    return out


def check_sddmm(tag, lay, x, y, device, merge_ts=()) -> dict:
    """Each SDDMM kernel against its plain version; twice bit-equal; the
    live dense-W and merge tiles bit-equal to the ragged ones; padded,
    dummy and tail tiles all +0.0 and no masked cell -0.0. One output at a
    time beside the ragged one (Reddit's dense-W tiles take 13.6 GB).
    Returns max errors."""
    import torch

    from repro_torch.kernels import sddmm as ksd

    errs = {}
    slot_rowblk, slot_colblk, rmask = lay["ragged"]
    blkptr, nslots = lay["blkptr"], lay["nslots"]
    ragged = ksd.sddmm_ragged_ell(slot_rowblk, slot_colblk, rmask, x, y)
    sync(device)
    errs["sddmm_ragged_ell"] = check_close(
        f"{tag} sddmm_ragged_ell", ragged, ksd.sddmm_ragged_ell_plain(*lay["ragged"], x, y))
    check_equal(f"{tag} sddmm_ragged_ell run twice", ragged,
                ksd.sddmm_ragged_ell(slot_rowblk, slot_colblk, rmask, x, y))
    _no_negative_zero(f"{tag} sddmm_ragged_ell", ragged)
    dummy = torch.from_numpy((nslots == 0).nonzero()[0]).to(device)
    if bool(ragged[blkptr.long()[dummy]].any()):
        raise AssertionError(f"{tag}: a dummy slot's tile is not all-zero")
    n_slots, rb, bc = rmask.shape

    colblk, dmask = lay["dense"]
    nrb, w = colblk.shape
    dense = ksd.sddmm_block_ell(colblk, dmask, x, y)
    sync(device)
    errs["sddmm_block_ell"] = check_close(
        f"{tag} sddmm_block_ell", dense, ksd.sddmm_block_ell_plain(colblk, dmask, x, y))
    pos = torch.arange(n_slots, device=device) - blkptr.long()[slot_rowblk.long()]
    live = slot_rowblk.long() * w + pos
    flat = dense.view(nrb * w, rb, bc)
    check_equal(f"{tag} dense-W live tiles vs ragged", flat[live], ragged)
    flat.view(nrb * w, -1).index_fill_(0, live, 0.0)
    if bool(dense.any()) or bool(torch.signbit(dense).any()):
        raise AssertionError(f"{tag}: a padded dense-W tile is not all +0.0")
    del dense, flat

    for ts in merge_ts:
        tables, _ = _merge_tables(lay, ts, device)
        merged = ksd.sddmm_merge_path(*tables, x, y)
        sync(device)
        errs[f"sddmm_merge_path[ts={ts}]"] = check_close(
            f"{tag} sddmm_merge_path ts={ts}", merged, ksd.sddmm_merge_path_plain(*tables, x, y))
        check_equal(f"{tag} merge ts={ts} run twice", merged, ksd.sddmm_merge_path(*tables, x, y))
        mflat = merged.view(-1, rb, bc)
        check_equal(f"{tag} merge ts={ts} live tiles vs ragged", mflat[:n_slots], ragged)
        tail = mflat[n_slots:]
        if bool(tail.any()) or bool(torch.signbit(tail).any()):
            raise AssertionError(f"{tag}: a merge tail tile is not all +0.0")
        del tables, merged, mflat, tail
    del ragged
    _empty_cache(device)
    return errs


def sddmm_edge_cases(device) -> None:
    """Small graphs that hit the SDDMM layouts' corners, and explicit-zero
    edges through the registry's runners."""
    import numpy as np
    import torch

    from repro_torch.core import registry
    from repro_torch.kernels import ref
    from repro_torch.kernels import sddmm as ksd
    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    val = rng.standard_normal(int(deg.sum())).astype(np.float32)
    val[::4] = 0.0  # explicit zeros: the mask keeps them
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32), val, deg.size, 70)
    hub = single_hub(HUB_N, nnz_frac=0.9, seed=1)
    skew = hub_skew(3000, 4, 0.05, 300, seed=2)
    cliques = _cliques(25, 16)
    for tag, csr in (("empty-blocks", empty), ("single-hub", hub), ("hub-skew", skew),
                     ("cliques", cliques)):
        for rb in (8, 16):
            lay = _sddmm_layouts(csr, device, rb, 8)
            if rb == 8:
                partial = [ts for ts in (3, 8, 16) if lay["ragged"][2].shape[0] % ts]
                if not partial:
                    raise AssertionError(f"{tag}: no case with a partial last tile")
            if tag == "cliques" and not bool((lay["ragged"][2] == 1).all()):
                raise AssertionError(f"cliques rb={rb}: a tile is not fully live")
            for f in (16, 41, 256, 602):
                g = torch.Generator().manual_seed(f)
                x = torch.randn(csr.n_rows, f, generator=g).to(device)
                y = torch.randn(csr.n_cols, f, generator=g).to(device)
                check_sddmm(f"{tag} rb={rb} F={f}", lay, x, y, device,
                            merge_ts=(3, 8, 16) if rb == 8 else ())
        del lay
    # explicit-zero edges keep <X_i, Y_j> through every registry family
    rp, ci = (torch.from_numpy(a).to(device) for a in (empty.rowptr, empty.colind))
    x = torch.randn(empty.n_rows, 41, generator=torch.Generator().manual_seed(3)).to(device)
    y = torch.randn(empty.n_cols, 41, generator=torch.Generator().manual_seed(4)).to(device)
    want = ref.sddmm_ref(rp, ci, x, y)
    runners = {
        "ragged": registry._build_sddmm(ksd.sddmm_ragged_ell,
                                        ("slot_rowblk", "slot_colblk", "mask"))(
            registry._prep_sddmm_ragged(empty, 8, 8), device),
        "dense-W": registry._build_sddmm(ksd.sddmm_block_ell, ("colblk", "mask"))(
            registry._prep_sddmm_dense(empty, 8, 8), device),
        "merge": registry._build_sddmm(
            ksd.sddmm_merge_path, ("blkptr", "slot_colblk", "tile_rowblk", "tile_mask"))(
            registry._prep_sddmm_merge(empty, 8), device),
    }
    zero = torch.from_numpy(val == 0).to(device)
    for name, run in runners.items():
        got = run(x, y)
        check_close(f"explicit-zero edges {name}", got, want)
        if not bool((got[zero] != 0).all()):
            raise AssertionError(f"explicit-zero edges {name}: an edge lost its dot product")
    sddmm_zero_and_inf_traps(skew, device)
    log("SDDMM edge cases: empty row blocks (dummy slots), explicit-zero edges, single hub "
        "over many merge tiles, partial last tiles (tile_slots 3/8/16), fully live clique "
        "tiles, blockings 8x8/16x8 at F=16,41,256,602, -0.0 rows, +-inf/NaN in Y rows only "
        "masked cells pair with: ok")


def _cliques(n_cliques, size):
    """Block-diagonal cliques of ``size`` nodes: at size 16 every 8x8 and
    16x8 tile of the diagonal has all its cells live."""
    import numpy as np

    from repro_torch.sparse import CSR

    n = n_cliques * size
    rows = np.repeat(np.arange(n), size)
    cols = rows // size * size + np.tile(np.arange(size), n)
    return CSR((np.arange(n + 1) * size).astype(np.int32), cols.astype(np.int32),
               np.ones(n * size, np.float32), n, n)


def sddmm_zero_and_inf_traps(graph, device) -> None:
    """Two traps through check_sddmm at 8x8 (merge tile_slots 3 and 8) and
    16x8: (a) X and Y holding -0.0 in whole rows, whose live cells must
    read +0.0, with no -0.0 anywhere; (b) the graph's columns spread to
    even ones, with Y holding +inf, -inf and NaN in the odd rows, which
    only masked cells pair with: those cells stay +0.0 and the whole
    output is finite (check_close raises on a non-finite output)."""
    import torch

    from repro_torch.kernels import sddmm as ksd
    from repro_torch.sparse import CSR

    g = torch.Generator().manual_seed(7)
    x = torch.randn(graph.n_rows, 64, generator=g)
    y = torch.randn(graph.n_cols, 64, generator=g)
    x[::3], y[1::4] = -0.0, -0.0
    spread = CSR(graph.rowptr, graph.colind * 2, graph.val, graph.n_rows, 2 * graph.n_cols)
    y_inf = torch.randn(spread.n_cols, 41, generator=g)
    y_inf[1::6], y_inf[3::6], y_inf[5::6] = float("inf"), float("-inf"), float("nan")
    x_inf = torch.randn(spread.n_rows, 41, generator=g).to(device)
    x, y, y_inf = x.to(device), y.to(device), y_inf.to(device)
    for rb in (8, 16):
        merge_ts = (3, 8) if rb == 8 else ()
        lay = _sddmm_layouts(graph, device, rb, 8)
        check_sddmm(f"-0.0 rows rb={rb}", lay, x, y, device, merge_ts)
        out = ksd.sddmm_ragged_ell(*lay["ragged"], x, y)
        rows = lay["ragged"][0].long()[:, None] * rb + torch.arange(rb, device=device)
        hit = (x[:, 0] == 0)[rows.clamp(max=graph.n_rows - 1)]
        if not bool(hit.any()) or bool(out[hit].any()):
            raise AssertionError(f"-0.0 rows rb={rb}: a tile row of a -0.0 X row is not 0")
        lay = _sddmm_layouts(spread, device, rb, 8)
        check_sddmm(f"inf/NaN rows rb={rb}", lay, x_inf, y_inf, device, merge_ts)
        out = ksd.sddmm_ragged_ell(*lay["ragged"], x_inf, y_inf)
        odd = out[..., 1::2]
        if bool(odd.any()) or bool(torch.signbit(odd).any()):
            raise AssertionError(f"inf/NaN rows rb={rb}: a masked cell is not +0.0")
        del lay, out, odd


def sddmm_kernel_phase(graph, held: dict, device, reps: int) -> dict:
    """Phase 7 at the slice's shapes: the deduplicated Reddit-0.25 graph,
    D = 256; 8x8 on phase 5's tables (``held["attn_lay"]``, freed after
    the 8x8 pass so the 16x8 tables fit beside the outputs; merge
    tile_slots 8 and 16), then 16x8. Returns the kernel records (8x8 and
    tile_slots 8 on top, the others under "variants")."""
    import torch

    from repro_torch.core.probe import time_callable
    from repro_torch.kernels import baselines

    g = torch.Generator().manual_seed(11)
    x = torch.randn(graph.n_rows, D_ATTN, generator=g).to(device)
    y = torch.randn(graph.n_cols, D_ATTN, generator=g).to(device)
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(graph.rowptr).to(device), torch.from_numpy(graph.colind).to(device),
        torch.ones(graph.nnz, device=device), size=(graph.n_rows, graph.n_cols),
        check_invariants=False)
    lib_ms = time_callable(lambda: torch.sparse.sampled_addmm(a_lib, x, y.t(), beta=0.0),
                           device, iters=reps).median_ms
    del a_lib
    log(f"torch.sparse.sampled_addmm D={D_ATTN}: {lib_ms} ms")
    rp, ci = (torch.from_numpy(a).to(device) for a in (graph.rowptr, graph.colind))
    base_ms = time_callable(
        lambda: baselines.sddmm_gather_dot({"rowptr": rp, "colind": ci}, x, y), device,
        iters=reps).median_ms
    del rp, ci
    log(f"gather_dot (the guardrail's SDDMM baseline) D={D_ATTN}: {base_ms} ms")
    io_bytes = (graph.n_rows + graph.n_cols) * D_ATTN * 4  # X and Y read once
    flops = 2.0 * graph.nnz * D_ATTN
    records = {}
    for rb, bc in ((8, 8), (16, 8)):
        t0 = time.perf_counter()
        lay = _sddmm_layouts(graph, device, rb, bc, held.pop("attn_lay") if rb == 8 else None)
        sync(device)
        n_slots, w = lay["ragged"][2].shape[0], lay["dense"][0].shape[1]
        log(f"SDDMM layouts rb={rb} bc={bc}: slots={n_slots} W={w} "
            f"({time.perf_counter() - t0:.1f} s{' reused from phase 5' if rb == 8 else ''})")
        merge_ts = (8, 16) if rb == 8 else ()
        errs = check_sddmm(f"reddit rb={rb}", lay, x, y, device, merge_ts)
        log(f"reddit-{SCALE} dedup rb={rb} bc={bc} D={D_ATTN}: max |kernel - plain| "
            f"{json.dumps(errs)}; live tiles bit-equal across layouts; padded/dummy/tail "
            "tiles +0.0; second launch bit-equal")
        for label, (name, kern, plain, arrays) in _sddmm_run_all(lay, x, y, device,
                                                                 merge_ts).items():
            out_bytes = arrays[-1].numel() * 4  # the tiles, one per mask cell
            byts = sum(a.numel() * a.element_size() for a in arrays) + io_bytes + out_bytes
            rec = {
                "max_abs_err": errs[label],
                "ms": time_callable(kern, device, iters=reps).median_ms,
                "plain_ms": time_callable(plain, device, iters=1).median_ms,
                "bound_ms": max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
                "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                else "operations",
            }
            ts = int(label.split("=")[1].rstrip("]")) if "ts=" in label else 8
            if (rb, ts) == (8, 8):
                records[name] = {
                    "name": name, "route": "cuda", "source": "src/repro_torch/csrc/sddmm.cu",
                    "replaces": REPLACES[name], "launches": 0, **rec,
                    "library_ms": lib_ms, "baseline_ms": base_ms, "variants": {},
                }
            else:
                key = f"tile_slots={ts}" if name == "sddmm_merge_path" else f"rb={rb},bc={bc}"
                records[name]["variants"][key] = rec
            log(f"  {label} rb={rb} bc={bc} D={D_ATTN}: {json.dumps(rec)}")
        del kern, plain, arrays  # the loop's last tables
        if rb == 8:
            rec = records["sddmm_ragged_ell"]
            beyond = (rec['ms'] - rec['bound_ms']) * 1e-3 / n_slots
            log(f"sddmm_ragged_ell s per live slot beyond the bound: {beyond:.4e}; per "
                f"(slot, 128-column chunk), HardwareSpec.sddmm_step_s: "
                f"{beyond / math.ceil(D_ATTN / 128):.4e}")
        del lay
        _empty_cache(device)
    return records


# ------------------------------------------------------- phases 8 & 9
def _peak_reset(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(label, device) -> None:
    import torch

    if device.type == "cuda":
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")


def _grads(model) -> list:
    return [p.grad.detach().clone() for p in model.parameters()]


def _check_grads(tag, model, got, want) -> float:
    names = [n for n, _ in model.named_parameters()]
    return max(check_close(f"{tag} grad {n}", g, w, GRAD_RTOL)
               for n, g, w in zip(names, got, want))


def _decisions(path, probes=False) -> dict:
    """op|F -> choice of every entry of a schedule-cache file (with
    ``probes``: the choice and the probed ms of each candidate)."""
    out = {}
    for key, entry in json.loads(Path(path).read_text()).items():
        _, _, f, op, _ = key.split("|")
        out[f"{op}|{f}"] = ({"choice": entry["choice"], "probe_ms": entry["probe_ms"]}
                            if probes else entry["choice"])
    return out


def _check_replayed(tag, replay, path, graph_of) -> None:
    """Every decision cached in ``path`` replays from the replay-only
    AutoSage with the same choice; ``graph_of(op)`` is the graph the op
    runs on (the forward graph or its transpose)."""
    for key, choice in _decisions(path).items():
        op, f = key.split("|")
        f = int(f[2:])
        g = graph_of(op)
        d = replay.decide_attention(g, f) if op == "attention" else replay.decide(g, f, op)
        if not d.from_cache or d.choice != choice:
            raise AssertionError(f"{tag} replay of {key}: {d.choice} != {choice}")


def _train_step(model, loss_fn, totals, device, label, update=True, lr=LR):
    """One counted training step (loss, backward, and SGD at ``lr`` when
    ``update``); returns (loss, seconds)."""
    from repro_torch.train_gnn import sgd_step

    t0 = time.perf_counter()

    def step():
        if update:
            return sgd_step(model, loss_fn, lr)
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return float(loss.detach())

    loss, _ = counted(label, step, totals, device, grad=True)
    sync(device)
    if not math.isfinite(loss):
        raise AssertionError(f"{label}: loss {loss}")
    return loss, time.perf_counter() - t0


def sage_train_phase(graph, device, workdir: Path) -> dict:
    """Phase 8. Returns the launch counts summed over its counted runs."""
    import copy

    import torch

    from repro_torch.core import AutoSage, ScheduleCache, registry
    from repro_torch.models.gnn import SAGE, norm_csr
    from repro_torch.train_gnn import make_data, nll_loss

    _peak_reset(device)
    feats, labels = make_data(graph, N_CLASSES, IN_DIM, seed=0)
    x, y = torch.from_numpy(feats).to(device), torch.from_numpy(labels).to(device)
    model = SAGE(IN_DIM, N_CLASSES, seed=0, device=device)
    ref_model = copy.deepcopy(model)
    t0 = time.perf_counter()
    loss = nll_loss(ref_model(graph, x), y)
    loss.backward()
    ref_loss = loss.detach()
    sync(device)
    ref_grads = _grads(ref_model)
    del ref_model
    log(f"SAGE reference step (sage=None, explicit backward oracles): loss "
        f"{float(ref_loss):.6f}, {time.perf_counter() - t0:.2f} s")
    totals: dict = {}
    path = workdir / "sage_train.json"
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(path)))

    def loss_fn(s):
        return lambda: nll_loss(model(graph, x, sage=s), y)

    losses, secs = [], []
    for i in range(3):
        loss, dt = _train_step(model, loss_fn(sage), totals, device, f"SAGE train step {i + 1}")
        losses.append(loss)
        secs.append(dt)
        if i == 0:
            err = _check_grads("SAGE step 1", model, _grads(model), ref_grads)
            log(f"SAGE step 1: loss {loss:.6f} (reference {float(ref_loss):.6f}); max "
                f"|grad - reference| {err:.3e}")
    log(f"SAGE training losses {losses}; step seconds {[round(t, 3) for t in secs]} "
        "(step 1 decides, probes and prepares)")
    choices = _decisions(path)
    want = {f"{op}|F={f}" for op in ("spmm", "spmm_bwd_b") for f in (256, N_CLASSES)}
    if set(choices) != want:
        raise AssertionError(f"SAGE decisions {sorted(choices)} != {sorted(want)}")
    log(f"SAGE training decisions: {json.dumps(_decisions(path, probes=True))}")
    _train_step(model, loss_fn(sage), totals, device, "SAGE step with the deciding AutoSage",
                update=False)
    grads = _grads(model)
    del sage
    _empty_cache(device)
    replay = AutoSage(device=device, cache=ScheduleCache(path=str(path), replay_only=True))
    _train_step(model, loss_fn(replay), totals, device, "SAGE replay step", update=False)
    for n, g_r, g in zip([n for n, _ in model.named_parameters()], _grads(model), grads):
        check_equal(f"SAGE replayed grad {n}", g_r, g)
    a = norm_csr(graph)
    _check_replayed("SAGE", replay, path,
                    lambda op: a if op == "spmm" else a.transpose_with_perm()[0])
    log("replay-only AutoSage: the four SAGE decisions replayed; gradients bit-equal")
    del replay
    registry.clear_layout_memo()
    _empty_cache(device)
    _peak("phase 8 (SAGE training)", device)
    log(f"SAGE training launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


GAT_OPS = ("attention", "attention_bwd_e", "attention_bwd_p", "attention_bwd_q",
           "attention_bwd_k", "attention_bwd_v")


def _gat_loss(model, graph, x, sage):
    return lambda: 0.5 * (model(graph, x, sage=sage) ** 2).sum()


def _pinned_sddmm_step(tag, family, model, graph, x, ref_grads, path, totals, device) -> None:
    """A replay-only step with attention_bwd_e/_p pinned to ``family``
    (8x8, tile_slots 8) in a copy of ``path``: its kernel must launch for
    both ops and the weight gradients must match the reference."""
    from repro_torch.core import AutoSage, HardwareSpec, InputFeatures, ScheduleCache, registry

    entries = json.loads(Path(path).read_text())
    pinned_path = Path(path).with_name(f"pinned_{family}_{Path(path).name}")
    cache = ScheduleCache(path=str(pinned_path))
    feat = InputFeatures.from_csr(graph.structural(), D_ATTN, "attention_bwd_e")
    names = [v.full_name() for v in registry.candidates(feat, HardwareSpec.current(device), device)
             if v.name == family and v.knobs.get("rb") == 8
             and v.knobs.get("tile_slots", 8) == 8]
    if len(names) != 1:
        raise AssertionError(f"{tag} {family}: candidates {names}")
    for key, entry in entries.items():
        if key.split("|")[3] in ("attention_bwd_e", "attention_bwd_p"):
            entry = {**entry, "choice": names[0]}
        cache.put(key, entry)
    pinned = AutoSage(device=device, cache=ScheduleCache(path=str(pinned_path),
                                                         replay_only=True))
    model.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    _, got = counted(f"{tag} {family} pinned step", lambda: _backward(model, graph, x, pinned),
                     totals, device, grad=True)
    kernel = SDDMM_FAMILY_KERNEL[family]
    if got[kernel] < 2:
        raise AssertionError(f"{tag} {family}: {kernel} launched {got[kernel]} times")
    err = _check_grads(f"{tag} {family} pinned", model, _grads(model), ref_grads)
    log(f"pinned {family} for attention_bwd_e/_p ({tag}): {kernel} +{got[kernel]} launches, "
        f"max |grad - reference| {err:.3e}, {time.perf_counter() - t0:.1f} s incl. prepare")


def _backward(model, graph, x, sage):
    loss = _gat_loss(model, graph, x, sage)()
    loss.backward()
    return float(loss.detach())


def gat_train_phase(graph, device, workdir: Path) -> dict:
    """Phase 9. Returns the launch counts summed over its counted runs."""
    import copy

    import torch

    from repro_torch.core import AutoSage, ScheduleCache, registry
    from repro_torch.models.gnn import GAT
    from repro_torch.sparse import products_like

    _peak_reset(device)
    totals: dict = {}

    def reference(model, graph, x):
        ref_model = copy.deepcopy(model)
        t0 = time.perf_counter()
        loss = _backward(ref_model, graph, x, None)
        sync(device)
        return ref_model, loss, time.perf_counter() - t0

    model = GAT(IN_DIM, D_ATTN, seed=0, device=device)
    x = torch.randn(graph.n_rows, IN_DIM, generator=torch.Generator().manual_seed(2)).to(device)
    ref_model, ref_loss, dt = reference(model, graph, x)
    ref_grads = _grads(ref_model)
    log(f"GAT reference step (sage=None, csr_attention_bwd_ref): loss {ref_loss:.6f}, "
        f"{dt:.2f} s")
    path = workdir / "gat_train.json"
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(path)))
    losses, secs = [], []
    for i in range(3):
        loss, dt = _train_step(model, _gat_loss(model, graph, x, sage), totals, device,
                               f"GAT train step {i + 1}", lr=LR / graph.n_rows)
        losses.append(loss)
        secs.append(dt)
        if i == 0:
            err = _check_grads("GAT step 1", model, _grads(model), ref_grads)
            log(f"GAT step 1: loss {loss:.6f} (reference {ref_loss:.6f}); max "
                f"|grad - reference| {err:.3e}")
    log(f"GAT training losses {losses}; step seconds {[round(t, 3) for t in secs]} "
        "(step 1 decides, probes and prepares)")
    choices = _decisions(path)
    if sorted(k.split("|")[0] for k in choices) != sorted(GAT_OPS):
        raise AssertionError(f"GAT decisions {sorted(choices)}")
    log(f"GAT training decisions: {json.dumps(_decisions(path, probes=True))}")
    _train_step(model, _gat_loss(model, graph, x, sage), totals, device,
                "GAT step with the deciding AutoSage", update=False)
    grads = _grads(model)
    del sage
    _empty_cache(device)
    replay = AutoSage(device=device, cache=ScheduleCache(path=str(path), replay_only=True))
    _train_step(model, _gat_loss(model, graph, x, replay), totals, device, "GAT replay step",
                update=False)
    for n, g_r, g in zip([n for n, _ in model.named_parameters()], _grads(model), grads):
        check_equal(f"GAT replayed grad {n}", g_r, g)
    s_csr = graph.structural()
    _check_replayed("GAT", replay, path, lambda op: s_csr.transpose_with_perm()[0]
                    if op in ("attention_bwd_k", "attention_bwd_v") else s_csr)
    log("replay-only AutoSage: the six GAT decisions replayed; gradients bit-equal")
    del replay
    _empty_cache(device)
    for family in ("ragged_ell_cuda", "merge_path_cuda"):
        _pinned_sddmm_step("reddit", family, ref_model, graph, x, ref_grads, path, totals,
                           device)
        _empty_cache(device)
    del ref_model, model
    registry.clear_layout_memo()
    _empty_cache(device)
    _peak("phase 9 (GAT training, Reddit-0.25)", device)

    # dense-W leg: its gate (n_rows * deg_max * bc * 4 bytes) shuts it out
    # of Reddit-0.25; products_like keeps OGBN-Products' average degree
    _peak_reset(device)
    t0 = time.perf_counter()
    prod = products_like(PRODUCTS_SCALE, seed=0).dedup_edges()
    log(f"products_like({PRODUCTS_SCALE}, seed=0).dedup_edges(): {prod.n_rows} nodes, "
        f"{prod.nnz} edges, "
        f"max degree {int(prod.degrees.max())} ({time.perf_counter() - t0:.1f} s)")
    model = GAT(IN_DIM, D_ATTN, seed=0, device=device)
    x = torch.randn(prod.n_rows, IN_DIM, generator=torch.Generator().manual_seed(3)).to(device)
    ref_model, ref_loss, _ = reference(model, prod, x)
    ref_grads = _grads(ref_model)
    path = workdir / "gat_products.json"
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(path)))
    loss, dt = _train_step(model, _gat_loss(model, prod, x, sage), totals, device,
                           "GAT products step 1", update=False)
    err = _check_grads("GAT products step 1", model, _grads(model), ref_grads)
    log(f"GAT products step: loss {loss:.6f} (reference {ref_loss:.6f}), max |grad - "
        f"reference| {err:.3e}, {dt:.1f} s; decisions {json.dumps(_decisions(path))}")
    del sage
    _pinned_sddmm_step("products", "block_ell_cuda", ref_model, prod, x, ref_grads, path,
                       totals, device)
    del ref_model, model
    registry.clear_layout_memo()
    _empty_cache(device)
    _peak("phase 9 (GAT training, products leg)", device)
    log(f"GAT training launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ----------------------------------------------------------- phase 10
def _softmax_traps(rb, bc, w, seed):
    """(logits, mask) on the row softmax's traps: row block 0 fully
    masked, row 1 of block 2 fully masked inside a live block, a row of
    finfo.min logits (row 3 of block 2: the Pallas kernel and hence the
    port give all zeros there), NaN and +-inf logits on masked cells,
    logits x5 and +-80, mask values -1, 0.5 and 2 (the test is > 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (6 if w < 2048 else 3, w, rb, bc)
    vals = (rng.standard_normal(shape) * 5).astype(np.float32)
    vals[1] = rng.choice([-80.0, 80.0], size=shape[1:])
    mask = rng.choice([-1.0, 0.0, 0.5, 1.0, 2.0], size=shape,
                      p=[0.1, 0.35, 0.15, 0.3, 0.1]).astype(np.float32)
    mask[0] = 0.0
    mask[2, :, 1, :] = 0.0
    vals[2, :, 3, :] = np.finfo(np.float32).min
    mask[2, :, 3, :2] = 1.0
    dead = mask <= 0
    for bad in (np.nan, np.inf, -np.inf):
        vals[dead & (rng.random(shape) < 0.3)] = bad
    return vals, mask


def _masked_cells_plus_zero(name, out, mask) -> None:
    """Every cell whose mask is <= 0 holds +0.0 (in chunks)."""
    import torch

    o, m = out.reshape(-1), mask.reshape(-1)
    step = 1 << 26
    for i in range(0, o.numel(), step):
        oc, dead = o[i:i + step], m[i:i + step] <= 0
        if bool(((oc != 0) | torch.signbit(oc))[dead].any()):
            raise AssertionError(f"{name}: a masked cell is not +0.0")


def softmax_edge_cases(device) -> None:
    """The row softmax kernel against its plain version on its traps, at
    every blocking and W = 1, 3 and 2048; two launches bit-equal."""
    import torch

    from repro_torch.kernels import softmax as ksm

    for rb, bc in BLOCKINGS:
        for w in (1, 3, 2048):
            tag = f"row softmax traps rb={rb} bc={bc} W={w}"
            vals, mask = (torch.from_numpy(a).to(device)
                          for a in _softmax_traps(rb, bc, w, seed=w + rb))
            got = ksm.row_softmax_block_ell(vals, mask)
            sync(device)
            check_close(tag, got, ksm.row_softmax_block_ell_plain(vals, mask))
            _masked_cells_plus_zero(tag, got, mask)
            if bool(got[2, :, 3].any()):
                raise AssertionError(f"{tag}: the finfo.min row is not all zeros")
            check_equal(f"{tag} run twice", got, ksm.row_softmax_block_ell(vals, mask))
    log("row softmax traps: masked rows and row blocks, NaN/inf on masked cells, logits "
        "x5 and +-80, a finfo.min row (all zeros), mask values -1/0.5/2; W=1,3,2048; "
        "blockings 8x8/16x8/8x16: ok")


def ops_edge_cases(device) -> None:
    """ops.spmm ("cuda", "ragged") and ops.csr_attention("ragged") on the
    edge-case graphs against impl="ref"."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32),
                rng.standard_normal(int(deg.sum())).astype(np.float32), deg.size, 70)
    graphs = (("empty-blocks", empty), ("single-hub", single_hub(HUB_N, nnz_frac=0.9, seed=1)),
              ("hub-skew", hub_skew(3000, 4, 0.05, 300, seed=2)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for tag, csr in graphs:
            for f in (41, 256):
                b = torch.randn(csr.n_cols, f, generator=torch.Generator().manual_seed(f))
                b = b.to(device)
                want = ops.spmm(csr, b, impl="ref")
                for impl in ("cuda", "ragged"):
                    check_close(f"ops.spmm {tag} F={f} impl={impl}", ops.spmm(csr, b, impl=impl),
                                want)
            dedup = CSR(csr.rowptr, csr.colind, None, csr.n_rows, csr.n_cols).dedup_edges()
            q, k, v = _qkv(dedup, 64, device, seed=17)
            check_close(f"ops.csr_attention {tag} impl=ragged",
                        ops.csr_attention(dedup, q, k, v, impl="ragged"),
                        ops.csr_attention(dedup, q, k, v, impl="ref"))
    log("ops edge cases: spmm cuda/ragged (F=41,256) and csr_attention ragged against "
        "impl='ref' on empty row blocks, a single hub and hub_skew: ok")


def ops_phase(graph, device, reps: int) -> tuple:
    """Phase 10. Returns (the row softmax kernel's record, the launch
    counts of its counted runs)."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.core import registry
    from repro_torch.core.probe import time_callable
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import ops
    from repro_torch.kernels import softmax as ksm
    from repro_torch.kernels import spmm as ks

    softmax_edge_cases(device)
    ops_edge_cases(device)
    totals: dict = {}
    q, k, v = _qkv(graph, D_ATTN, device, seed=13)
    t0 = time.perf_counter()
    aux = registry._prep_sddmm_dense(graph, 8, 8)
    colblk, mask, edge_flat = (torch.from_numpy(aux[key]).to(device)
                               for key in ("colblk", "mask", "edge_flat"))
    del aux
    nrb, w = colblk.shape
    sync(device)
    log(f"dense-W 8x8 mask and edge index: nrb={nrb} W={w} "
        f"({time.perf_counter() - t0:.1f} s host conversion + upload)")
    scale = D_ATTN ** -0.5

    def chain():
        ts = [time.perf_counter()]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            logits = ops.sddmm(graph, q, k, impl="cuda")
            logits.mul_(scale)
            sync(device)
            ts.append(time.perf_counter())
            probs = ops.row_softmax(logits, mask)
            sync(device)
            ts.append(time.perf_counter())
        out = ks.spmm_block_ell(colblk, probs, v, n_rows=graph.n_rows)
        sync(device)
        ts.append(time.perf_counter())
        log("ops chain seconds: sddmm (host conversion included) "
            f"{ts[1] - ts[0]:.2f}, row_softmax {ts[2] - ts[1]:.3f}, dense-W spmm "
            f"{ts[3] - ts[2]:.3f}")
        return logits, probs, out

    (logits, probs, composed), got = counted(
        "ops chain: sddmm -> row_softmax -> dense-W spmm", chain, totals, device)
    for name in ("sddmm_block_ell", "row_softmax_block_ell", "spmm_block_ell"):
        if got[name] != 1:
            raise AssertionError(f"ops chain: {name} launched {got[name]} times")
    want = ksm.row_softmax_block_ell_plain(logits, mask)
    err = check_close("row_softmax_block_ell vs plain", probs, want)
    del want
    _empty_cache(device)
    _masked_cells_plus_zero("row_softmax_block_ell at Reddit-0.25", probs, mask)
    check_equal("row_softmax_block_ell run twice", probs, ksm.row_softmax_block_ell(logits, mask))
    _empty_cache(device)
    rowptr, colind = (torch.from_numpy(a).to(device) for a in (graph.rowptr, graph.colind))
    logits_csr = logits.view(-1).index_select(0, edge_flat)
    probs_csr = kb.row_softmax({"rowptr": rowptr, "colind": colind}, logits_csr)
    err_csr = check_close("probabilities in CSR order vs baselines.row_softmax",
                          probs.view(-1).index_select(0, edge_flat), probs_csr)
    log(f"row softmax at Reddit-{SCALE}: max |kernel - plain| {err:.3e}; masked and padded "
        f"cells +0.0; second launch bit-equal; in CSR order max |kernel - "
        f"baselines.row_softmax| {err_csr:.3e}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fused, _ = counted("ops.csr_attention(impl='cuda')",
                           lambda: ops.csr_attention(graph, q, k, v, impl="cuda"), totals,
                           device)
    err_pipe = check_close("composed sddmm -> row_softmax -> spmm vs fused attention",
                           composed, fused)
    log(f"paper's composed pipeline from three hand kernels vs the fused kernel: max "
        f"|composed - fused| {err_pipe:.3e}")
    del fused, composed, edge_flat
    _empty_cache(device)

    ms = time_callable(lambda: ksm.row_softmax_block_ell(logits, mask), device,
                       iters=reps).median_ms
    plain_ms = time_callable(lambda: ksm.row_softmax_block_ell_plain(logits, mask), device,
                             iters=1).median_ms
    _empty_cache(device)
    rows = torch.repeat_interleave(torch.arange(graph.n_rows, device=device),
                                   torch.diff(rowptr.long()))
    with warnings.catch_warnings():  # torch warns that it checks no invariants
        warnings.simplefilter("ignore", UserWarning)
        a_lib = torch.sparse_coo_tensor(torch.stack([rows, colind.long()]), logits_csr,
                                        (graph.n_rows, graph.n_cols), is_coalesced=True,
                                        check_invariants=False)
    del rows
    try:
        lib_out = torch.sparse.softmax(a_lib, 1)
        lib_err = float((lib_out.values() - probs_csr).abs().max())
        del lib_out
        lib_ms = time_callable(lambda: torch.sparse.softmax(a_lib, 1), device,
                               iters=reps).median_ms
        log(f"torch.sparse.softmax (COO, dim 1) on the {graph.nnz} real edges: {lib_ms} ms, "
            f"max |library - baselines.row_softmax| {lib_err:.3e}")
    except RuntimeError as exc:  # the yardstick only: the port never calls it
        lib_ms = None
        log(f"torch.sparse.softmax refused on {device}: {exc}")
    del a_lib
    byts = 3 * logits.numel() * 4  # logits and mask read once, probabilities written once
    flops = 4.0 * graph.nnz  # max, exp, sum, divide per live cell
    record = {
        "name": "row_softmax_block_ell", "route": "cuda",
        "source": "src/repro_torch/csrc/softmax.cu",
        "replaces": REPLACES["row_softmax_block_ell"], "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
        "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
        "library_ms": lib_ms,
    }
    log(f"  row_softmax_block_ell 8x8 D={D_ATTN}: {json.dumps(record)}")
    log(f"ops entry point launches (sum of the counted runs): {json.dumps(totals)}")
    return record, totals


# ----------------------------------------------------------- phase 11
MINIBATCH = 1024  # examples/train_gnn.py --minibatch 1024
PROBE_BUDGET_MS = 2000.0  # its --probe-budget-ms default
PIN_STEPS = 3
DRIFT_GRAPHS = 64


def _minibatch_scheduler(device, path, replay=False):
    from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache

    sage = AutoSage(device=device, cache=ScheduleCache(path=path, replay_only=replay),
                    probe_iters=2, probe_cap_ms=200, probe_frac=0.25)
    return BatchScheduler(sage, probe_budget_ms=PROBE_BUDGET_MS)


def _pin_minibatch(family, graph, rows_seq, device, path, alpha) -> None:
    """Bucket entries choosing ``family`` (8x8, tile_slots 8) for the
    spmm and spmm_bwd_b buckets of the first PIN_STEPS row sets."""
    from repro_torch.core import (
        HardwareSpec,
        InputFeatures,
        ScheduleBucket,
        ScheduleCache,
        device_sig,
        registry,
    )
    from repro_torch.models.gnn import norm_csr

    pins = ScheduleCache(path=str(path))
    hw, dsig = HardwareSpec.current(device), device_sig(device)
    for rows in rows_seq[:PIN_STEPS]:
        a = norm_csr(graph.row_slice(rows))
        for op, g in (("spmm", a), ("spmm_bwd_b", a.transpose_with_perm()[0])):
            feat = InputFeatures.from_csr(g, D_ATTN, op)
            names = [v.full_name() for v in registry.candidates(feat, hw, device)
                     if v.name == family and v.knobs.get("rb") == 8
                     and v.knobs.get("bc") == 8 and v.knobs.get("tile_slots", 8) == 8]
            if len(names) != 1:
                raise AssertionError(f"{family} for {op}: candidates {names}")
            sig = ScheduleBucket.from_features(feat, dsig).sig()
            pins.put(ScheduleCache.bucket_key(dsig, sig, D_ATTN, op, alpha),
                     {"choice": names[0], "probe_ms": {}, "estimates_ms": {}})


def minibatch_phase(graph, device, workdir: Path) -> dict:
    """Phase 11. Returns the launch counts summed over its counted runs."""
    import copy

    import torch

    from repro_torch.core.probe import _timed_ms
    from repro_torch.models.gnn import SAGE, norm_csr
    from repro_torch.sparse import regime_shift_stream
    from repro_torch.train_gnn import make_data, minibatch_rows, minibatch_step

    feats, labels = make_data(graph, N_CLASSES, IN_DIM, seed=0)
    x, y = torch.from_numpy(feats).to(device), torch.from_numpy(labels).to(device)
    model = SAGE(IN_DIM, N_CLASSES, seed=0, device=device)
    init = copy.deepcopy(model)
    steps = graph.n_rows // MINIBATCH
    rows_seq = minibatch_rows(graph.n_rows, MINIBATCH, steps, seed=1)
    sub = graph.row_slice(rows_seq[0])
    log(f"minibatch: {steps} steps of {MINIBATCH} rows; step 1's sub-adjacency "
        f"{sub.n_rows} x {sub.n_cols}, {sub.nnz} edges")
    ref_grads = []
    t0 = time.perf_counter()
    for rows in rows_seq[:PIN_STEPS]:
        m = copy.deepcopy(init)
        minibatch_step(m, graph, x, y, rows, None, update=False)
        ref_grads.append(_grads(m))
    log(f"reference minibatch gradients (sage=None) of steps 1-{PIN_STEPS}: "
        f"{time.perf_counter() - t0:.2f} s")
    totals: dict = {}
    path = str(workdir / "minibatch.json")
    bs = _minibatch_scheduler(device, path)
    losses, step_ms = [], []

    def epoch():
        with bs:  # finalize() pins every bucket decision at the end
            for i, rows in enumerate(rows_seq):
                loss, ms = minibatch_step(model, graph, x, y, rows, bs, LR)
                if not math.isfinite(loss):
                    raise AssertionError(f"minibatch step {i + 1}: loss {loss}")
                losses.append(loss)
                step_ms.append(ms)
                if i == 0:
                    err = _check_grads("minibatch step 1", model, _grads(model), ref_grads[0])
                    log(f"minibatch step 1: loss {loss:.6f}, max |grad - reference| "
                        f"{err:.3e}")

    t0 = time.perf_counter()
    counted(f"minibatch epoch ({steps} steps)", epoch, totals, device, grad=True)
    log(f"minibatch epoch: {time.perf_counter() - t0:.1f} s; losses {losses}")
    log(f"minibatch step ms: first {step_ms[0]:.1f}, median of the rest "
        f"{statistics.median(step_ms[1:] or step_ms):.1f}, max {max(step_ms):.1f}")
    log(f"BatchScheduler stats: {json.dumps(bs.stats())}")
    for row in bs.bucket_stats():
        log(f"  bucket {row['op']} {row['bucket']}: hits={row['hits']} probed={row['probed']} "
            f"choice={row['choice']} probe_charge_ms={row['probe_charge_ms']} "
            f"reprobes={row['reprobes']}")

    finals = {st.key: st.current().choice for st in bs._buckets.values()}
    bs.auto_pump = False  # the deciding scheduler now serves its pinned decisions only
    rbs = _minibatch_scheduler(device, path, replay=True)
    t0 = time.perf_counter()
    for rows in rows_seq:
        a = norm_csr(graph.row_slice(rows))
        rbs.decide(a, D_ATTN, "spmm")
        rbs.decide(a.transpose_with_perm()[0], D_ATTN, "spmm_bwd_b")
    bad = [e for e in rbs.trace if e["choice"] != finals[e["key"]] or e["source"] != "bucket-cache"]
    if bad or len(rbs.trace) != 2 * steps or rbs.stats()["probes_run"]:
        raise AssertionError(f"minibatch replay: {len(bad)} decisions differ, "
                             f"{rbs.stats()}")
    log(f"replay-only BatchScheduler: all {len(rbs.trace)} decisions replayed from "
        f"{len(set(finals))} bucket entries ({time.perf_counter() - t0:.1f} s)")
    grads = {}
    for label, sched in (("deciding", bs), ("replay-only", rbs)):
        m = copy.deepcopy(init)
        counted(f"minibatch step 1, {label} scheduler",
                lambda m=m, s=sched: minibatch_step(m, graph, x, y, rows_seq[0], s, update=False),
                totals, device, grad=True)
        grads[label] = _grads(m)
    for n, g_r, g in zip([n for n, _ in model.named_parameters()], grads["replay-only"],
                         grads["deciding"]):
        check_equal(f"minibatch replayed grad {n}", g_r, g)
    log("replay-only BatchScheduler: step-1 gradients bit-equal to the deciding one's")

    for family in ("ragged_ell_cuda", "merge_path_cuda"):
        pinned_path = workdir / f"minibatch_pinned_{family}.json"
        _pin_minibatch(family, graph, rows_seq, device, pinned_path, bs.sage.alpha)
        pbs = _minibatch_scheduler(device, str(pinned_path), replay=True)
        kernel = FAMILY_KERNEL[family]
        errs = []
        for i, rows in enumerate(rows_seq[:PIN_STEPS]):
            m = copy.deepcopy(init)
            _, got = counted(f"{family} pinned minibatch step {i + 1}",
                             lambda m=m, r=rows: minibatch_step(m, graph, x, y, r, pbs,
                                                                update=False),
                             totals, device, grad=True)
            if got[kernel] < 2:
                raise AssertionError(f"{family}: {kernel} launched {got[kernel]} times")
            errs.append(_check_grads(f"{family} pinned step {i + 1}", m, _grads(m),
                                     ref_grads[i]))
        log(f"pinned {family} for spmm and spmm_bwd_b: {kernel} launched every step; max "
            f"|grad - reference| {max(errs):.3e}")
        _empty_cache(device)

    stream = regime_shift_stream(DRIFT_GRAPHS, MINIBATCH, seed=0)
    dbs = _minibatch_scheduler(device, None)
    gen = torch.Generator().manual_seed(21)
    observed = []

    def drift():
        for g in stream:
            b = torch.randn(g.n_cols, D_ATTN, generator=gen).to(device)
            d = dbs.decide(g, D_ATTN, "spmm")
            run_ = dbs.build_runner(g, d)
            observed.append(_timed_ms(lambda: run_(b), device))  # CUDA events on the card
            dbs.observe(dbs.last_bucket, observed[-1])

    counted(f"drift leg (regime_shift_stream({DRIFT_GRAPHS}, {MINIBATCH}))", drift, totals,
            device)
    s = dbs.stats()
    charges = [r["probe_charge_ms"] for r in dbs.bucket_stats()]
    log(f"drift leg: {json.dumps(s)}; observed ms first/last "
        f"{observed[0]:.3f}/{observed[-1]:.3f}")
    if s["drift_reprobes"] > s["drift_flags"] or s["drift_flips"] > s["drift_reprobes"]:
        raise AssertionError(f"drift counters: {s}")
    if s["probe_spent_ms"] > s["probe_budget_ms"] + max(charges, default=0.0):
        raise AssertionError(f"a probe started after the budget was spent: {s}")
    log(f"minibatch training launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ----------------------------------------------------------- phase 12
F_FLEET = 256  # configs/gnn_sage width
FAULT_CALLS = 3  # faulted runner calls of 12a, = AUTOSAGE_BREAKER_N
QUARANTINE_TTL_S = 8.0
PROBE_TIMEOUT_S, HANG_S = 5.0, 8.0
TRANSFER_SCALE = 0.02  # products_like: 48,980 nodes, probed on the CPU
# the CPU donor probes the hand-kernel families too (their plain versions)
DONOR_ENV = {"AUTOSAGE_PROBE_PALLAS": "1"}
FLEET_SCALE = 0.05  # reddit_like nodes for the fleet's trainers
FLEET_TIMEOUT_S = 400


def _faults_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in fault_counts().items()}


def _ref_spmm(csr, b, device):
    """ref.spmm_ref of ``csr`` times ``b`` on ``device``."""
    from repro_torch.core import resilience

    return resilience.reference_runner(csr, "spmm", device)(b)


def _variant_name(family, feat, hw, device) -> str:
    from repro_torch.core import registry

    names = [v.full_name() for v in registry.candidates(feat, hw, device)
             if v.name == family and v.knobs.get("rb", 8) == 8 and v.knobs.get("bc", 8) == 8
             and v.knobs.get("tile_slots", 8) == 8]
    if len(names) != 1:
        raise AssertionError(f"{family}: candidates {names}")
    return names[0]


def fault_phase(graph, device, workdir: Path, totals: dict) -> None:
    """12a: run faults injected on a pinned ragged_ell_cuda through the
    fallback chain, the quarantine and its effect, TTL recovery, and a
    hung probe abandoned by the watchdog."""
    import threading

    import torch

    from repro_torch.core import (
        AutoSage,
        InputFeatures,
        ReplayMiss,
        ScheduleCache,
        device_sig,
        faultinject,
        obs,
        registry,
    )
    from repro_torch.models.gnn import norm_csr

    a = norm_csr(graph)
    b = torch.randn(a.n_cols, F_FLEET, generator=torch.Generator().manual_seed(12)).to(device)
    want = _ref_spmm(a, b, device)
    path = workdir / "fault.json"
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(path)))
    feat = InputFeatures.from_csr(a, F_FLEET, "spmm")
    choice = _variant_name("ragged_ell_cuda", feat, sage.hw, device)
    dsig = device_sig(device)
    key = ScheduleCache.key(dsig, feat.graph_sig, F_FLEET, "spmm", sage.alpha)
    sage.cache.put(key, {"choice": choice, "probe_ms": {}, "estimates_ms": {}})
    kernel = "spmm_ragged_ell"
    with env(AUTOSAGE_FAULT_RETRIES="0", AUTOSAGE_BREAKER_N=str(FAULT_CALLS),
             AUTOSAGE_QUARANTINE_TTL_S=str(QUARANTINE_TTL_S)):
        d = sage.decide(a, F_FLEET, "spmm")
        if not d.from_cache or d.choice != choice:
            raise AssertionError(f"12a pin: {d.choice} from_cache={d.from_cache}")
        runner = sage.build_runner(a, d)
        out, got = counted("12a pinned call, no fault", lambda: runner(b), totals, device)
        if got[kernel] != 1:
            raise AssertionError(f"12a: {kernel} launched {got[kernel]} times")
        check_close("12a pinned call", out, want)
        before = fault_counts()
        with env(AUTOSAGE_FAULT=f"run:ragged_ell_cuda:raise:{FAULT_CALLS}"):
            faultinject.reset()
            for i in range(FAULT_CALLS):
                out, got = counted(f"12a faulted call {i + 1}", lambda: runner(b), totals,
                                   device)
                if got[kernel]:
                    raise AssertionError(f"12a: {kernel} launched during a fault")
                check_close(f"12a faulted call {i + 1} (baseline)", out, want)
            fired = faultinject.fired()
        faultinject.reset()
        delta = _faults_since(before)
        log(f"12a: {FAULT_CALLS} injected run faults -> counters {json.dumps(delta)}, "
            f"injected {json.dumps({f'{s}:{k}': n for (s, k), n in fired.items()})}")
        if delta != {n: float(FAULT_CALLS) for n in FAULT_COUNTERS}:
            raise AssertionError(f"12a: fault/fallback counters {delta}, want {FAULT_CALLS}")
        if not sage.breaker.is_quarantined(choice):
            raise AssertionError(f"12a: {choice} not quarantined after {FAULT_CALLS} faults")
        since = sage.breaker.active_quarantine(choice)["since"]
        qkey = ScheduleCache.quarantine_key(dsig, choice)
        rec = json.loads(path.read_text()).get(qkey, {}).get("quarantine", {})
        if rec.get("state") != "active":
            raise AssertionError(f"12a: no active quarantine record {qkey} in the file")
        out, got = counted("12a quarantined call", lambda: runner(b), totals, device)
        if got[kernel]:
            raise AssertionError(f"12a: quarantined {kernel} launched")
        check_close("12a quarantined call (baseline)", out, want)
        fresh = AutoSage(device=device, cache=ScheduleCache(path=str(path)), top_k=1000)
        fresh.breaker.maybe_sync()
        _, short = fresh.shortlist(feat, registry.candidates(feat, fresh.hw, device))
        names = [v.full_name() for v in short]
        if choice in names or not names:
            raise AssertionError(f"12a: fresh shortlist {names}")
        replay = AutoSage(device=device, cache=ScheduleCache(path=str(path), replay_only=True))
        try:
            replay.decide(a, F_FLEET, "spmm")
        except ReplayMiss as exc:
            log(f"12a: replay-only decide raises ReplayMiss: {exc}")
        else:
            raise AssertionError("12a: replay of a quarantined pin did not raise")
        log(f"12a: {choice} quarantined (record in {path.name}); a fresh AutoSage "
            f"shortlists {len(names)} candidates without it")
        time.sleep(max(0.0, since + QUARANTINE_TTL_S + 0.5 - time.time()))
        out, got = counted("12a half-open call", lambda: runner(b), totals, device)
        if got[kernel] != 1 or sage.breaker.is_quarantined(choice):
            raise AssertionError(f"12a: recovery probe launched {got[kernel]}")
        check_close("12a recovered call", out, want)
        rec = json.loads(path.read_text())[qkey]["quarantine"]
        if rec["state"] != "cleared":
            raise AssertionError(f"12a: quarantine record {rec}")
        log(f"12a: after the {QUARANTINE_TTL_S:g} s TTL the half-open call ran {kernel} "
            f"and cleared the record")

    # a hung probe: the first probe of a cold decide (the baseline's)
    # sleeps past the watchdog, which abandons it; decide still returns
    before = fault_counts()
    timeouts0 = obs.REGISTRY.total("autosage_faults_total", site="probe", kind="timeout")
    cold = AutoSage(device=device, cache=ScheduleCache(path=None))
    with env(AUTOSAGE_FAULT="probe::hang:1", AUTOSAGE_FAULT_HANG_S=str(HANG_S),
             AUTOSAGE_PROBE_TIMEOUT_S=str(PROBE_TIMEOUT_S)):
        faultinject.reset()
        t0 = time.perf_counter()
        d = cold.decide(a, F_FLEET, "spmm")
        dt = time.perf_counter() - t0
        faultinject.reset()
    timeouts = (obs.REGISTRY.total("autosage_faults_total", site="probe", kind="timeout")
                - timeouts0)
    if timeouts < 1 or "baseline" in d.probe_ms:
        raise AssertionError(f"12a hang: {timeouts} probe timeouts, probe_ms {d.probe_ms}")
    for t in threading.enumerate():
        if t.name.startswith("watchdog-"):
            t.join(HANG_S + 60)
    out, got = counted("12a call after the hung probe", lambda: cold.build_runner(a, d)(b),
                       totals, device)
    check_close("12a after the hung probe", out, want)
    log(f"12a hang: baseline probe hung {HANG_S:g} s past the {PROBE_TIMEOUT_S:g} s watchdog; "
        f"decide returned {d.choice} in {dt:.1f} s (probe_ms {json.dumps(d.probe_ms)}); "
        f"counters {json.dumps(_faults_since(before))}")


def legacy_phase(dedup, device, workdir: Path, totals: dict) -> None:
    """12b: the legacy per-op "csr_attention" op decides the baseline, and
    a legacy-key entry pinned to the ragged fused kernel replays it."""
    from repro_torch.core import AutoSage, InputFeatures, ScheduleCache, device_sig, resilience

    q, k, v = _qkv(dedup, D_ATTN, device, seed=12)
    want = resilience.reference_runner(dedup, "attention", device)(q, k, v)  # csr_attention_ref
    before = fault_counts()
    sage = AutoSage(device=device, cache=ScheduleCache(path=str(workdir / "legacy.json")))
    d = sage.decide(dedup, D_ATTN, "csr_attention")
    if d.choice != "baseline" or d.estimates_ms:
        raise AssertionError(f"12b: legacy decide chose {d.choice} {d.estimates_ms}")
    out, _ = counted("12b legacy decide's runner", lambda: sage.build_runner(dedup, d)(q, k, v),
                     totals, device)
    err = check_close("12b legacy baseline vs csr_attention_ref", out, want)
    log(f"12b: decide(op='csr_attention') -> {d.choice} ({d.variant.full_name()}), as in the "
        f"JAX package (its estimate branch costs no attention candidate, so decide's "
        f"rescue serves it; counters {json.dumps(_faults_since(before))}); max err {err:.3e}")
    feat = InputFeatures.from_csr(dedup, D_ATTN, "csr_attention")
    name = _variant_name("ragged_attention_cuda", feat, sage.hw, device)
    path = workdir / "legacy_pinned.json"
    ScheduleCache(path=str(path)).put(
        ScheduleCache.key(device_sig(device), feat.graph_sig, D_ATTN, "csr_attention",
                          sage.alpha),
        {"choice": name, "probe_ms": {}, "estimates_ms": {}})
    replay = AutoSage(device=device, cache=ScheduleCache(path=str(path), replay_only=True))
    t0 = time.perf_counter()
    d = replay.decide(dedup, D_ATTN, "csr_attention")
    out, got = counted("12b pinned legacy replay",
                       lambda: replay.build_runner(dedup, d)(q, k, v), totals, device)
    if not d.from_cache or d.choice != name or got["fused_ragged_attention"] != 1:
        raise AssertionError(f"12b replay: {d.choice}, launches {got}")
    err = check_close("12b pinned fused kernel vs csr_attention_ref", out, want)
    log(f"12b: legacy entry pinned to {name} replays the fused kernel "
        f"({time.perf_counter() - t0:.1f} s incl. prepare), max err {err:.3e}")


def transfer_phase(device, workdir: Path, totals: dict) -> None:
    """12c: a CPU donor (the port itself, device='cpu') probes spmm on
    products_like(0.02); the card then decides the same key with the
    transfer tier on and, on a copy of the donor file, with it off."""
    import shutil

    import torch

    from repro_torch.core import AutoSage, ScheduleCache, obs
    from repro_torch.models.gnn import norm_csr
    from repro_torch.sparse import products_like

    g = norm_csr(products_like(TRANSFER_SCALE, seed=0))
    donor_path, off_path = workdir / "transfer.json", workdir / "transfer_off.json"
    with env(**DONOR_ENV):
        donor = AutoSage(device="cpu", cache=ScheduleCache(path=str(donor_path)))
        t0 = time.perf_counter()
        dd = donor.decide(g, F_FLEET, "spmm")
        t_donor = time.perf_counter() - t0
    log(f"12c donor (CPU, {g.n_rows} nodes, {g.nnz} edges, F = {F_FLEET}): chose {dd.choice} "
        f"in {t_donor:.1f} s; probe_ms {json.dumps(dd.probe_ms)}")
    shutil.copy(donor_path, off_path)
    b = torch.randn(g.n_cols, F_FLEET, generator=torch.Generator().manual_seed(13)).to(device)
    want = _ref_spmm(g, b, device)
    results = {}
    for label, path, flag in (("transfer on", donor_path, "1"), ("transfer off", off_path, "0")):
        with env(AUTOSAGE_TRANSFER=flag):
            sage = AutoSage(device=device, cache=ScheduleCache(path=str(path)))
            passes0 = obs.REGISTRY.total("autosage_probe_passes_total", op="spmm")
            t0 = time.perf_counter()
            d = sage.decide(g, F_FLEET, "spmm", allow_transfer=True)
            t_cold = time.perf_counter() - t0
            passes = obs.REGISTRY.total("autosage_probe_passes_total", op="spmm") - passes0
        out, _ = counted(f"12c {label} runner", lambda: sage.build_runner(g, d)(b), totals,
                         device)
        err = check_close(f"12c {label} vs reference", out, want)
        tier = "transfer" if d.transfer and not d.probe_ms else "probe"
        verdict = f" ({d.transfer['verdict']})" if d.transfer else ""
        results[label] = (d, t_cold)
        log(f"12c {label}: tier {tier}{verdict}, choice {d.choice}, {int(passes)} probe "
            f"passes timing {len(d.probe_ms)} candidates, cold decide {t_cold:.3f} s, "
            f"max err {err:.3e}")
        if tier == "transfer" and passes:
            raise AssertionError(f"12c: a confident transfer ran {passes} probes")
    d_on, d_off = results["transfer on"][0], results["transfer off"][0]
    if d_on.transfer is None or d_off.transfer is not None:
        raise AssertionError(f"12c: transfer provenance on={d_on.transfer} off={d_off.transfer}")
    pred = d_on.transfer["predicted_ms"]
    probe = d_on.probe_ms or d_off.probe_ms
    log("12c predicted ms (CPU ranking re-ranked for the card) vs the card's probe ms: "
        + json.dumps({n: [pred[n], probe.get(n)] for n in pred}))
    log(f"12c cold decide: transfer on {results['transfer on'][1]:.3f} s, off "
        f"{results['transfer off'][1]:.3f} s; rank agreement "
        f"{d_on.transfer['rank_agreement']}, donor choice {d_on.transfer['peer_choice']}")


def _run_cmd(cmd, timeout_s, env=None):
    """Run ``cmd`` in a session of its own, with ``env`` added to the
    environment; on timeout kill the whole group (the fleet's workers,
    a torch.distributed.run's ranks too). Returns (rc, stdout, stderr)."""
    import signal

    envv = {**os.environ, **(env or {}), "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(cmd, env=envv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} timed out after {timeout_s} s: {err[-2000:]}")
    return proc.returncode, out, err


def fleet_phase(device, workdir: Path) -> None:
    """12d: two minibatch trainers (train_gnn fleet mode) share one cache;
    one trainer alone on a fresh cache; a third process loads the merged
    file."""
    base = [sys.executable, "-m", "repro_torch.train_gnn", "--minibatch", str(MINIBATCH),
            "--epochs", "1", "--scale", str(FLEET_SCALE), "--device", device.type]
    runs = {}
    for label, extra in (("fleet", ["--workers", "2", "--shared"]),
                         ("lone", ["--workers", "1"])):
        t0 = time.perf_counter()
        rc, out, err = _run_cmd(base + extra + ["--cache", str(workdir / f"{label}.json")],
                                FLEET_TIMEOUT_S)
        if rc != 0:
            raise AssertionError(f"12d {label}: exit {rc}\n{out[-3000:]}\n{err[-3000:]}")
        runs[label] = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])[
            "workers"]
        keys = ("decides", "buckets", "probes_run", "warm_cache_opens", "probe_spent_ms",
                *FAULT_COUNTERS)
        log(f"12d {label}: {time.perf_counter() - t0:.1f} s; " + "; ".join(
            f"worker {i}: " + json.dumps({k: w[k] for k in keys})
            for i, w in enumerate(runs[label])))
    rc, out, err = _run_cmd(
        [sys.executable, "-c", "import sys; from repro_torch.core import ScheduleCache; "
         "print(len(ScheduleCache(path=sys.argv[1], replay_only=True)))",
         str(workdir / "fleet.json")], 120)
    if rc != 0 or int(out.strip() or 0) < 1:
        raise AssertionError(f"12d: merged cache does not load: {rc} {out} {err[-2000:]}")
    fleet, lone = runs["fleet"], runs["lone"][0]
    warm = sum(w["warm_cache_opens"] for w in fleet)
    probes = sum(w["probes_run"] for w in fleet)
    log(f"12d: merged cache loads in a third process ({out.strip()} entries); fleet warm "
        f"opens {warm}, fleet probes {probes} vs lone {lone['probes_run']}")
    if warm < 1 or probes >= 2 * lone["probes_run"]:
        raise AssertionError(f"12d: warm opens {warm}, probes {probes} vs lone "
                             f"{lone['probes_run']}")
    faulted = [w for w in fleet + [lone] if any(w[n] for n in FAULT_COUNTERS)]
    if faulted:
        raise AssertionError(f"12d: a worker faulted or fell back: {faulted}")


def fleet_cross_device_phase(graph, dedup, device, workdir: Path) -> dict:
    """Phase 12. Returns the launch counts summed over its counted runs."""
    from repro_torch.core import registry

    totals: dict = {}
    for label, fn, args in (("12a (fault injection)", fault_phase, (graph,)),
                            ("12b (legacy csr_attention)", legacy_phase, (dedup,)),
                            ("12c (decision transfer)", transfer_phase, ())):
        t0 = time.perf_counter()
        fn(*args, device, workdir, totals)
        log(f"== phase {label}: {time.perf_counter() - t0:.1f} s")
        registry.clear_layout_memo()
        _empty_cache(device)
    t0 = time.perf_counter()
    fleet_phase(device, workdir)
    log(f"== phase 12d (fleet): {time.perf_counter() - t0:.1f} s")
    log(f"phase 12 launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ----------------------------------------------------------- phase 13
SERVE_F = 256  # configs/gnn_sage width
SERVE_CLIENTS = 4
SERVE_SPMM_REQUESTS = 16  # per graph and pass
SERVE_CTX = 16384  # window + sink attention: queries = keys
SERVE_WINDOWS = (256, 512)
SERVE_SINKS = 4
SERVE_ATTN_REQUESTS = 4  # per window and pass
D_HEAD = 128  # configs/qwen3_14b head dimension
SERVE_PROBE_BUDGET_MS = 60_000.0
SERVE_DRAIN_S = 120.0
# benchmarks/tables.py serve_smoke: its four parent regimes, 48 sampled
# subgraphs of 256 rows, 3 clients, a 250 ms budget
SMOKE_PARENT_ROWS = 2048
SMOKE_REQUESTS = 48
SMOKE_ROWS = 256
SERVE_COUNTERS = ("autosage_serve_probe_errors_total", "autosage_serve_upgrade_cb_errors_total",
                  *FAULT_COUNTERS)


def _serve_clients(server, requests, n_clients, run=False):
    """Stride-partition ``requests`` ((csr, f, op, operands), ...) across
    ``n_clients`` threads submitting into one server; with ``run`` each
    client also runs the served decision on the request's operands.
    Returns (results, outputs) by request index; re-raises the first
    exception of a client."""
    import threading

    results, outs, errors = [None] * len(requests), [None] * len(requests), []

    def client(cid):
        try:
            for i in range(cid, len(requests), n_clients):
                g, f, op, operands = requests[i]
                results[i] = server.submit(g, f, op)
                if run:
                    outs[i] = server.run(g, results[i].decision)(*operands)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, outs


def _latency(results) -> str:
    """Nearest-rank p50 / p99 / max decision latency, as serve_stats."""
    lat = sorted(r.latency_ms for r in results)

    def q(p):
        return lat[min(int(p * len(lat)), len(lat) - 1)]

    return f"p50 {q(0.5):.3f} ms, p99 {q(0.99):.3f} ms, max {lat[-1]:.3f} ms"


def serve_contract_phase(device, workdir: Path) -> int:
    """13a: benchmarks/tables.py serve_smoke's contract at F = 256.
    Returns the requests served."""
    from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache
    from repro_torch.launch.serve import GNNServer, _serve_parents
    from repro_torch.sparse import sample_subgraph_stream

    stream = sample_subgraph_stream(_serve_parents(SMOKE_PARENT_ROWS, 4), SMOKE_REQUESTS,
                                    rows_per_graph=SMOKE_ROWS, seed=3)
    requests = [(g, SERVE_F, "spmm", ()) for g in stream]
    path = str(workdir / "serve_smoke.json")
    with env(AUTOSAGE_SERVE_BUDGET_MS="250"):
        bs = BatchScheduler(AutoSage(device=device, cache=ScheduleCache(path=path),
                                     probe_iters=1, probe_cap_ms=25, probe_frac=0.25),
                            probe_budget_ms=10_000)
        server = GNNServer(bs)
        pass1, _ = _serve_clients(server, requests, 3)
        if not server.drain(timeout_s=SERVE_DRAIN_S):
            raise AssertionError("13a: the background prober never drained")
        pass2, _ = _serve_clients(server, requests, 3)
        stats = server.close()
    finals = {r["bucket"]: r["choice"] for r in bs.bucket_stats()}
    rbs = BatchScheduler(AutoSage(device=device, cache=ScheduleCache(path=path, replay_only=True)))
    rserver = GNNServer(rbs)
    replayed = [rserver.submit(g, SERVE_F, "spmm") for g in stream]
    rstats = rserver.close(finalize=False)
    prov = {r.bucket for r in pass1 if r.tier == "provisional"}
    warm2 = {r.bucket for r in pass2 if r.tier == "warm"}
    log(f"13a serve_smoke contract ({len(stream)} subgraphs of {SMOKE_ROWS} rows, 3 clients, "
        f"F = {SERVE_F}, budget {stats['budget_ms']:.0f} ms): tiers "
        f"{json.dumps(stats['by_tier'])}, "
        f"stalls {stats['stalls']}, upgrades {stats['upgrades']}, buckets {stats['buckets']}; "
        f"decision latency p50 {stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms, max "
        f"{stats['max_ms']:.3f} ms; provisional in pass 1 and warm in pass 2: {len(prov & warm2)} "
        f"buckets; final choices {json.dumps(finals)}; replay probes "
        f"{rbs.stats()['probes_run']}, replay latency p99 {rstats['p99_ms']:.3f} ms")
    if stats["stalls"] or stats["by_tier"].get("cold", 0):
        raise AssertionError(f"13a: a request paid a probe inline: {stats}")
    if not stats["p99_ms"] < stats["budget_ms"]:
        raise AssertionError(f"13a: p99 decision latency over the budget: {stats}")
    if stats["upgrades"] < 1 or not prov & warm2:
        raise AssertionError(f"13a: no bucket upgraded in place: {stats}, {prov}, {warm2}")
    if (rbs.stats()["probes_run"] or any(r.tier != "warm" for r in replayed)
            or any(r.decision.choice != finals[r.bucket] for r in replayed)):
        raise AssertionError(f"13a: the replay differs: {rbs.stats()}, "
                             f"{[(r.tier, r.decision.choice) for r in replayed]}")
    return stats["requests"] + rstats["requests"]


def _serve_requests(graph, device):
    """13b's 40 requests per pass, interleaved so every client serves each
    kind: 16 SpMM requests on 1,024-row sub-adjacencies of ``graph`` and 16
    of products_like(0.02) at F = 256 (one shared B each), 8 attention
    requests on window + sink CSRs (D = 128, one shared q, k, v)."""
    import itertools

    import torch

    from repro_torch.models.gnn import norm_csr
    from repro_torch.sparse import products_like, sliding_window_csr
    from repro_torch.train_gnn import minibatch_rows

    gen = torch.Generator().manual_seed(31)
    kinds = []
    for parent, seed in ((graph, 1), (products_like(PRODUCTS_SCALE, seed=0), 2)):
        b = torch.randn(parent.n_cols, SERVE_F, generator=gen).to(device)
        rows = minibatch_rows(parent.n_rows, MINIBATCH, SERVE_SPMM_REQUESTS, seed=seed)
        kinds.append([(norm_csr(parent.row_slice(r)), SERVE_F, "spmm", (b,)) for r in rows])
    qkv = tuple(torch.randn(SERVE_CTX, D_HEAD, generator=gen).to(device) for _ in range(3))
    windows = [sliding_window_csr(SERVE_CTX, SERVE_CTX, w, n_global=SERVE_SINKS)
               for w in SERVE_WINDOWS]
    kinds.append([(g, D_HEAD, "attention", qkv) for g in windows
                  for _ in range(SERVE_ATTN_REQUESTS)])
    return [r for group in itertools.zip_longest(*kinds) for r in group if r is not None]


def _served_kernel(choice):
    family = choice.split("[")[0]
    return FAMILY_KERNEL.get(family) or ATTN_FAMILY_KERNEL.get(family)


def serve_full_width_phase(graph, device, workdir: Path, totals: dict) -> tuple:
    """13b: four clients, two passes and a replay pass of 40 requests
    each; every request runs its served decision and is held against the
    oracle. Returns (requests served, an attention bucket's cache key,
    the cache path)."""
    from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache, obs, resilience
    from repro_torch.launch.serve import GNNServer

    t0 = time.perf_counter()
    requests = _serve_requests(graph, device)
    wants = {}
    for g, _, op, operands in requests:
        if id(g) not in wants:
            wants[id(g)] = resilience.reference_runner(g, op, device)(*operands)
    sync(device)
    shapes = sorted({(g.n_rows, g.n_cols, op) for g, _, op, _ in requests})
    log(f"13b: {len(requests)} requests per pass over {len(wants)} graphs "
        f"({', '.join(f'{op} {n} x {m}' for n, m, op in shapes[:1] + shapes[-2:])}, ...), "
        f"edges {min(g.nnz for g, *_ in requests)}-{max(g.nnz for g, *_ in requests)}; "
        f"oracles {time.perf_counter() - t0:.1f} s")
    path = str(workdir / "serve.json")
    bs = BatchScheduler(AutoSage(device=device, cache=ScheduleCache(path=path), probe_iters=2,
                                 probe_cap_ms=200, probe_frac=0.25),
                        probe_budget_ms=SERVE_PROBE_BUDGET_MS)
    server = GNNServer(bs)
    passes = {}

    def serve(label, srv, drain=False):
        t0 = time.perf_counter()
        res, outs = _serve_clients(srv, requests, SERVE_CLIENTS, run=True)
        t1 = time.perf_counter()
        if drain and not srv.drain(timeout_s=SERVE_DRAIN_S):
            raise AssertionError(f"13b {label}: the background prober never drained: "
                                 f"{json.dumps(srv.bs.stats())}; {srv.bs.bucket_stats()}")
        sync(device)
        if drain:
            log(f"13b {label}: requests served in {t1 - t0:.1f} s, drained "
                f"{time.perf_counter() - t1:.1f} s later; {json.dumps(srv.bs.stats())}")
        passes[label] = (res, outs)
        tiers = {t: sum(r.tier == t for r in res) for t in sorted({r.tier for r in res})}
        log(f"13b {label}: {time.perf_counter() - t0:.1f} s; tiers {json.dumps(tiers)}; "
            f"decision latency {_latency(res)}")

    _, got1 = counted("13b pass 1", lambda: serve("pass 1", server, drain=True), totals, device)
    _, got2 = counted("13b pass 2", lambda: serve("pass 2", server), totals, device)
    stats = server.close()
    finals = {(st.bucket.op, st.bucket.sig()): st for st in bs._buckets.values()}
    for st in finals.values():
        d = st.current()
        log(f"13b bucket {st.bucket.op} {st.bucket.sig()}: hits {st.hits}, final {d.choice}, "
            f"probe charge {st.probe_charge_ms:.1f} ms, probe ms {json.dumps(d.probe_ms)}")
    for ev in server.upgrade_events:
        log(f"13b upgrade: {ev['op']} {ev['bucket']} -> {ev['choice']} "
            f"(probe {ev['probe_overhead_ms']:.1f} ms)")
    rbs = BatchScheduler(AutoSage(device=device,
                                  cache=ScheduleCache(path=path, replay_only=True)))
    rserver = GNNServer(rbs)
    _, got3 = counted("13b replay pass", lambda: serve("replay", rserver), totals, device)
    rstats = rserver.close(finalize=False)
    keys = ("requests", "by_tier", "stalls", "over_budget", "upgrades", "budget_ms", "p50_ms",
            "p99_ms", "max_ms", "buckets")
    log(f"13b session: {json.dumps({k: stats[k] for k in keys})}")

    errs = []
    for label, (res, outs) in passes.items():
        for i, ((g, _, op, _), r, out) in enumerate(zip(requests, res, outs)):
            errs.append(check_close(f"13b {label} request {i} ({op}, {r.decision.choice})",
                                    out, wants[id(g)]))
    rres, routs = passes["replay"]
    for i, (r2, r3) in enumerate(zip(passes["pass 2"][0], rres)):
        st = finals[(requests[i][2], r3.bucket)]
        if r3.tier != "warm" or r3.decision.choice != st.current().choice:
            raise AssertionError(f"13b replay request {i}: {r3.tier} {r3.decision.choice}, "
                                 f"final {st.current().choice}")
        if r2.decision.choice == r3.decision.choice:
            check_equal(f"13b replay request {i} vs pass 2", routs[i], passes["pass 2"][1][i])
    counters = {n: obs.REGISTRY.total(n) for n in SERVE_COUNTERS}
    served = [(ev["choice"], _served_kernel(ev["choice"])) for ev in server.upgrade_events]
    carried = sorted({c for c, k in served if k is not None and got2.get(k, 0) > 0})
    log(f"13b: max |served - oracle| {max(errs):.3e} over {len(errs)} runs; replay probes "
        f"{rbs.stats()['probes_run']}, outputs bit-equal to pass 2; counters "
        f"{json.dumps(counters)}; upgraded to a CUDA family that launched in pass 2: {carried}")
    for s in (stats, rstats):
        if s["stalls"] or s["by_tier"].get("cold", 0):
            raise AssertionError(f"13b: a request paid a probe inline: {s}")
    if any(counters.values()) or rbs.stats()["probes_run"]:
        raise AssertionError(f"13b: {counters}, replay {rbs.stats()}")
    if not carried:
        raise AssertionError(f"13b: no bucket upgraded to a CUDA family that launched in "
                             f"pass 2: upgrades {served}, pass 2 launches {got2}")
    attn = [st for st in finals.values() if st.bucket.op == "attention"]
    return stats["requests"] + rstats["requests"], attn[0].key, path


def serve_artifacts_phase(workdir: Path, attn_key: str, cache_path: str,
                          n_requests: int) -> None:
    """13c: the flight recorder's files, the obs_cli commands over them,
    and serve_events.jsonl."""
    obs_dir, merged = workdir / "obs", workdir / "merged_trace.json"
    cli = [sys.executable, "-m", "repro_torch.obs_cli"]
    rc, out, err = _run_cmd(cli + ["export-trace", "--obs", str(obs_dir), "--out", str(merged)],
                            120)
    trace = json.loads(merged.read_text()) if rc == 0 else {}
    names = {e["name"] for e in trace.get("traceEvents", [])}
    log(f"13c export-trace (rc {rc}): {out.strip()}; span names {sorted(names)}")
    if rc != 0 or not {"decide", "probe", "run"} <= names:
        raise AssertionError(f"13c export-trace: rc {rc}, names {sorted(names)}\n{err[-2000:]}")
    rc, out, err = _run_cmd(cli + ["summary", "--obs", str(obs_dir)], 120)
    log("13c obs_cli summary:\n" + "\n".join(
        ln for ln in out.splitlines() if "serve" in ln or ln.startswith("==") or "stall" in ln))
    if rc != 0 or "autosage_serve_requests_total" not in out:
        raise AssertionError(f"13c summary: rc {rc}\n{out[-2000:]}\n{err[-2000:]}")
    rc, out, err = _run_cmd(cli + ["explain", attn_key, "--cache", cache_path,
                                   "--telemetry", str(workdir)], 120)
    log(f"13c obs_cli explain {attn_key}:\n{out.rstrip()}")
    if rc != 0 or "pinned choice:" not in out or "live statistics" not in out:
        raise AssertionError(f"13c explain: rc {rc}\n{err[-2000:]}")
    events = [json.loads(ln) for ln in (workdir / "serve_events.jsonl").read_text().splitlines()]
    kinds = {k: sum(e["event"] == k for e in events) for k in ("request", "upgrade", "summary")}
    log(f"13c serve_events.jsonl: {json.dumps(kinds)} ({n_requests} requests served)")
    if kinds["request"] != n_requests or kinds["upgrade"] < 1 or kinds["summary"] < 1:
        raise AssertionError(f"13c serve_events.jsonl: {kinds}, {n_requests} requests")


def serve_phase(graph, device, workdir: Path) -> dict:
    """Phase 13. Returns the launch counts summed over its counted runs."""
    from repro_torch.core import obs, telemetry

    obs.reset()  # phase 13's counters alone: phase 12 injected faults
    sdir = workdir / "serve"
    totals: dict = {}
    try:
        with env(AUTOSAGE_OBS="1", AUTOSAGE_OBS_DIR=str(sdir / "obs"),
                 AUTOSAGE_TELEMETRY_DIR=str(sdir)):
            t0 = time.perf_counter()
            n_requests = serve_contract_phase(device, sdir)
            log(f"== phase 13a (serve_smoke contract): {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            n, attn_key, cache_path = serve_full_width_phase(graph, device, sdir, totals)
            n_requests += n
            log(f"== phase 13b (full-width serving): {time.perf_counter() - t0:.1f} s")
            paths = obs.flush()
            log(f"13c flush: {json.dumps(sorted(Path(p).name for p in paths.values()))}")
            if {"spans", "trace", "prom", "metrics"} - set(paths) or not all(
                    Path(p).is_file() for p in paths.values()):
                raise AssertionError(f"13c flush wrote {paths}")
        telemetry.close_streams()
        t0 = time.perf_counter()
        serve_artifacts_phase(sdir, attn_key, cache_path, n_requests)
        log(f"== phase 13c (artifacts): {time.perf_counter() - t0:.1f} s")
        counts = fault_counts()
        if any(counts.values()):
            raise AssertionError(f"phase 13: a fault or fallback: {counts}")
    finally:
        # no span may outlive the temporary directory: the recorder's
        # atexit flush would write them back into it
        telemetry.close_streams()
        obs.reset()
    log(f"phase 13 launches (sum of the counted runs): {json.dumps(totals)}")
    return totals


# ----------------------------------------------------------- phase 14
LM_ARCH = "qwen3_14b"  # configs/qwen3_14b at its published widths
LM_LAYERS = 4  # of 40: depth cut
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32
CHUNKED_BATCH, CHUNKED_PROMPT = 2, 2048  # two query chunks of REPRO_ATTN=chunked
LM_RTOL = 1e-3  # fp32 logits over layers 5120 / 17408 wide, products in other shapes
LONG_SHAPE = "long_500k"
LONG_LAYERS = 2  # of 40: depth cut
LONG_STEPS = 16
SLIDE_PROMPT = 4352  # > window 4096 + 128 sinks, so the window slides past the sinks
SLIDE_STEPS = 8
TIMING_REPS = 10
OTHER_PROMPT, OTHER_STEPS, OTHER_LONG_STEPS = 32, 4, 2
DEMO_LM_ARGS = ("demo-lm", "--arch", LM_ARCH, "--reduced", "--long-ctx")


def _lm_config(n_layers):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers)


def _long_shape() -> tuple:
    """(cache length, batch) of the long-context shape."""
    from repro_torch.configs import SHAPES

    return SHAPES[LONG_SHAPE].seq_len, SHAPES[LONG_SHAPE].global_batch


def _layer_params(cfg) -> int:
    """Weights of one attn_mlp layer: q, k, v, o, the SwiGLU and the norms."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return d * h * dh * 2 + d * hkv * dh * 2 + 3 * d * cfg.d_ff + 2 * d + 2 * dh


def _event_ms(fn, device, reps) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, CUDA events around each."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def decode_profile(tag, step, device, n=8) -> None:
    """The device's busy share over ``n`` calls of ``step`` (a decode step
    at a fixed position), from a torch.profiler trace: the kernels' summed
    time over the wall time, and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        log(f"{tag} profile: the trace holds no device time (busy share not measured)")
        return
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"{tag} profile over {n} steps: wall {wall_us / n / 1e3:.3f} ms/step, kernels "
        f"{busy / n / 1e3:.3f} ms/step, device busy {busy / wall_us:.1%}; top: "
        + "; ".join(f"{name[:60]} {us / n / 1e3:.3f} ms" for name, us in top))


def band_reference(model, cfg, tokens, cache):
    """A long_ctx decode step evaluated plainly: each layer attends over
    the whole cache with the CSR band's mask (the sinks [0, g) unmasked,
    the window [start, pos] less the sinks), where the port gathers the
    band. Writes the step's k and v rows, as the step itself does.
    Returns the logits (B, 1, V)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import attention as attn
    from repro_torch.models import modules as m
    from repro_torch.models import transformer as tr

    with torch.no_grad():
        x = F.embedding(tokens, model.embed)
        pos = cache["layers"][0]["pos"]
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.long, device=x.device)
        for blk, c in zip(model.blocks, cache["layers"]):
            h = m.rmsnorm(x, blk.ln1, cfg.norm_eps)
            q, k, v = attn._qkv(blk.attn, h, cfg, positions)
            m.write_along_seq(c["k"], k, pos)
            m.write_along_seq(c["v"], v, pos)
            length = c["k"].shape[1]
            g, w, start = attn.band(cfg, pos, length)
            kpos = torch.arange(length, device=x.device)
            ok = (kpos < g) | ((kpos >= start) & (kpos <= pos) & (kpos >= g))
            out = attn._sdpa(q, c["k"], c["v"], m.additive_mask(ok)[None, None, None, :],
                             1.0 / cfg.resolved_head_dim ** 0.5)
            x = x + m.linear(out, blk.attn.wo)
            x = x + m.swiglu(blk.ffn, m.rmsnorm(x, blk.ln2, cfg.norm_eps))
        return tr._logits(model, x, cfg)


def _band_steps(tag, model, cfg, tok, cache, steps, device) -> tuple:
    """``steps`` greedy long_ctx decode steps through api.decode_step, each
    held against band_reference first. Returns (tok, cache, max err)."""
    import torch

    from repro_torch.models import api

    worst = 0.0
    for i in range(steps):
        want = band_reference(model, cfg, tok, cache)
        logits, cache = api.decode_step(model, tok, cfg, cache, long_ctx=True, device=device)
        worst = max(worst, check_close(f"{tag} step {i}", logits, want, LM_RTOL))
        tok = torch.argmax(logits[:, -1], -1)[:, None]
    return tok, cache, worst


def lm_full_width_phase(device) -> None:
    """14a: Qwen3-14B at its published widths, 4 layers: prefill, greedy
    decode, teacher forcing, and the chunked prefill."""
    import torch

    from repro_torch.models import api

    cfg = _lm_config(LM_LAYERS)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    model = api.init_model(cfg, gen, torch.float32, device=device)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=device)
    sync(device)
    n_par = sum(p.numel() for p in model.parameters())
    log(f"14a {cfg.name} x {LM_LAYERS} layers: {n_par / 1e9:.3f} B fp32 parameters "
        f"({n_par * 4 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.1f} s")
    length = LM_PROMPT + LM_GEN
    prefill_s = []
    for _ in range(2):  # cold, then warm (a fresh cache each)
        cache = api.init_cache(cfg, LM_BATCH, length, torch.float32, device=device)
        sync(device)
        t0 = time.perf_counter()
        logits, cache = api.prefill(model, {"tokens": prompts}, cfg, cache, device=device)
        sync(device)
        prefill_s.append(time.perf_counter() - t0)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    steps, out = [logits], [tok]
    sync(device)
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        if i == LM_GEN // 2:  # this position's dicts, for the profile below
            at_mid = ({"layers": [dict(c) for c in cache["layers"]]}, tok)
        logits, cache = api.decode_step(model, tok, cfg, cache, device=device)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        steps.append(logits)
        out.append(tok)
    sync(device)
    decode_s = time.perf_counter() - t0
    if cache["layers"][0]["pos"] != length:
        raise AssertionError(f"14a: cache pos {cache['layers'][0]['pos']} != {length}")
    # teacher forcing: the prompt and the generated tokens in one forward
    seq = torch.cat([prompts] + out[:-1], dim=1)
    with torch.no_grad():
        full = api.forward(model, {"tokens": seq}, cfg, device=device)
    worst = 0.0
    for i, lg in enumerate(steps):
        worst = max(worst, check_close(f"14a logits {i} vs teacher forcing", lg[:, 0],
                                       full[:, LM_PROMPT - 1 + i], LM_RTOL))
        if not torch.isfinite(lg).all():
            raise AssertionError(f"14a: non-finite logits at step {i}")
    agree = float((full[:, LM_PROMPT - 1:].argmax(-1) == torch.cat(out, 1)).float().mean())
    del full
    # bounds: causal prefill FLOPs over fp32 peak; a decode step's bytes
    tokens = LM_BATCH * LM_PROMPT
    lin = LM_LAYERS * _layer_params(cfg)
    attn_flops = LM_LAYERS * 4 * LM_BATCH * cfg.n_heads * cfg.resolved_head_dim * (
        LM_PROMPT * (LM_PROMPT + 1) // 2)
    prefill_flops = 2 * tokens * lin + attn_flops + 2 * LM_BATCH * cfg.d_model * cfg.vocab
    kv_row = 2 * LM_LAYERS * cfg.n_kv_heads * cfg.resolved_head_dim * 4
    mid = LM_PROMPT + LM_GEN // 2
    step_bytes = (lin + cfg.d_model * cfg.vocab) * 4 + LM_BATCH * mid * kv_row
    ms_tok = decode_s / LM_GEN * 1e3
    log(f"14a prefill {LM_BATCH} x {LM_PROMPT} tokens: cold {prefill_s[0] * 1e3:.1f} ms, "
        f"warm {prefill_s[1] * 1e3:.1f} ms; bound {prefill_flops / FP32_FLOPS * 1e3:.1f} ms "
        f"({prefill_flops / 1e12:.2f} TFLOP / 67 TFLOP/s fp32)")
    log(f"14a decode {LM_GEN} steps x batch {LM_BATCH}: {decode_s * 1e3:.1f} ms, "
        f"{ms_tok:.3f} ms/step, {LM_BATCH * LM_GEN / decode_s:.1f} tokens/s; bound "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step ({step_bytes / 1e9:.2f} GB of "
        f"weights and KV / 3.35 TB/s)")
    log(f"14a teacher forcing: {LM_GEN + 1} logits rows within {LM_RTOL} (max err "
        f"{worst:.3e}); greedy tokens equal to the forward's argmax {agree:.4f}")
    decode_profile("14a decode", lambda: api.decode_step(model, at_mid[1], cfg, at_mid[0],
                                                         device=device), device)
    # REPRO_ATTN=chunked prefill (cache length == prompt: two query chunks)
    p2 = prompts[:CHUNKED_BATCH].repeat(1, CHUNKED_PROMPT // LM_PROMPT)
    res = {}
    for mode in ("naive", "chunked"):
        with env(REPRO_ATTN=mode):
            c = api.init_cache(cfg, CHUNKED_BATCH, CHUNKED_PROMPT, torch.float32, device=device)
            res[mode] = api.prefill(model, {"tokens": p2}, cfg, c, device=device)
    err = check_close("14a chunked prefill logits", res["chunked"][0], res["naive"][0], LM_RTOL)
    for i, (a, b) in enumerate(zip(res["chunked"][1]["layers"], res["naive"][1]["layers"])):
        err = max(err, check_close(f"14a chunked prefill k {i}", a["k"], b["k"], LM_RTOL),
                  check_close(f"14a chunked prefill v {i}", a["v"], b["v"], LM_RTOL))
    log(f"14a REPRO_ATTN=chunked prefill {CHUNKED_BATCH} x {CHUNKED_PROMPT} equals naive "
        f"within {LM_RTOL} (max err {err:.3e})")


def lm_long_context_phase(device) -> None:
    """14b: the long_500k shape through the CSR window + sink decode."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.attention import band

    cfg = _lm_config(LONG_LAYERS)
    length, batch = _long_shape()
    gen = torch.Generator(device=device).manual_seed(1)
    model = api.init_model(cfg, gen, torch.float32, device=device)
    cache = api.init_cache(cfg, batch, length, torch.float32, device=device)
    pos0 = length - LONG_STEPS
    t0 = time.perf_counter()
    for c in cache["layers"]:  # cut: a seeded fill stands in for a 524k prefill
        c["k"][:, :pos0].normal_(generator=gen)
        c["v"][:, :pos0].normal_(generator=gen)
        c["pos"] = pos0
    sync(device)
    kv_gb = sum(c["k"].numel() + c["v"].numel() for c in cache["layers"]) * 4 / 1e9
    log(f"14b {LONG_SHAPE}: batch {batch}, cache {length} x {LONG_LAYERS} layers "
        f"({kv_gb:.2f} GB fp32), filled to pos {pos0} from a seeded generator "
        f"({time.perf_counter() - t0:.1f} s)")
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=device)
    at_pos0 = {"layers": [dict(c) for c in cache["layers"]]}  # pos0 dicts, shared tensors
    tok, cache, worst = _band_steps("14b band", model, cfg, tok, cache, LONG_STEPS, device)
    log(f"14b {LONG_STEPS} long_ctx decode steps (pos {pos0}..{length - 1}) equal the plain "
        f"band evaluation over the whole cache within {LM_RTOL} (max err {worst:.3e})")
    # time band and full-cache decode at pos0 (a step at one position, repeated)
    ms = {True: [], False: []}
    for long_ctx in (True, False, False, True):
        ms[long_ctx].append(_event_ms(
            lambda: api.decode_step(model, tok, cfg, at_pos0, long_ctx=long_ctx, device=device),
            device, TIMING_REPS))
    g, w, _ = band(cfg, pos0, length)
    kv_row = cfg.n_kv_heads * cfg.resolved_head_dim * 4 * 2 * LONG_LAYERS * batch
    weights = (LONG_LAYERS * _layer_params(cfg) + cfg.d_model * cfg.vocab) * 4
    bound_band = (weights + (g + w) * kv_row) / HBM_BYTES_PER_S * 1e3
    bound_full = (weights + (pos0 + 1) * kv_row) / HBM_BYTES_PER_S * 1e3
    band_ms, full_ms = statistics.mean(ms[True]), statistics.mean(ms[False])
    log(f"14b decode at pos {pos0}: band (long_ctx) {ms[True][0]:.3f} / {ms[True][1]:.3f} ms "
        f"(bound {bound_band:.3f}), full cache {ms[False][0]:.3f} / {ms[False][1]:.3f} ms "
        f"(bound {bound_full:.3f}); full / band {full_ms / band_ms:.2f}x")
    for long_ctx in (True, False):
        decode_profile(f"14b decode long_ctx={long_ctx}", lambda: api.decode_step(
            model, tok, cfg, at_pos0, long_ctx=long_ctx, device=device), device)
    del cache, at_pos0
    _empty_cache(device)
    # the short leg: a real prefill long enough for the window to slide
    prompt = torch.randint(0, cfg.vocab, (1, SLIDE_PROMPT), generator=gen, device=device)
    cache = api.init_cache(cfg, 1, SLIDE_PROMPT + SLIDE_STEPS, torch.float32, device=device)
    logits, cache = api.prefill(model, {"tokens": prompt}, cfg, cache, device=device)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    g, _, start = band(cfg, SLIDE_PROMPT, SLIDE_PROMPT + SLIDE_STEPS)
    tok, cache, worst = _band_steps("14b slide", model, cfg, tok, cache, SLIDE_STEPS, device)
    log(f"14b prefill {SLIDE_PROMPT} then {SLIDE_STEPS} long_ctx steps (sinks [0, {g}), "
        f"window from {start}): equal the plain band evaluation within {LM_RTOL} "
        f"(max err {worst:.3e})")


def lm_other_archs_phase(device) -> None:
    """14c: every other LM architecture at reduced(), on the card against
    the port's CPU run from the same weights, and demo-lm as a process."""
    import copy

    import torch

    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.models import api

    cpu = torch.device("cpu")
    for arch in ARCH_IDS:
        if arch in ("gnn_sage", LM_ARCH):
            continue
        cfg = reduced(get_config(arch))
        gen = torch.Generator().manual_seed(2)
        host = api.init_model(cfg, gen, torch.float32, device=cpu)
        card = copy.deepcopy(host).to(device)
        toks = torch.randint(0, cfg.vocab, (2, OTHER_PROMPT), generator=gen)
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.randn((2, cfg.vlm_patches, cfg.d_model), generator=gen)
        if cfg.family == "audio":
            batch["frames"] = torch.randn((2, cfg.enc_dec.enc_seq, cfg.d_model), generator=gen)
        length = OTHER_PROMPT + cfg.vlm_patches + OTHER_STEPS + OTHER_LONG_STEPS
        c_host = api.init_cache(cfg, 2, length, torch.float32, device=cpu)
        c_card = api.init_cache(cfg, 2, length, torch.float32, device=device)
        want, c_host = api.prefill(host, batch, cfg, c_host, device=cpu)
        got, c_card = api.prefill(card, batch, cfg, c_card, device=device)
        worst = check_close(f"14c {arch} prefill", got.cpu(), want)
        for i in range(OTHER_STEPS + OTHER_LONG_STEPS):
            tok = torch.argmax(want[:, -1], -1)[:, None]
            long_ctx = i >= OTHER_STEPS
            want, c_host = api.decode_step(host, tok, cfg, c_host, long_ctx=long_ctx, device=cpu)
            got, c_card = api.decode_step(card, tok, cfg, c_card, long_ctx=long_ctx,
                                          device=device)
            worst = max(worst, check_close(f"14c {arch} decode {i}", got.cpu(), want))
        log(f"14c {arch}: prefill + {OTHER_STEPS} decode + {OTHER_LONG_STEPS} long_ctx steps "
            f"on the card equal the CPU within {RTOL} (max err {worst:.3e})")
        del card, c_card
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *DEMO_LM_ARGS]
    t0 = time.perf_counter()
    rc, out, err = _run_cmd(cmd, 300)
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    for ln in lines:
        log(f"14c   {ln}")
    if rc != 0 or len(lines) != 4:
        raise AssertionError(f"14c demo-lm: rc {rc}, {len(lines)} [serve] lines: {err[-2000:]}")
    log(f"14c demo-lm (the card by default) exit 0 in {time.perf_counter() - t0:.1f} s")


def lm_serving_phase(device) -> None:
    """Phase 14: LLM serving on the card. No hand-written kernel is on
    this path (the JAX LLM stack reaches no Pallas kernel). The peak
    printed after each leg is the phase's so far."""
    for label, fn in (("14a (Qwen3-14B full width)", lm_full_width_phase),
                      ("14b (long context, CSR window + sink)", lm_long_context_phase),
                      ("14c (every other architecture, demo-lm)", lm_other_archs_phase)):
        t0 = time.perf_counter()
        fn(device)
        _empty_cache(device)
        log(f"== phase {label}: {time.perf_counter() - t0:.1f} s")
        _peak(f"phase 14 through {label[:3]}", device)


# ----------------------------------------------------------- phase 15
TRAIN_LAYERS = 4  # of 40: depth cut, as in 14a
TRAIN_BATCH, TRAIN_SEQ = 8, 256  # launch/train.py's defaults
TRAIN_LR = 3e-4  # launch/train.py's default
TRAIN_STEPS = 6
OTHER_BATCH, OTHER_SEQ = 2, 32
OTHER_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)  # as tests/test_torch_lm_train.py
DECREASE_STEPS, DECREASE_LR, DECREASE_BAR = 60, 3e-3, 0.2  # tests/test_train_ckpt.py's
DECREASE_BATCH, DECREASE_SEQ = 4, 64
CLI_RTOL = 1e-6  # resumed vs uninterrupted weights on the card
CLI_ARGS = ("--arch", LM_ARCH, "--reduced", "--steps", "30", "--batch", "2", "--seq", "32",
            "--ckpt-every", "10", "--log-every", "10")


def _rel_err(name, got, want, rtol) -> float:
    """max |got - want| / max |want|; raise if above ``rtol`` or not finite."""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if not got.numel():
        return 0.0
    rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if rel > rtol:
        raise AssertionError(f"{name}: max err {rel:.3e} of max |ref| > {rtol}")
    return rel


def _step_err(name, got, want, m, lr) -> tuple:
    """Weights after one AdamW step, card against CPU. The first step
    moves each weight by lr * g / (|g| + eps): by ~lr whatever |g|, so
    where the gradient (m / (1 - b1)) is below RTOL of its leaf's max,
    rounding may flip its sign, and such a weight is held to 2 lr;
    every other weight to RTOL of max |ref|. Returns (max err over max
    |ref| of the others, the count of the former with a nonzero
    gradient)."""
    import torch

    got, want, m = (torch.as_tensor(x).float() for x in (got, want, m))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if not want.numel():
        return 0.0, 0
    tied = m.abs() <= RTOL * float(m.abs().max())
    diff = (got - want).abs()
    if bool((diff[tied] > 2 * lr * (1 + RTOL)).any()):
        raise AssertionError(f"{name}: a weight with a near-zero gradient moved more than 2 lr")
    scale = max(float(want.abs().max()), 1e-30)
    rel = float(diff[~tied].max()) / scale if bool((~tied).any()) else 0.0
    if rel > RTOL:
        raise AssertionError(f"{name}: max err {rel:.3e} of max |ref| > {RTOL}")
    return rel, int((tied & (m != 0)).sum())


def _train_flops(cfg, n_layers, batch, seq) -> float:
    """FLOPs of one train step with remat: 6 per matrix weight per token
    (forward, two backward products) plus 2 for the recomputed forward of
    the layers (not the unembedding), and the attention products over
    the causal half of each S x S score matrix, 4 passes (forward, remat,
    two backward)."""
    tokens = batch * seq
    layer = _layer_params(cfg) - 2 * cfg.d_model - 2 * cfg.resolved_head_dim  # matrices only
    unembed = cfg.d_model * cfg.vocab
    attn = 4 * 2 * 2 * batch * cfg.n_heads * cfg.resolved_head_dim * seq * (seq + 1) // 2
    return 6 * tokens * (n_layers * layer + unembed) + 2 * tokens * n_layers * layer + \
        n_layers * attn


def lm_train_full_width_phase(device) -> None:
    """15a: Qwen3-14B at its published widths, 4 layers, fp32: train steps
    through make_train_step on token_batch batches, timed against the
    FLOP bound, with AdamW's share (CUDA events) and the peak memory."""
    import torch

    from repro_torch.data.synthetic import PipelineState, token_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep

    cfg = _lm_config(TRAIN_LAYERS)
    _peak_reset(device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    state = tstep.init_train_state(cfg, gen, torch.float32, device=device)
    sync(device)
    n_par = sum(p.numel() for p in state.params.parameters())
    log(f"15a {cfg.name} x {TRAIN_LAYERS} layers: {n_par / 1e9:.3f} B fp32 parameters; "
        f"weights, m and v {3 * n_par * 4 / 1e9:.2f} GB, with the gradients "
        f"{4 * n_par * 4 / 1e9:.2f} GB (drawn in {time.perf_counter() - t0:.1f} s)")
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                      warmup_steps=min(20, TRAIN_STEPS // 5))
    adam_ms = []
    real_update = tstep.adamw_update

    def timed_update(*args):  # CUDA events around the step's AdamW update
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_update(*args)
        end.record()
        adam_ms.append((start, end))
        return out

    tstep.adamw_update = timed_update
    try:
        step_fn = tstep.make_train_step(cfg, opt, device=device)
        rows = []
        for i in range(TRAIN_STEPS):
            batch = token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, PipelineState(0, i))
            sync(device)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            sync(device)
            rows.append((time.perf_counter() - t0, float(m["loss"]), float(m["grad_norm"]),
                         float(m["lr"])))
    finally:
        tstep.adamw_update = real_update
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (s, loss, gn, lr) in enumerate(rows):
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"15a step {i}: loss {loss}, grad norm {gn}")
        adam = adam_ms[i][0].elapsed_time(adam_ms[i][1])
        log(f"15a step {i}: {s * 1e3:.1f} ms, {tokens / s:.1f} tokens/s, loss {loss:.4f}, "
            f"grad norm {gn:.4f}, lr {lr:.3e}, AdamW {adam:.2f} ms")
    if int(state.step) != TRAIN_STEPS or int(state.opt.count) != TRAIN_STEPS:
        raise AssertionError(f"15a: step {int(state.step)}, count {int(state.opt.count)}")
    flops = _train_flops(cfg, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ)
    adam_bytes = 7 * n_par * 4  # read g, p, m, v; write p, m, v
    bound_s = flops / FP32_FLOPS + adam_bytes / HBM_BYTES_PER_S
    warm = [r[0] for r in rows[1:]]
    warm_ms = statistics.median(warm) * 1e3
    adam_warm = statistics.median(a.elapsed_time(b) for a, b in adam_ms[1:])
    log(f"15a warm step (median of steps 1-{TRAIN_STEPS - 1}): {warm_ms:.1f} ms, "
        f"{tokens / warm_ms * 1e3:.1f} tokens/s; cold step {rows[0][0] * 1e3:.1f} ms; bound "
        f"{bound_s * 1e3:.1f} ms ({flops / 1e12:.2f} TFLOP / 67 TFLOP/s fp32 + AdamW "
        f"{adam_bytes / 1e9:.2f} GB / 3.35 TB/s = {adam_bytes / HBM_BYTES_PER_S * 1e3:.1f} ms), "
        f"{bound_s * 1e3 / warm_ms:.1%} of it")
    log(f"15a AdamW: {adam_warm:.2f} ms of the warm step ({adam_warm / warm_ms:.1%}), bound "
        f"{adam_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms")
    log(f"15a loss trend: {', '.join(f'{r[1]:.4f}' for r in rows)}")
    if device.type == "cuda":
        log(f"15a peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    del state, step_fn


def lm_train_other_archs_phase(device) -> None:
    """15b: every LM architecture at reduced(): one train step and one eval
    step on the card against the CPU from the same weights and batch, then
    60 steps of reduced qwen3_14b on the card, whose loss must fall."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.data.synthetic import PipelineState, token_batch
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep

    cpu = torch.device("cpu")
    worst = 0.0
    for arch in ARCH_IDS:
        if arch == "gnn_sage":
            continue
        cfg = reduced(get_config(arch))
        host = tstep.init_train_state(cfg, 4, torch.float32, device=cpu)
        card = api.train_state_from_jax(cfg, api.train_state_to_numpy(cfg, host), device=device)
        batch = token_batch(cfg, OTHER_BATCH, OTHER_SEQ, PipelineState(0, 0))
        ev = {d: tstep.make_eval_step(cfg, device=d)(st.params, batch)
              for d, st in ((cpu, host), (device, card))}
        res = {}
        for d, st in ((cpu, host), (device, card)):
            st, m = tstep.make_train_step(cfg, AdamWConfig(**OTHER_OPT), device=d)(st, batch)
            res[d] = (api.train_state_to_numpy(cfg, st), m)
        err = max(_rel_err(f"15b {arch} eval {k}", ev[device][k], ev[cpu][k], RTOL)
                  for k in ev[cpu])
        for k in ("loss", "nll", "z_loss", "grad_norm", "lr"):
            err = max(err, _rel_err(f"15b {arch} {k}", res[device][1][k], res[cpu][1][k], RTOL))
        (got, _), (want, metrics) = res[device], res[cpu]
        lr = float(metrics["lr"])
        for part, g, w in (("m", got.opt.m, want.opt.m), ("v", got.opt.v, want.opt.v)):
            for (path, a), (_, b) in zip(_tree_items(g), _tree_items(w)):
                err = max(err, _rel_err(f"15b {arch} {part} {path}", a, b, RTOL))
        n_tied = 0
        for (path, a), (_, b), (_, m) in zip(_tree_items(got.params), _tree_items(want.params),
                                             _tree_items(want.opt.m)):
            e, n = _step_err(f"15b {arch} params {path}", a, b, m, lr)
            err, n_tied = max(err, e), n_tied + n
        worst = max(worst, err)
        log(f"15b {arch}: a train step (loss, grad norm, lr, weights, m, v) and an eval step on "
            f"the card equal the CPU within {RTOL} of max |ref| (max {err:.3e}; {n_tied} weights "
            f"with a nonzero |grad| below {RTOL} of their leaf's max held to 2 lr)")
        del host, card, res
    cfg = reduced(get_config(LM_ARCH))
    state = tstep.init_train_state(cfg, 0, torch.float32, device=device)
    step = tstep.make_train_step(cfg, AdamWConfig(lr=DECREASE_LR, total_steps=70,
                                                  warmup_steps=5), device=device)
    losses = []
    t0 = time.perf_counter()
    for i in range(DECREASE_STEPS):
        state, m = step(state, token_batch(cfg, DECREASE_BATCH, DECREASE_SEQ,
                                           PipelineState(0, i)))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"15b {DECREASE_STEPS} steps of {cfg.name} at lr {DECREASE_LR} ({DECREASE_BATCH} x "
        f"{DECREASE_SEQ}, {time.perf_counter() - t0:.1f} s): mean loss of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not last < first - DECREASE_BAR:
        raise AssertionError(f"15b: the loss fell by {first - last:.4f} < {DECREASE_BAR}")
    log(f"15b all {len(ARCH_IDS) - 1} archs within {RTOL} (max {worst:.3e})")


def _tree_items(tree, prefix=""):
    """(path, leaf) of a nested dict/list of arrays, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def lm_train_cli_phase(device, workdir: Path) -> None:
    """15c: `python -m repro_torch.launch.train` on the card: a crash at
    step 25 (exit code 17, step 20 committed), a resume to step 30, and
    the final weights against an uninterrupted run's."""
    import numpy as np

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train

    ck, ref = workdir / "train_ck", workdir / "train_ref"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS, "--ckpt-dir", str(ck)]
    t0 = time.perf_counter()
    rc, out, err = _run_cmd(cmd + ["--crash-at", "25"], 300)
    if rc != 17 or ckpt.latest_step(str(ck)) != 20:
        raise AssertionError(f"15c crash run: rc {rc}, latest {ckpt.latest_step(str(ck))}: "
                             f"{err[-2000:]}")
    log(f"15c crash at step 25: exit 17, latest committed step 20 "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rc, out, err = _run_cmd(cmd, 300)
    for ln in out.splitlines():
        log(f"15c   {ln}")
    if rc != 0 or "[train] resumed from step 20" not in out or ckpt.latest_step(str(ck)) != 30:
        raise AssertionError(f"15c resume run: rc {rc}, latest {ckpt.latest_step(str(ck))}: "
                             f"{err[-2000:]}")
    log(f"15c resume: exit 0, resumed from step 20, latest step 30 "
        f"({time.perf_counter() - t0:.1f} s)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main([*CLI_ARGS, "--ckpt-dir", str(ref), "--device", str(device)])
    if rc != 0:
        raise AssertionError(f"15c: the uninterrupted run exited {rc}: {buf.getvalue()[-2000:]}")
    worst = 0.0
    with np.load(ck / "step_00000030" / "arrays.npz") as a, \
            np.load(ref / "step_00000030" / "arrays.npz") as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("15c: the two checkpoints hold other keys")
        for k in b.files:
            worst = max(worst, _rel_err(f"15c {k}", a[k], b[k], CLI_RTOL))
    log(f"15c resumed weights, moments and counts equal the uninterrupted run's within "
        f"{CLI_RTOL} of max |ref| (max {worst:.3e})")


def lm_training_phase(device, workdir: Path) -> None:
    """Phase 15: LLM training on the card. No hand-written kernel is on
    this path (the JAX training path reaches no Pallas kernel)."""
    for label, fn, args in (("15a (Qwen3-14B full width)", lm_train_full_width_phase, ()),
                            ("15b (every architecture, card vs CPU)",
                             lm_train_other_archs_phase, ()),
                            ("15c (launch.train crash and resume)", lm_train_cli_phase,
                             (workdir,))):
        t0 = time.perf_counter()
        fn(device, *args)
        _empty_cache(device)
        log(f"== phase {label}: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------- phase 16
MESH_RANKS = 4  # ranks sharing the one card (gloo: fewer cards than local ranks)
MESH_TIMEOUT_S = 420
MOE_ARCH = "qwen3_moe_235b_a22b"  # configs/qwen3_moe_235b_a22b at its published widths
MOE_ROWS, MOE_SEQ = 8, 512
MOE_CF = 2.0  # the 'data' size: cap = n * top_k, nothing drops
MOE_GRAD_RTOL = 1e-3
MOE_MESH = {"pod": 1, "data": 2, "model": 2}
PSUM_SHAPE = (5120, 17408)  # configs/qwen3_14b w_up
PSUM_STEPS = 20
ATTN_TIMING_REPS = 5
MESH_TRAIN_ARGS = ("--arch", MOE_ARCH, "--reduced", "--steps", "8", "--ckpt-every", "2")
CLI_RTOL_MESH = 1e-4  # a mesh run's moments vs one rank's: sums in another order
# AdamW moves a weight by at most lr per step whatever its gradient, so
# where a gradient is at rounding level (the two runs sum in other
# orders, the card's embedding backward with atomics) the runs' weights
# may part by up to 2 lr per step: 8 steps at the launcher's lr 3e-4
CLI_ATOL_WEIGHTS = 2 * 3e-4 * 8
MESH_DEMO_ARGS = ("demo-lm", "--arch", LM_ARCH, "--reduced", "--long-ctx", "--prompt-len", "24",
                  "--gen", "8")  # 4 cache slices of 8 positions: decode starts on a boundary


def _rank_log(*args) -> None:
    from repro_torch.distributed import collectives

    if collectives.rank() == 0:
        log(*args)


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in float64 on got's device."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _peaks(label, device) -> None:
    """Every rank's peak device memory since the last reset, allocated and
    reserved by its caching allocator, on rank 0."""
    import torch

    from repro_torch.distributed import collectives

    if device.type != "cuda":
        return
    mine = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9,
                         torch.cuda.max_memory_reserved(device) / 1e9], device=device)
    world = collectives.all_gather(mine[None], _WORLD_MESH[0], "data", dim=0)
    _rank_log(f"{label}: peak device memory per rank {[round(float(v), 2) for v in world[:, 0]]} "
              f"GB allocated, {[round(float(v), 2) for v in world[:, 1]]} GB reserved")


_WORLD_MESH = []  # (1, world, 1): the peak-memory gather's mesh


def _experts(cfg, which, lo, hi, f_cols, device):
    """Experts lo..hi-1 of w_gate (0), w_up (1) or w_down (2), columns (rows
    of w_down) ``f_cols`` of the expert hidden dimension; each expert is
    drawn whole from a generator of its own seed, so a rank draws its
    slice alone and the reference the same values."""
    import torch

    d, fe = cfg.d_model, cfg.moe.d_expert
    out = []
    for e in range(lo, hi):
        g = torch.Generator(device=device).manual_seed(1_000_000 * (which + 1) + e)
        if which < 2:
            w = torch.randn((d, fe), generator=g, device=device) * (1 / d) ** 0.5
            out.append(w[:, f_cols].clone())
        else:
            w = torch.randn((fe, d), generator=g, device=device) * (1 / fe) ** 0.5
            out.append(w[f_cols].clone())
        del w
    return torch.stack(out)


def _moe_router(cfg, device, overflow=False):
    import torch

    g = torch.Generator(device=device).manual_seed(7)
    d, e = cfg.d_model, cfg.moe.n_experts
    router = torch.randn((d, e), generator=g, device=device) * (1 / d) ** 0.5
    if overflow:  # every token prefers the experts of data rank 0
        router[:, :e // 2] += 4.0 * torch.ones(d, device=device)[:, None] / d ** 0.5
    return router


def _moe_inputs(cfg, device, overflow=False):
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((MOE_ROWS, MOE_SEQ, cfg.d_model), generator=g, device=device)
    r = torch.randn(x.shape, generator=g, device=device)
    if overflow:
        x = x + 3.0 * torch.ones(cfg.d_model, device=device) / cfg.d_model ** 0.5
    return x, r


def _drops(params, x, cfg, mesh, cf) -> tuple:
    """(copies dropped, copies kept but not written) of a dispatch,
    summed over the ranks."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import mesh_shape
    from repro_torch.models import moe

    n_data = mesh_shape(mesh)["data"]
    t = x.reshape(-1, cfg.d_model)
    _, ids = moe._route(t, params.router, cfg.moe.top_k)
    cap = moe.capacity(t.shape[0], cfg.moe.top_k, n_data, cf)
    *_, keep, written = moe.dispatch_plan(ids.reshape(-1), cfg.moe.n_experts // n_data, n_data,
                                          cap)
    counts = torch.stack([(~keep).sum(), (keep & ~written).sum()]).cpu()
    counts = collectives.psum(counts, _WORLD_MESH[0], "data")
    return int(counts[0]), int(counts[1])


def _slice_grad_errs(params, x, r, cfg, lo) -> float:
    """The largest max |grad - ref| / max |ref| over this rank's three
    expert slices, their gradients from the EP backward (``.grad``)
    against a plain loop over its experts and the tokens routed to each
    (no dispatch buffers), one expert at a time: no second copy of the
    slices or of their gradients is held."""
    import torch
    import torch.nn.functional as F

    names = ("w_gate", "w_up", "w_down")
    t, rt = x.reshape(-1, cfg.d_model), r.reshape(-1, cfg.d_model)
    with torch.no_grad():
        probs = torch.softmax(t.float() @ params.router, dim=-1)
        gates, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    diff, peak = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for e in range(params.w_gate.shape[0]):
        w = [params.get_parameter(n)[e].detach().requires_grad_(True) for n in names]
        tok, slot = (ids == lo + e).nonzero(as_tuple=True)
        if tok.numel():
            h = F.silu(t[tok] @ w[0]) * (t[tok] @ w[1])
            want = torch.autograd.grad(
                ((h @ w[2]) * rt[tok] * gates[tok, slot, None]).sum(), w)
        else:
            want = [torch.zeros_like(v) for v in w]
        for n, g in zip(names, want):
            got = params.get_parameter(n).grad[e]
            diff[n] = max(diff[n], float((got.double() - g.double()).abs().max()))
            peak[n] = max(peak[n], float(g.abs().max()))
    errs = {n: diff[n] / max(peak[n], 1e-30) for n in names}
    for n, err in errs.items():
        if err > MOE_GRAD_RTOL:
            raise AssertionError(f"16a: d{n} slice off by {err:.3e} of max |ref|")
    return max(errs.values())


def _moe_config():
    from repro_torch.configs import get_config

    return get_config(MOE_ARCH)


def ep_moe_leg(mesh, device) -> None:
    """16a: one MoE layer of Qwen3-MoE-235B-A22B at its published widths,
    expert parallel on (1, 2, 2); see the module docstring."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import batch_axes_for
    from repro_torch.models import moe
    from repro_torch.models.modules import Params

    cfg = _moe_config()
    mo = cfg.moe
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    e_loc, f_loc = mo.n_experts // MOE_MESH["data"], mo.d_expert // MOE_MESH["model"]
    lo, cols = di * e_loc, slice(mi * f_loc, (mi + 1) * f_loc)
    t0 = time.perf_counter()
    params = Params(router=_moe_router(cfg, device),
                    **{n: _experts(cfg, i, lo, lo + e_loc, cols, device)
                       for i, n in enumerate(("w_gate", "w_up", "w_down"))})
    x, r = _moe_inputs(cfg, device)
    ba = batch_axes_for(MOE_ROWS, mesh)
    rows = collectives.rows(MOE_ROWS, mesh, ba)
    xl = x[rows].clone().requires_grad_(True)
    sync(device)
    slice_gb = sum(params.get_parameter(n).numel() for n in ("w_gate", "w_up", "w_down")) * 4e-9
    _rank_log(f"16a {MOE_ARCH}: d_model {cfg.d_model}, {mo.n_experts} experts, top-{mo.top_k}, "
              f"d_expert {mo.d_expert}; {MOE_ROWS} x {MOE_SEQ} tokens; mesh {MOE_MESH}; each "
              f"rank's slice {slice_gb:.2f} GB ({time.perf_counter() - t0:.1f} s to draw)")
    cap = moe.capacity(xl.shape[0] * MOE_SEQ, mo.top_k, MOE_MESH["data"], MOE_CF)
    times = []
    for _ in range(2):
        collectives.barrier()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = moe.moe_ffn_ep(params, xl, cfg, mesh, capacity_factor=MOE_CF)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    drops = _drops(params, xl.detach(), cfg, mesh, MOE_CF)
    if drops != (0, 0):
        raise AssertionError(f"16a: capacity factor {MOE_CF} dropped copies: {drops}")
    collectives.barrier()
    t0 = time.perf_counter()
    out = moe.moe_ffn_ep(params, xl, cfg, mesh, capacity_factor=MOE_CF)
    (out * r[rows]).sum().backward()
    sync(device)
    fb_ms = (time.perf_counter() - t0) * 1e3
    _rank_log(f"16a EP forward (cap {cap} slots per destination, no drops): "
              f"{times[0]:.1f} / {times[1]:.1f} ms; forward + backward {fb_ms:.1f} ms "
              f"(4 ranks sharing one card, host clock after a sync)")
    # the slices' gradients against a plain loop over this rank's experts
    w_err = torch.tensor([_slice_grad_errs(params, x, r, cfg, lo)], device=device)
    w_err = collectives.pmax(w_err, _WORLD_MESH[0], "data")
    out_all = collectives.all_gather(out.detach(), mesh, "data", dim=0)
    gx_all = collectives.all_gather(xl.grad, mesh, "data", dim=0)
    del params, out, xl
    _empty_cache(device)
    if collectives.rank() == 0:  # the whole experts, 9.66 GB, on rank 0 only
        full = Params(router=_moe_router(cfg, device),
                      **{n: _experts(cfg, i, 0, mo.n_experts, slice(None), device)
                         for i, n in enumerate(("w_gate", "w_up", "w_down"))})
        for p in full.parameters():
            p.requires_grad_(False)
        xr = x.clone().requires_grad_(True)
        want = moe.moe_ffn_ref(full, xr, cfg)
        (want * r).sum().backward()
        err, gerr = _rel(out_all, want), _rel(gx_all, xr.grad)
        full_gb = sum(p.numel() for p in full.parameters()) * 4e-9
        del full, want, xr
        _empty_cache(device)
        if err > RTOL or gerr > MOE_GRAD_RTOL:
            raise AssertionError(f"16a: EP vs moe_ffn_ref: out {err:.3e}, dx {gerr:.3e}")
        log(f"16a EP output within {RTOL} of moe_ffn_ref over the whole experts "
            f"({full_gb:.2f} GB, rank 0) (max err {err:.3e} of max |ref|); dx within "
            f"{MOE_GRAD_RTOL} ({gerr:.3e}); expert slices' gradients within {MOE_GRAD_RTOL} "
            f"of a plain loop over each rank's experts (max {float(w_err[0]):.3e})")
    collectives.barrier()
    _peaks("16a (fp32, capacity factor 2)", device)
    ep_overflow_leg(mesh, device, cfg, lo, e_loc, cols, ba, rows)


def ep_overflow_leg(mesh, device, cfg, lo, e_loc, cols, ba, rows) -> None:
    """16a at the default capacity factor (REPRO_MOE_CF unset: 1.25), the
    router made to send every token to data rank 0's experts: the card's
    output against the same 4 ranks on the CPU."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.models import moe
    from repro_torch.models.modules import Params

    cf = float(os.environ.get("REPRO_MOE_CF", "1.25"))
    x, _ = _moe_inputs(cfg, device, overflow=True)
    xl = x[rows].contiguous()
    del x
    params = Params(router=_moe_router(cfg, device, overflow=True),
                    **{n: _experts(cfg, i, lo, lo + e_loc, cols, device)
                       for i, n in enumerate(("w_gate", "w_up", "w_down"))})
    t0 = time.perf_counter()
    with torch.no_grad():
        out = moe.moe_ffn(params, xl, cfg, mesh)
    sync(device)
    card_ms = (time.perf_counter() - t0) * 1e3
    drops = _drops(params, xl, cfg, mesh, cf)
    cpu = torch.device("cpu")
    params_cpu = Params(**{n: params.get_parameter(n).detach().to(cpu)
                           for n in ("router", "w_gate", "w_up", "w_down")})
    out_card = out.cpu()
    del params, out
    _empty_cache(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = moe.moe_ffn(params_cpu, xl.cpu(), cfg, mesh)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    drops_cpu = _drops(params_cpu, xl.cpu(), cfg, mesh, cf)
    err = torch.tensor([_rel(out_card, want)])
    err = float(collectives.pmax(err, _WORLD_MESH[0], "data")[0])
    if err > RTOL or drops != drops_cpu or drops[0] == 0:
        raise AssertionError(f"16a overflow: card vs CPU {err:.3e}, drops card {drops} "
                             f"CPU {drops_cpu}")
    _rank_log(f"16a overflow (capacity factor {cf}, every token routed to data rank 0's "
              f"experts): the card within {RTOL} of the same 4 ranks on the CPU (max err "
              f"{err:.3e} of max |ref|); dropped copies {drops[0]} / {drops_cpu[0]}, kept "
              f"copies lost to the overflow slot {drops[1]} / {drops_cpu[1]} (card / CPU); "
              f"{card_ms:.1f} ms on the card, {cpu_ms:.1f} ms on the CPU")


def _kv_chunks(length, chunk, lo, hi, heads, dh, device, which):
    """Rows lo..hi-1 of a (1, length, heads, dh) bf16 cache, each chunk of
    ``chunk`` rows from a generator of its own seed (zeros past
    length - LONG_STEPS, as phase 14b leaves them)."""
    import torch

    pos0 = length - LONG_STEPS
    out = torch.zeros((1, hi - lo, heads, dh), dtype=torch.bfloat16, device=device)
    for c in range(lo // chunk, hi // chunk):
        g = torch.Generator(device=device).manual_seed(10_000 * which + c)
        part = torch.randn((1, chunk, heads, dh), generator=g, device=device)
        a, b = c * chunk, min((c + 1) * chunk, pos0)
        if b > a:
            out[:, a - lo:b - lo] = part[:, :b - a].to(torch.bfloat16)
    return out


def sharded_attention_leg(mesh, device) -> None:
    """16b: csr_window_attention_sharded at Qwen3-14B's widths over the
    long_500k cache split over 4 ranks, against csr_window_attention over
    the whole cache on rank 0."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.models import attention as attn

    cfg = _lm_config(1)
    length, batch = _long_shape()
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    n = MESH_RANKS
    l_loc = length // n
    offset = collectives.axis_index(mesh, ("data", "model")) * l_loc
    chunk = l_loc // 4
    t0 = time.perf_counter()
    k_loc = _kv_chunks(length, chunk, offset, offset + l_loc, hkv, dh, device, 1)
    v_loc = _kv_chunks(length, chunk, offset, offset + l_loc, hkv, dh, device, 2)
    params = attn.init_gqa(torch.Generator(device=device).manual_seed(5), cfg)
    sync(device)
    _rank_log(f"16b {LM_ARCH} {LONG_SHAPE}: batch {batch}, {length} positions in {n} slices "
              f"of {l_loc} (bf16 k + v {2 * k_loc.numel() * 2 / 1e9:.2f} GB per rank), filled "
              f"from seeded generators ({time.perf_counter() - t0:.1f} s)")
    full = None
    if collectives.rank() == 0:  # the same values in fp32: the plain path would round
        # its probabilities to a bf16 cache's dtype, the sharded one keeps them fp32
        full = {"k": _kv_chunks(length, chunk, 0, length, hkv, dh, device, 1).float(),
                "v": _kv_chunks(length, chunk, 0, length, hkv, dh, device, 2).float()}
    g = torch.Generator(device=device).manual_seed(6)
    for pos in (length - LONG_STEPS, length // 2):  # the last slice; a slice's first row
        x = torch.randn((batch, 1, cfg.d_model), generator=g, device=device)
        positions = torch.full((batch, 1), pos, device=device)
        before = k_loc.clone()
        with torch.no_grad():
            out, new = attn.csr_window_attention_sharded(
                params, x, cfg, positions, {"k": k_loc, "v": v_loc, "pos": pos}, mesh)
        changed = ((new["k"] != before).any(dim=(0, 2, 3)).nonzero().flatten() + offset).tolist()
        owner = offset <= pos < offset + l_loc
        if changed != ([pos] if owner else []) or new["pos"] != pos + 1:
            raise AssertionError(f"16b pos {pos}: rows written {changed} on the slice at "
                                 f"{offset}")
        del before
        ms = []
        for _ in range(ATTN_TIMING_REPS):
            collectives.barrier()
            t0 = time.perf_counter()
            with torch.no_grad():
                attn.csr_window_attention_sharded(params, x, cfg, positions,
                                                  {"k": k_loc, "v": v_loc, "pos": pos}, mesh)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        if full is not None:
            with torch.no_grad():
                want, _ = attn.csr_window_attention(params, x, cfg, positions,
                                                    dict(full, pos=pos))
            err = _rel(out, want)
            if err > RTOL:
                raise AssertionError(f"16b pos {pos}: sharded vs whole cache {err:.3e}")
            log(f"16b decode at pos {pos} (slice {pos // l_loc}): within {RTOL} of "
                f"csr_window_attention over the whole cache (its values in fp32) (max err "
                f"{err:.3e} of max |ref|); "
                f"only the owning slice wrote its row; step {statistics.median(ms):.2f} ms "
                f"median of {ATTN_TIMING_REPS} (4 ranks sharing one card, not a scaling "
                f"number)")
        collectives.barrier()
    del full, k_loc, v_loc
    _empty_cache(device)
    _peaks("16b", device)


def compressed_psum_leg(mesh, device) -> None:
    """16c: compressed_psum over 'pod' on (4, 1, 1), a w_up-sized tensor per
    rank: one reduction, then PSUM_STEPS with error feedback (the JAX
    package's test_compressed_psum_error_feedback)."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.optim import compress

    me = collectives.axis_index(mesh, "pod")
    x = torch.randn(PSUM_SHAPE, generator=torch.Generator(device=device).manual_seed(300 + me),
                    device=device)
    exact = collectives.psum(x, mesh, "pod") / MESH_RANKS
    ef = torch.zeros_like(x)
    collectives.barrier()
    t0 = time.perf_counter()
    out, ef = compress.compressed_psum(x, mesh, "pod", ef)
    sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    err1 = float((out - exact).abs().max())
    accum = torch.zeros_like(x)
    t0 = time.perf_counter()
    for _ in range(PSUM_STEPS):
        out, ef = compress.compressed_psum(x, mesh, "pod", ef)
        accum += out
    sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / PSUM_STEPS
    drift = float((accum / PSUM_STEPS - exact).abs().max())
    if not drift < err1 / 2 + 1e-6:
        raise AssertionError(f"16c: drift {drift:.3e} not below err1 / 2 ({err1:.3e})")
    _rank_log(f"16c compressed_psum of {PSUM_SHAPE[0]} x {PSUM_SHAPE[1]} fp32 "
              f"({x.numel() * 4 / 1e9:.2f} GB) per rank over 'pod' (4): err1 {err1:.4e}, "
              f"drift after {PSUM_STEPS} error-feedback steps {drift:.4e} (< err1 / 2); "
              f"{first_ms:.1f} ms first, {step_ms:.1f} ms per step")
    del x, exact, ef, accum, out
    _empty_cache(device)
    _peaks("16c", device)


def mesh_rank_main(workdir: Path) -> int:
    """One rank of phase 16a-c, started by torch.distributed.run."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    device = collectives.init()
    _WORLD_MESH.append(make_host_mesh())
    moe_mesh = make_mesh(MOE_MESH)
    legs = (("16a (EP MoE, full width)", ep_moe_leg, moe_mesh),
            ("16b (sharded CSR window attention, full width)", sharded_attention_leg, moe_mesh),
            ("16c (int8 error-feedback psum)", compressed_psum_leg,
             make_mesh({"pod": MESH_RANKS, "data": 1, "model": 1})))
    for label, fn, mesh in legs:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        fn(mesh, device)
        _rank_log(f"== phase {label}: {time.perf_counter() - t0:.1f} s")
    collectives.finish()
    return 0


@contextlib.contextmanager
def _process_memory(label):
    """Samples nvidia-smi every half second while the block runs and logs
    the card's largest memory in use (every process on it, CUDA contexts
    included) and each listed process's largest: the peak of a
    torch.distributed.run, whose ranks are processes of their own."""
    import threading

    peaks: dict = {}
    card = {"used": 0, "total": 0}
    stop = threading.Event()

    def smi(query):
        try:
            return subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                                  capture_output=True, text=True, timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            return ""

    def poll():
        while not stop.wait(0.5):
            for ln in smi("--query-compute-apps=pid,used_memory").splitlines():
                parts = [p.strip() for p in ln.split(",")]
                if len(parts) == 2 and parts[1].isdigit():
                    peaks[parts[0]] = max(peaks.get(parts[0], 0), int(parts[1]))
            first = (smi("--query-gpu=memory.used,memory.total").splitlines() or [""])[0]
            parts = [p.strip() for p in first.split(",")]
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                card["used"], card["total"] = max(card["used"], int(parts[0])), int(parts[1])

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=15)
        got = sorted(round(v / 1024, 2) for v in peaks.values())
        used = (f"{card['used'] / 1024:.2f} of {card['total'] / 1024:.2f} GiB" if card["total"]
                else "not measured")
        log(f"{label}: the card's memory in use at most {used}; per process listed "
            f"{got if got else 'not measured (no process listed)'} GiB (nvidia-smi, max of "
            f"0.5 s samples)")


def _cli_losses(out: str) -> dict:
    import re

    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"\[train\] step=(\d+) loss=(\S+)", out)}


def mesh_train_leg(device, workdir: Path) -> None:
    """16d: launch.train on 4 ranks with a crash at step 5, resumed on 2
    ranks, against one rank's uninterrupted run."""
    import numpy as np

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train

    env = {"REPRO_MOE_CF": "8"}
    ck, ref = workdir / "mesh_ck", workdir / "mesh_ref"
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    cmd = ["-m", "repro_torch.launch.train", *MESH_TRAIN_ARGS, "--ckpt-dir", str(ck)]
    t0 = time.perf_counter()
    with _process_memory(f"16d crash run, {MESH_RANKS} ranks"):
        rc, out, err = _run_cmd(run + [f"--nproc-per-node={MESH_RANKS}", *cmd, "--crash-at",
                                       "5"], MESH_TIMEOUT_S, env)
    for ln in out.splitlines():
        log(f"16d   {ln}")
    if rc == 0 or "[train] simulating crash at step 5" not in out or ckpt.latest_step(str(ck)) != 4:
        raise AssertionError(f"16d crash run: rc {rc}, latest {ckpt.latest_step(str(ck))}: "
                             f"{err[-2000:]}")
    log(f"16d {MESH_RANKS} ranks, crash at step 5: latest committed step 4 "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with _process_memory("16d resume, 2 ranks"):
        rc, out, err = _run_cmd(run + ["--nproc-per-node=2", *cmd], MESH_TIMEOUT_S, env)
    for ln in out.splitlines():
        log(f"16d   {ln}")
    if rc != 0 or "[train] resumed from step 4" not in out or ckpt.latest_step(str(ck)) != 8:
        raise AssertionError(f"16d resume on 2 ranks: rc {rc}: {err[-2000:]}")
    log(f"16d resumed on 2 ranks from step 4 to 8 ({time.perf_counter() - t0:.1f} s)")
    old = os.environ.get("REPRO_MOE_CF")
    os.environ["REPRO_MOE_CF"] = "8"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main([*MESH_TRAIN_ARGS, "--ckpt-dir", str(ref), "--device", str(device)])
    finally:
        if old is None:
            os.environ.pop("REPRO_MOE_CF")
        else:
            os.environ["REPRO_MOE_CF"] = old
    if rc != 0:
        raise AssertionError(f"16d: the one-rank run exited {rc}")
    got, want = _cli_losses(out)[7], _cli_losses(buf.getvalue())[7]
    if abs(got - want) > 1e-4 + 1e-9:
        raise AssertionError(f"16d final loss {got} vs one rank's {want}")
    worst, worst_w = 0.0, 0.0
    with np.load(ck / "step_00000008" / "arrays.npz") as a, \
            np.load(ref / "step_00000008" / "arrays.npz") as b:
        for k in b.files:
            if k.startswith(".params/"):  # AdamW: at most lr per step, whatever the gradient
                w = float(np.abs(a[k].astype(np.float64) - b[k]).max())
                if w > CLI_ATOL_WEIGHTS:
                    raise AssertionError(f"16d {k}: max err {w:.3e} > {CLI_ATOL_WEIGHTS}")
                worst_w = max(worst_w, w)
            else:
                worst = max(worst, _rel_err(f"16d {k}", a[k], b[k], CLI_RTOL_MESH))
    log(f"16d final loss {got:.4f} (one rank {want:.4f}, within 1e-4 as printed); weights "
        f"within {CLI_ATOL_WEIGHTS:.1e} (max {worst_w:.3e}), moments and counts within "
        f"{CLI_RTOL_MESH} of max |ref| (max {worst:.3e}) of the one-rank run's")


def mesh_demo_leg(device, workdir: Path) -> None:
    """16e: demo-lm --long-ctx with REPRO_LONG_ATTN=sharded on 4 ranks
    against one rank."""
    from repro_torch.launch import serve

    env = {"REPRO_LONG_ATTN": "sharded"}
    t0 = time.perf_counter()
    with _process_memory(f"16e demo-lm, {MESH_RANKS} ranks"):
        rc, out, err = _run_cmd([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 f"--nproc-per-node={MESH_RANKS}", "-m",
                                 "repro_torch.launch.serve", *MESH_DEMO_ARGS], MESH_TIMEOUT_S,
                                env)
    for ln in out.splitlines():
        log(f"16e   {ln}")
    if rc != 0:
        raise AssertionError(f"16e demo-lm on {MESH_RANKS} ranks: rc {rc}: {err[-2000:]}")
    wall = time.perf_counter() - t0
    old = os.environ.get("REPRO_LONG_ATTN")
    os.environ["REPRO_LONG_ATTN"] = "sharded"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main([*MESH_DEMO_ARGS, "--device", str(device)])
    finally:
        if old is None:
            os.environ.pop("REPRO_LONG_ATTN")
        else:
            os.environ["REPRO_LONG_ATTN"] = old
    tokens = [ln for ln in out.splitlines() if "sample generations" in ln]
    want = [ln for ln in buf.getvalue().splitlines() if "sample generations" in ln]
    if rc != 0 or len(tokens) != 1 or tokens != want:
        raise AssertionError(f"16e: {tokens} vs one rank's {want}")
    log(f"16e demo-lm on {MESH_RANKS} ranks (the cache's sequence split, sharded CSR window "
        f"decode): greedy tokens equal one rank's ({wall:.1f} s)")


def mesh_phase(device, workdir: Path) -> None:
    """Phase 16: the multi-device paths, 4 ranks on the one card."""
    t0 = time.perf_counter()
    with _process_memory(f"16a-c, {MESH_RANKS} ranks"):
        rc, out, err = _run_cmd([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 f"--nproc-per-node={MESH_RANKS}", str(REPO / "chip_smoke.py"),
                                 "--mesh-legs", str(workdir)], MESH_TIMEOUT_S)
    for ln in out.splitlines():
        log(ln)
    if rc != 0:
        raise AssertionError(f"phase 16a-c: rc {rc}: {err[-3000:]}")
    log(f"== phase 16a-c ({MESH_RANKS} ranks, one process group): "
        f"{time.perf_counter() - t0:.1f} s")
    for label, fn in (("16d (launch.train on a mesh)", mesh_train_leg),
                      ("16e (demo-lm on a mesh)", mesh_demo_leg)):
        t0 = time.perf_counter()
        fn(device, workdir)
        log(f"== phase {label}: {time.perf_counter() - t0:.1f} s")


def run(device, scale: float = SCALE, reps: int = 5) -> list:
    """Phases 2-16 on ``device``; returns the kernels records."""
    from repro_torch.core import registry
    from repro_torch.models.gnn import norm_csr
    from repro_torch.sparse import reddit_like

    t_run = time.perf_counter()

    def phase(label, fn, *args, faults_ok=False):
        _peak_reset(device)
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"== {label}: {time.perf_counter() - t0:.1f} s (run so far "
            f"{time.perf_counter() - t_run:.1f} s)")
        _peak(label, device)
        registry.clear_layout_memo()
        counts = fault_counts()
        log(f"{label}: {json.dumps(counts)}")
        if any(counts.values()) and not faults_ok:
            raise AssertionError(f"{label}: a fault or fallback on the main path: {counts}")
        return out

    def add(counts, more):
        for name, n in more.items():
            counts[name] = counts.get(name, 0) + n

    t0 = time.perf_counter()
    graph = reddit_like(scale, seed=0)
    log(f"reddit_like({scale}, seed=0): {graph.n_rows} nodes, {graph.nnz} edges, "
        f"avg degree {graph.nnz / graph.n_rows:.1f} ({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        phase("phase 2a (SpMM edge cases)", edge_cases, device)
        records = phase("phase 2 (SpMM kernels)", kernel_phase, norm_csr(graph), device, reps)
        counts = phase("phases 3-4 (SAGE inference)", model_phase, graph, device, work)
        t0 = time.perf_counter()
        dedup = graph.dedup_edges()
        log(f"dedup_edges: {dedup.nnz} edges, max degree {int(dedup.degrees.max())} "
            f"({time.perf_counter() - t0:.1f} s)")
        phase("phase 5a (attention edge cases)", attention_edge_cases, device)
        t0 = time.perf_counter()
        attn_lay = _attn_layouts(dedup, device)
        sync(device)
        log(f"attention layouts 8x8: nrb={attn_lay['nrb']} W={attn_lay['width']} "
            f"slots={attn_lay['n_slots']} ({time.perf_counter() - t0:.1f} s host conversion "
            "+ upload)")
        records.update(phase("phase 5 (attention kernels)", attention_kernel_phase, dedup,
                             attn_lay, device, reps))
        add(counts, phase("phase 6 (GAT inference)", gat_phase, dedup, device, work))
        phase("phase 7a (SDDMM edge cases)", sddmm_edge_cases, device)
        held = {"attn_lay": attn_lay}
        del attn_lay
        records.update(phase("phase 7 (SDDMM kernels)", sddmm_kernel_phase, dedup, held,
                             device, reps))
        add(counts, phase("phase 8 (SAGE training)", sage_train_phase, graph, device, work))
        add(counts, phase("phase 9 (GAT training)", gat_train_phase, dedup, device, work))
        record, more = phase("phase 10 (ops entry point)", ops_phase, dedup, device, reps)
        records[record["name"]] = record
        add(counts, more)
        add(counts, phase("phase 11 (minibatch SAGE training)", minibatch_phase, graph, device,
                          work))
        add(counts, phase("phase 12 (fleet and cross-device)", fleet_cross_device_phase, graph,
                          dedup, device, work, faults_ok=True))
        add(counts, phase("phase 13 (serving)", serve_phase, graph, device, work))
        del graph, dedup
        phase("phase 14 (LLM serving)", lm_serving_phase, device)
        _empty_cache(device)
        phase("phase 15 (LLM training)", lm_training_phase, device, work)
        _empty_cache(device)
        phase("phase 16 (multi-device paths, 4 ranks)", mesh_phase, device, work)
    log(f"main-path launches (sum of the counted runs): {json.dumps(counts)}")
    missing = [name for name in records if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for name, rec in records.items():
        rec["launches"] = counts[name]
    return list(records.values())


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-legs":  # a rank of phase 16a-c
        sys.path.insert(0, str(SRC))
        from torch.distributed.elastic.multiprocessing.errors import record

        return record(mesh_rank_main)(Path(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not all((SRC / "repro_torch" / "csrc" / f"{n}.cu").is_file() for n in KERNEL_SOURCES):
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build(KERNEL_SOURCES)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    device = torch.device("cuda", 0)
    records = run(device)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
