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

The main path is every forward of phases 3, 4 and 6, every training
step of phases 8, 9 and 11, the ops chain of phase 10 and the runner
calls of phases 12a-c, through the entry points a user calls: decide
(probes included) + two forwards or the training steps, the replay run,
and each pinned run. The launch counters of every kernel are set to 0
just before each of these runs and read just after it; a kernel's
``launches`` is the sum over them, and every kernel must have launched.
Resilience is on (the default) throughout: after each of phases 2-11
the smoke reads autosage_faults_total and autosage_fallback_total and
fails unless both are 0, so no kernel of the main path hid behind a
fallback. The host/device breakdown of a warm forward is timed outside
these runs and is not counted. Peak device memory is printed per phase.
The second-to-last line is the kernels JSON, the last line the result
JSON.
"""
from __future__ import annotations

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


def _run_cmd(cmd, timeout_s):
    """Run ``cmd`` in a session of its own; on timeout kill the whole
    group (the fleet's workers too). Returns (rc, stdout, stderr)."""
    import signal

    envv = {**os.environ, "PYTHONPATH": os.pathsep.join(
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


def run(device, scale: float = SCALE, reps: int = 5) -> list:
    """Phases 2-12 on ``device``; returns the kernels records."""
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
    log(f"main-path launches (sum of the counted runs): {json.dumps(counts)}")
    missing = [name for name in records if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for name, rec in records.items():
        rec["launches"] = counts[name]
    return list(records.values())


def main() -> int:
    import torch

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
