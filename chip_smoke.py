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
   slot, a single hub spanning many merge tiles, a partial last tile,
   tile_slots 3/8/16, every blocking). At Reddit-0.25 every blocking
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
   row blocks, one hub over 2048 slots, a deduplicated hub_skew graph;
   D = 64 and 256) and at the attention slice's shapes
   (reddit_like(0.25, seed=0).dedup_edges(), D = 256), same tolerance
   (an online softmax against the plain version's two-pass one); dense-W
   must equal ragged bit for bit and a second launch must give the same
   bits. Times of each kernel and its plain version beside the bound
   (the mask tiles and index arrays read once, q, k, v read once, out
   written once; 4 * nnz * D FLOPs), and of the composed CSR pipeline
   (gather SDDMM -> row softmax -> gather SpMM), the guardrail's
   baseline: no single PyTorch call computes CSR attention, so
   ``library_ms`` is null and the pipeline's time is ``baseline_pipe_ms``.
6. Attention main path: a GAT layer (configs/gnn_sage width 256, input
   width 602) with seeded random weights and features on the
   deduplicated Reddit-0.25 graph, forward under torch.no_grad through
   AutoSage.decide_attention (features -> estimate -> shortlist -> probe
   -> guardrail -> cache), held against the sage=None reference on the
   card; a fresh replay-only AutoSage replays the choice; then
   fused_attention_cuda and ragged_attention_cuda are pinned in turn
   through the cache, each forward must launch its kernel and match the
   reference, and the two outputs must be equal bit for bit.

The main path is every forward of phases 3, 4 and 6, through the entry
points a user calls: decide (probes included) + two forwards, the
replay forward, and each pinned forward. The launch counters of every
kernel are set to 0 just before each of these runs and read just after
it; a kernel's ``launches`` is the sum over them, and every kernel must
have launched. The host/device breakdown of a warm forward is timed
outside these runs and is not counted. The second-to-last line is the
kernels JSON, the last line the result JSON.
"""
from __future__ import annotations

import json
import math
import os
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
# tiles at tile_slots 8) and the table has > MERGE_MAX_BLOCKS tiles, so
# carry chains span several blocks of several tiles each
HUB_N = 16384
BLOCKINGS = ((8, 8), (16, 8), (8, 16))  # (rb, bc) the registry offers
REPLACES = {
    "spmm_block_ell": "src/repro/kernels/spmm_pallas.py:79",
    "spmm_ragged_ell": "src/repro/kernels/spmm_pallas.py:128",
    "spmm_merge_path": "src/repro/kernels/spmm_pallas.py:220",
    "fused_csr_attention": "src/repro/kernels/attention_pallas.py:60",
    "fused_ragged_attention": "src/repro/kernels/attention_pallas.py:141",
}
KERNEL_SOURCES = ("spmm", "attention")  # src/repro_torch/csrc/<name>.cu
D_ATTN = 256  # configs/gnn_sage width: the GAT layer's head dimension
ATTN_FAMILY_KERNEL = {
    "fused_attention_cuda": "fused_csr_attention",
    "ragged_attention_cuda": "fused_ragged_attention",
}
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


def check_close(name, got, want) -> float:
    """Raise unless got ~= want within the order-only tolerance; returns
    max |got - want|."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bad = err > RTOL * want.abs() + RTOL * scale
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside tolerance, max err {float(err.max())}"
        )
    return float(err.max()) if err.numel() else 0.0


def check_equal(name, a, b) -> None:
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"{name}: not bit-equal, max diff {float((a - b).abs().max())}")


def reset_launches() -> None:
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import spmm as ks

    ks.reset_launches()
    ka.reset_launches()


def launches() -> dict:
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import spmm as ks

    return {**ks.LAUNCHES, **ka.LAUNCHES}


def counted(label, fn, totals, device):
    """fn() under torch.no_grad with every launch count set to 0 just
    before it and read just after; the counts join the main path's
    ``totals``. Returns (fn's result, the counts)."""
    import torch

    reset_launches()
    with torch.no_grad():
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
    """Small graphs that hit the layouts' corners."""
    import numpy as np
    import torch

    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32),
                rng.standard_normal(int(deg.sum())).astype(np.float32), deg.size, 70)
    hub = single_hub(HUB_N, nnz_frac=0.9, seed=1)
    skew = hub_skew(3000, 4, 0.05, 300, seed=2)
    for tag, csr in (("empty-blocks", empty), ("single-hub", hub), ("hub-skew", skew)):
        for rb, bc in ((8, 8), (16, 8), (8, 16)):
            lay = _layouts(csr, device, rb, bc, tile_slots=(3, 8, 16))
            if rb == bc == 8:
                partial = [ts for ts, m in lay["merge"].items() if m[5] % ts]
                if not partial:
                    raise AssertionError(f"{tag}: no case with a partial last tile")
                if tag == "single-hub" and int((lay["merge"][8][2] == 0).sum()) < 32:
                    raise AssertionError("single-hub: the hub spans too few merge tiles")
            for f in (41, 256):
                b = torch.randn(csr.n_cols, f, generator=torch.Generator().manual_seed(f)).to(device)
                check_layouts(f"{tag} rb={rb} bc={bc} F={f}", csr, lay, b, device)
    log("edge cases: empty row blocks, single hub over many merge tiles, partial "
        "last tiles, tile_slots 3/8/16, blockings 8x8/16x8/8x16 at F=41,256: ok")


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


def _attn_run_all(lay, q, k, v, n_rows):
    """kernel name -> (kernel call, plain call)."""
    from repro_torch.kernels import attention as ka

    dense, ragged = lay["dense"], lay["ragged"]
    return {
        "fused_csr_attention": (
            lambda: ka.fused_csr_attention(*dense, q, k, v, n_rows=n_rows),
            lambda: ka.fused_csr_attention_plain(*dense, q, k, v, n_rows=n_rows),
        ),
        "fused_ragged_attention": (
            lambda: ka.fused_ragged_attention(*ragged, q, k, v, n_rows=n_rows),
            lambda: ka.fused_ragged_attention_plain(*ragged, q, k, v, n_rows=n_rows),
        ),
    }


def check_attention(tag, csr, lay, q, k, v, device) -> dict:
    """Both attention kernels against their plain versions; dense-W ==
    ragged bit for bit; a second launch gives the same bits; rows without
    edges come out 0. Returns max errors."""
    import torch

    errs, outs = {}, {}
    for name, (kern, plain) in _attn_run_all(lay, q, k, v, csr.n_rows).items():
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


def attention_edge_cases(device) -> None:
    """Small deduplicated graphs that hit the attention kernels' corners."""
    import numpy as np

    from repro_torch.sparse import CSR, hub_skew, single_hub

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    deg[2] = deg[45] = 0  # rows without edges inside row blocks that have some
    empty = CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                rng.integers(0, 70, int(deg.sum())).astype(np.int32), None, deg.size, 70)
    hub = single_hub(HUB_N, nnz_frac=0.9, seed=1)
    skew = hub_skew(3000, 4, 0.05, 300, seed=2)
    for tag, csr in (("empty-blocks/rows", empty), ("single-hub", hub), ("hub-skew", skew)):
        csr = csr.dedup_edges()
        lay = _attn_layouts(csr, device)
        if tag == "single-hub" and lay["width"] < HUB_N // 8:
            raise AssertionError(f"single-hub: the hub spans {lay['width']} slots only")
        for d in (64, 256):
            q, k, v = _qkv(csr, d, device, seed=d)
            check_attention(f"{tag} D={d}", csr, lay, q, k, v, device)
    log("attention edge cases: empty row blocks (dummy slot), rows without edges in "
        f"non-empty blocks, single hub over {HUB_N // 8} slots, hub_skew; D=64,256: ok")


def attention_kernel_phase(graph, device, reps: int) -> dict:
    """Phase 5 at the slice's shapes: the deduplicated Reddit-0.25 graph,
    D = 256. Returns the kernel records."""
    from repro_torch.core.probe import time_callable
    from repro_torch.core.registry import _dev
    from repro_torch.kernels import baselines as kb

    t0 = time.perf_counter()
    lay = _attn_layouts(graph, device)
    sync(device)
    log(f"attention layouts 8x8: nrb={lay['nrb']} W={lay['width']} slots={lay['n_slots']} "
        f"({time.perf_counter() - t0:.1f} s host conversion + upload)")
    q, k, v = _qkv(graph, D_ATTN, device, seed=7)
    errs = check_attention(f"reddit D={D_ATTN}", graph, lay, q, k, v, device)
    log(f"reddit-{SCALE} dedup D={D_ATTN}: max |kernel - plain| {json.dumps(errs)}; "
        "dense-W == ragged bit for bit; second launch bit-equal")
    aux = _dev(kb.prepare_csr(graph), device)
    base_ms = time_callable(lambda: kb.attention_csr(aux, q, k, v), device,
                            iters=reps).median_ms
    log(f"composed CSR pipeline (guardrail baseline) D={D_ATTN}: {base_ms} ms")
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
            "library_ms": None, "baseline_pipe_ms": base_ms,
        }
        records[name] = rec
        log(f"  {name} D={D_ATTN}: {json.dumps(rec)}")
    rag = records["fused_ragged_attention"]
    log("fused_ragged_attention s per live slot beyond the bound: "
        f"{(rag['ms'] - rag['bound_ms']) * 1e-3 / lay['n_slots']:.4e}")
    del lay, aux
    _empty_cache(device)
    return records


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
    del replay, out_r
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


def run(device, scale: float = SCALE, reps: int = 5) -> list:
    """Phases 2-6 on ``device``; returns the kernels records."""
    from repro_torch.models.gnn import norm_csr
    from repro_torch.sparse import reddit_like

    t0 = time.perf_counter()
    graph = reddit_like(scale, seed=0)
    log(f"reddit_like({scale}, seed=0): {graph.n_rows} nodes, {graph.nnz} edges, "
        f"avg degree {graph.nnz / graph.n_rows:.1f} ({time.perf_counter() - t0:.1f} s)")
    edge_cases(device)
    records = kernel_phase(norm_csr(graph), device, reps)
    with tempfile.TemporaryDirectory() as tmp:
        counts = model_phase(graph, device, Path(tmp))
    t0 = time.perf_counter()
    dedup = graph.dedup_edges()
    del graph
    log(f"dedup_edges: {dedup.nnz} edges, max degree {int(dedup.degrees.max())} "
        f"({time.perf_counter() - t0:.1f} s)")
    attention_edge_cases(device)
    records.update(attention_kernel_phase(dedup, device, reps))
    with tempfile.TemporaryDirectory() as tmp:
        for name, n in gat_phase(dedup, device, Path(tmp)).items():
            counts[name] = counts.get(name, 0) + n
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
