"""One fleet trainer, as a subprocess: decide a deterministic stream of
sampled subgraphs through a BatchScheduler against a (possibly shared)
schedule cache, then print one JSON line of stats.

The port's twin of benchmarks/shared_worker.py, with the same stream
(`build_stream`), the same arguments and the same JSON stats line, plus
``--device`` (default: the CUDA card):

    PYTHONPATH=src python -m repro_torch.shared_worker --cache /tmp/c.json \
        --shared --n-graphs 32 --rows 256 --seed 1 --device cpu

Workers with different --seed sample different row subsets from the same
degree regimes, so they hit the SAME schedule buckets (the fleet
workload: peers serve the same traffic mix, not the same graphs). The
same worker measures the isolated and the shared configuration, so
"probes avoided by sharing" compares like with like.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_stream(n_graphs: int, rows: int, seed: int, regimes: int = 4):
    """<= 4 (default) or 8 degree regimes, mid-bin so every worker's
    samples canonicalize into the same buckets; the JAX worker's stream
    for the same arguments, graph for graph."""
    from repro_torch.sparse import fixed_degree, hub_skew, sample_subgraph_stream

    if regimes == 8:
        parents = [
            fixed_degree(2048, d, seed=11 + i)
            for i, d in enumerate((3, 6, 12, 24, 48, 96))
        ] + [
            hub_skew(2048, 6, 0.10, 60, seed=17),
            hub_skew(2048, 6, 0.10, 200, seed=18),
        ]
    else:
        parents = [
            fixed_degree(2048, 3, seed=11),
            fixed_degree(2048, 12, seed=12),
            fixed_degree(2048, 48, seed=13),
            hub_skew(2048, 6, 0.10, 60, seed=14),
        ]
    return sample_subgraph_stream(parents, n_graphs, rows_per_graph=rows, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", required=True)
    ap.add_argument("--shared", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="serve the stream replay-only from the cache "
                         "(no probes; a miss raises ReplayMiss)")
    ap.add_argument("--n-graphs", type=int, default=32)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--f", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-ms", type=float, default=10_000.0)
    ap.add_argument("--regimes", type=int, default=4, choices=(4, 8),
                    help="degree regimes in the stream")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--device-sig", default=None,
                    help="simulate a device class: sets "
                         "AUTOSAGE_DEVICE_SIG_OVERRIDE for this worker")
    ap.add_argument("--hw-profile", default=None,
                    help="roofline profile for this worker "
                         "(AUTOSAGE_HW_PROFILE: cpu, cpu_wide, h100)")
    ap.add_argument("--no-transfer", action="store_true",
                    help="disable the cross-device transfer tier "
                         "(AUTOSAGE_TRANSFER=0): the cold-start configuration")
    args = ap.parse_args(argv)

    if args.device_sig:
        os.environ["AUTOSAGE_DEVICE_SIG_OVERRIDE"] = args.device_sig
    if args.hw_profile:
        os.environ["AUTOSAGE_HW_PROFILE"] = args.hw_profile
    if args.no_transfer:
        os.environ["AUTOSAGE_TRANSFER"] = "0"

    from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache

    sage = AutoSage(
        cache=ScheduleCache(path=args.cache, shared=args.shared,
                            replay_only=args.replay or None),
        probe_iters=1, probe_cap_ms=25, probe_frac=0.25, device=args.device,
    )
    stream = build_stream(args.n_graphs, args.rows, args.seed, args.regimes)
    bs = BatchScheduler(sage, probe_budget_ms=args.budget_ms, seed=args.seed)
    trace_choices = [bs.decide(g, args.f, "spmm").choice for g in stream]
    if not args.replay:
        bs.finalize()
    print(json.dumps({
        "stats": bs.stats(),
        "bucket_choices": {r["bucket"]: r["choice"] for r in bs.bucket_stats()},
        "bucket_transfers": {
            r["bucket"]: r["transfer_verdict"] for r in bs.bucket_stats()
            if r["transferred"]
        },
        "trace_choices": trace_choices,
        "trace_keys": [ev["key"] for ev in bs.trace],
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
