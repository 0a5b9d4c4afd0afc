"""The roofline table of the port's dry run, per mesh (the port's twin of
repro/launch/report.py), from ``results/dryrun_torch.json``. The terms
are datasheet bounds for H100 SXM5 ranks (`launch.roofline`).

    PYTHONPATH=src python -m repro_torch.launch.report [--results results/dryrun_torch.json]
        [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict


def _advice(r: Dict) -> str:
    roof = r["roofline"]
    bn = roof["bottleneck"]
    kind = r.get("kind", "?")
    if bn == "memory":
        if kind in ("decode", "long_decode"):
            return "KV-cache traffic dominates: quantize cache / multi-query"
        return "activation+weight traffic: fuse eager ops, bf16 flash attention"
    if bn == "collective":
        return "inter-node traffic over the NICs: shard weights, overlap collectives"
    return "tensor-core-bound: near the bf16 roofline; raise per-card batch"


def rows(results: Dict, mesh: str) -> list:
    """The table's data lines for ``mesh`` ('single' or 'multi')."""
    out = []
    ok = {k: v for k, v in results.items() if k.endswith(f"|{mesh}") and v.get("ok")}
    for k in sorted(ok):
        r = ok[k]
        roof = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {roof['compute_s']:.4f} | "
            f"{roof['memory_s']:.4f} | {roof['collective_s']:.4f} | "
            f"**{roof['bottleneck']}** | "
            f"{'n/a' if ratio is None else f'{ratio:.2f}'} | {_advice(r)} |"
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh in meshes:
        name = "16x16 single-pod" if mesh == "single" else "2x16x16 multi-pod"
        print(f"\n### Roofline — {name}, H100 SXM5 datasheet bounds\n")
        print("| arch | shape | compute (s) | memory (s) | collective (s) | bottleneck | "
              "MODEL/counted flops | what moves the dominant term |")
        print("|---|---|---|---|---|---|---|---|")
        for line in rows(results, mesh):
            print(line)
        fails = {k: v for k, v in results.items() if k.endswith(f"|{mesh}") and not v.get("ok")}
        if fails:
            print(f"\nFailed cells ({mesh}):")
            for k, v in sorted(fails.items()):
                print(f"  {k}: {v.get('error', '?')[:160]}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
