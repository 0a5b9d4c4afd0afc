"""The dry run's CLI (the port's twin of repro/launch/dryrun.py): cost
every (arch x shape x mesh) cell on fake 256- and 512-rank worlds.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out results/dryrun_torch.json] [--force] [--verbose]

It takes no device and touches no card: every tensor is on the meta
device and every collective goes to a fake process group that this
process joins as rank 0 (see `launch.dryrun_lib`). Cells already ``ok``
in ``--out`` are skipped unless ``--force``; the exit code is 1 if a
cell failed in this run.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun_lib import (
    LM_ARCHS,
    cell_key,
    finish,
    load_results,
    run_cell,
    save_results,
)

DEFAULT_OUT = "results/dryrun_torch.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run: cost every (arch x shape x mesh) cell on fake H100 meshes")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    archs = LM_ARCHS if args.arch == "all" else [args.arch.replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = load_results(args.out)
    n_fail = 0
    try:
        for mp in meshes:  # one fake world per mesh size
            for arch in archs:
                for shape in shapes:
                    key = cell_key(arch, shape, mp)
                    if key in results and results[key].get("ok") and not args.force:
                        continue
                    print(f"[dryrun] {key} ...", flush=True)
                    res = run_cell(arch, shape, mp)
                    results[key] = res
                    save_results(args.out, results)
                    if res["ok"]:
                        r = res["roofline"]
                        print(
                            f"  ok ({res['pass_s']}s) bottleneck={r['bottleneck']} "
                            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                            f"coll={r['collective_s']:.4f}s",
                            flush=True,
                        )
                        print(f"  memory: {res['memory']}", flush=True)
                    else:
                        n_fail += 1
                        print(f"  FAIL: {res['error']}", flush=True)
                        if args.verbose:
                            print(res.get("traceback", ""))
    finally:
        finish()
    done = sum(1 for r in results.values() if r.get("ok"))
    print(f"[dryrun] {done} cells ok, {n_fail} failed this run -> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
