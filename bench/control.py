"""Readings that set a training cell's limits: the program's numbers on
many seeds (the lower reading) and the control's and the faults' (the
upper), at the cell's own size, in one process.

    python3 bench/control.py --workload gat-products.train --seeds 11,12,13 \
        --control-seeds 13,14,15 > readings.jsonl

On every seed of ``--seeds`` the program takes its checked first steps
and is freed, and the fp32 reference follows. On every seed of
``--control-seeds`` the reference is also run in TF32 (the control: the
nearest precision below the configuration's fp32), in TF32 in the
sparse products alone, and with half of the batch left out of the loss
(a fault), each against the fp32 reference;
the program is not run for a control seed that is not also in
``--seeds``. A state left unchanged reads 1 on update_gap by
construction and needs no run. One JSON line per seed and kind; the
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="comma-separated seeds of the program")
    ap.add_argument("--control-seeds", default="", help="seeds of the control and the fault")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    workdir = harness.workdir_for(cell.name + ".control")
    harness.prepare_env(workdir, trace=False)

    import torch

    from bench import models
    from repro_torch.core import registry

    generator = harness.load_by_path(harness.BENCH / "traffic" / f"{cell.mix['generator']}.py")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    config, mix = cell.config, cell.mix
    lr = float(mix["lr"])
    program = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(program + controls):
        t0 = time.perf_counter()
        rows = []
        if seed in program:
            prog = generator.build(config, seed, device, workdir)
            rows.append(("program", generator.first_steps(prog, mix)))
            generator.free(prog)
            inputs = prog.inputs
            del prog
            registry.clear_layout_memo()
            workdir = harness.workdir_for(cell.name + ".control")
        else:
            inputs = models.make_inputs(config, seed, device)
        want = generator.reference_steps(config, mix, inputs)
        if seed in controls:
            rows.append(("control_tf32", generator.reference_steps(config, mix, inputs, "tf32")))
            rows.append(("control_tf32_sparse", generator.reference_steps(
                config, mix, inputs, "tf32_sparse")))
            rows.append(("fault_half_batch", generator.reference_steps(
                config, mix, inputs, half_batch=True)))
        for kind, got in rows:
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              **generator.numbers(inputs, got, want, lr),
                              "losses": got.losses, "ref_losses": want.losses,
                              "seconds": time.perf_counter() - t0}), flush=True)
        del inputs, want, rows
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
