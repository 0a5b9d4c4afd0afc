"""Full-graph training: SGD steps through one `AutoSage`, a closed loop.

Set-up makes the seed's graph, features and weights on the card, builds
the port's model, CSR and scheduler once, and takes the first
`CHECKED_STEPS` steps through the window's own call
(``train_gnn.sgd_step``): the cold decisions, probes, transposes and
layout preparation fall there. The same objects then run steps until
the window closes; ``train_step_ms`` is the window over the steps it
completed. Once the window has closed and the program is freed, the
plain reference takes the same first steps from the same initial
weights, and the three numbers of `bench.check` compare them.

Mix parameter: ``lr`` (the SGD step).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, List

import torch

from bench import check, harness, models
from bench.reference import gnn as ref

CHECKED_STEPS = 3  # bench.check compares the weights after the first and the last


@dataclasses.dataclass
class Program:
    inputs: models.Inputs
    model: Any
    csr: Any
    sage: Any
    loss_fn: Any


@dataclasses.dataclass
class Record:
    """The program's first steps: losses and weights after steps 1 and 3."""

    losses: List[float]
    w1: Dict[str, torch.Tensor]
    w3: Dict[str, torch.Tensor]


def build(config: Dict[str, Any], seed: int, device: torch.device, workdir) -> Program:
    from repro_torch.core import AutoSage, ScheduleCache

    fam = models.family(config)
    inputs = models.make_inputs(config, seed, device)
    model = fam.program_model(config, inputs.weights, device)
    csr = models.program_csr(inputs.graph)
    sage = AutoSage(cache=ScheduleCache(path=str(workdir / "schedule_cache.json")),
                    device=device)
    loss_fn = fam.program_loss(config, model, csr, inputs.x, inputs.y, sage)
    return Program(inputs, model, csr, sage, loss_fn)


def _weights(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def first_steps(prog: Program, mix: Dict[str, Any]) -> Record:
    from repro_torch.train_gnn import sgd_step

    losses, states = [], []
    for _ in range(CHECKED_STEPS):
        losses.append(sgd_step(prog.model, prog.loss_fn, float(mix["lr"])))
        states.append(_weights(prog.model))
    return Record(losses, states[0], states[-1])


def decisions(sage) -> Dict[str, Any]:
    """op|F -> (choice, probed ms of each candidate) of the scheduler's cache."""
    from bench.work.gnn import OP_KIND

    out = {}
    for op in OP_KIND:
        for key in sage.cache.keys_for_op(op):
            entry = sage.cache.get(key)
            out[f"{op}|{key.split('|')[2]}"] = (
                entry["choice"], {k: round(v, 3) for k, v in entry.get("probe_ms", {}).items()})
    return out


def free(prog: Program) -> None:
    """Drop the program's state (model, scheduler, layouts on the card)."""
    prog.model = prog.sage = prog.csr = prog.loss_fn = None
    gc.collect()
    torch.cuda.empty_cache()


def reference_steps(config: Dict[str, Any], mix: Dict[str, Any], inputs: models.Inputs,
                    precision: str = "fp32", half_batch: bool = False) -> Record:
    """The plain reference's first steps from the initial weights; in a
    lower precision, or with the fault "half of the batch left out", it
    is the control put in the program's place."""
    pattern = ref.Pattern(inputs.graph.rowptr, inputs.graph.colind, inputs.graph.n_cols)
    fn = models.family(config).reference_loss(config, pattern, inputs, precision, half_batch)
    losses, states = ref.sgd([fn] * CHECKED_STEPS, inputs.weights, float(mix["lr"]))
    return Record(losses, states[0], states[-1])


def numbers(inputs: models.Inputs, got: Record, want: Record, lr: float) -> Dict[str, float]:
    return check.training_numbers(inputs.weights, got.losses, got.w1, got.w3,
                                  want.losses, want.w1, want.w3, lr)


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.train_gnn import sgd_step

    config, mix = r.cell.config, r.cell.mix
    lr = float(mix["lr"])
    t = time.perf_counter()
    prog = build(config, r.seed, r.device, r.workdir)
    t_built = time.perf_counter()
    rec = first_steps(prog, mix)
    g = prog.inputs.graph
    print(f"graph: {g.n_rows} nodes, {g.nnz} edges", file=sys.stderr)
    print(f"set-up: start {t - r.t0:.2f} s, inputs and program {t_built - t:.2f} s, "
          f"first {len(rec.losses)} steps {time.perf_counter() - t_built:.2f} s; "
          f"{harness.host_memory()}", file=sys.stderr)
    print(f"decisions: {decisions(prog.sage)}", file=sys.stderr)

    def step() -> bool:
        return math.isfinite(sgd_step(prog.model, prog.loss_fn, lr))

    w = r.loop(step)
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    ms = w.seconds / w.steps * 1e3
    work = models.full_graph_work(config, prog.inputs.graph)
    free(prog)
    want = reference_steps(config, mix, prog.inputs)
    return harness.Outcome({"train_step_ms": ms}, w.steps, w.failed,
                           numbers(prog.inputs, rec, want, lr), peak, work)
