"""LM pretraining: AdamW steps of the port's train step, a closed loop.

Set-up draws the seed's weights on the card into the port's `LM` (built
on the meta device, so the weights are held once), makes one `AutoSage`
and the step ``train.step.make_train_step(cfg, AdamWConfig(**adamw),
sage=...)``, and takes the first `CHECKED_STEPS` steps through it: the
cold decisions, probes, transposes and layouts of the window layers'
CSR attention fall there. Each step trains on a new packed sequence
(`models/mellum2.py`). The same objects then run steps until the window
closes; ``train_step_ms`` is the window over the steps it completed.
Once the window has closed and the program is freed, the plain
reference takes the same first steps from the same weights and
batches, and three numbers compare them (`numbers`):

  loss_gap    the largest relative gap of the three losses;
  grad_gap    the first step's gradient as the update saw it (clipped),
              read from the program's AdamW state after that step
              (m = (1 - b1) g), against the reference's autograd
              gradient: by the worst leaf, | |g| - |g_ref| | over
              max(|g_ref| of that leaf, the median leaf's |g_ref|);
  update_gap  the change w3 - w0 after three steps, the same way, over
              the leaves whose reference gradient is at least a
              thousandth of the median leaf's (`bench.check`);
  routing_gap the experts the program took, against the top-k of the
              reference's router logits: the largest (best logit left
              out - smallest logit taken), over every token, layer and
              step of the three.

The reference routes by the experts the program took in those steps
(recorded by wrapping `repro_torch.models.moe._route` while they run;
the window runs unwrapped), and routing_gap checks those choices. Routed
by its own top-k, the reference would decide some near-ties the other
way by rounding alone (a last-bit difference in the hidden state), and
each such token moves the tokens after it through the window layers: on
the card one flip in layer 0 became 10, 27 and 88 in layers 1-3, and
the three numbers read as far from the program as from the TF32
controls.

The mix names the sequence length, the batch and the AdamW settings.
``bench/control.py`` drives `build`, `first_steps`, `free`,
`reference_steps` and `numbers` as it does for the GNN cells; its
``tf32_sparse`` control is TF32 in the window layers' q·k and P·V.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from bench import check, harness
from bench.models import mellum2 as fam
from bench.reference import mellum2 as ref
from bench.traffic.train import decisions
from bench.work import gnn as gnn_work
from bench.work import lm as lm_work

CHECKED_STEPS = 3


@dataclasses.dataclass
class Inputs:
    """What both sides share: the configuration, the seed (weights and
    batches are drawn again from it) and the checked steps' batches."""

    config: Dict[str, Any]
    seed: int
    device: torch.device
    batches: List[Dict[str, torch.Tensor]]
    routes: List[List[torch.Tensor]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Program:
    inputs: Inputs
    cfg: Any  # the port's ArchConfig
    state: Any
    sage: Any
    tokens: torch.Generator
    step: Any = None  # made by `first_steps`, which has the mix


@dataclasses.dataclass
class Record:
    """The first steps of one side: the losses, the first gradient's norm
    and the change's norm over the steps, by weight name; a reference's
    also the routing gap it found in the routes it was given."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    routing_gap: Optional[float] = None


def _adamw(mix: Dict[str, Any]):
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(**mix["adamw"])


def build(config: Dict[str, Any], seed: int, device: torch.device, workdir) -> Program:
    from repro_torch.core import AutoSage, ScheduleCache
    from repro_torch.models.api import init_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import TrainState

    cfg = fam.program_config(config)
    model = init_model(cfg, 0, torch.float32, "meta").to_empty(device=device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, w in fam.iter_weights(config, seed, device):
            params[name].copy_(w)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=device), model,
                       init_opt_state(model))
    sage = AutoSage(cache=ScheduleCache(path=str(workdir / "schedule_cache.json")),
                    device=device)
    return Program(Inputs(config, seed, device, []), cfg, state, sage,
                   fam.token_generator(seed, device))


def _change_norms(config, seed, device, now: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """|w_now - w0| by weight, w0 drawn again from the seed leaf by leaf."""
    return {name: float(torch.linalg.vector_norm((now[name].detach() - w0).double()))
            for name, w0 in fam.iter_weights(config, seed, device)}


@contextlib.contextmanager
def _recording_routes(model, steps: List[Dict[int, torch.Tensor]]) -> Iterator[None]:
    """While open, the experts each MoE layer takes go to ``steps[-1]``
    by layer (the first call of a layer in a step: its forward; the
    remat recompute takes the same); the routing is not changed."""
    from repro_torch.models import moe

    layer_of = {blk.ffn.router.data_ptr(): i for i, blk in enumerate(model.blocks)}
    real = moe._route

    def route(t, router, top_k):
        gates, ids = real(t, router, top_k)
        steps[-1].setdefault(layer_of[router.data_ptr()], ids.detach().clone())
        return gates, ids

    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def first_steps(prog: Program, mix: Dict[str, Any]) -> Record:
    """The train step of the mix's AdamW, and its first steps on the
    mix's first batches (kept in ``prog.inputs`` for the reference, with
    the experts each layer took)."""
    from repro_torch.train.step import make_train_step

    inp = prog.inputs
    prog.step = make_train_step(prog.cfg, _adamw(mix), device=inp.device, sage=prog.sage)
    inp.batches[:] = [fam.next_batch(inp.config, mix, prog.tokens) for _ in range(CHECKED_STEPS)]
    losses, grad_norms, taken = [], {}, []
    b1 = _adamw(mix).b1
    with _recording_routes(prog.state.params, taken):
        for i, batch in enumerate(inp.batches):
            taken.append({})
            prog.state, metrics = prog.step(prog.state, batch)
            losses.append(float(metrics["loss"]))
            if i == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                              for n, m in prog.state.opt.m.items()}
    inp.routes = [[step[i] for i in range(len(step))] for step in taken]
    params = dict(prog.state.params.named_parameters())
    return Record(losses, grad_norms, _change_norms(inp.config, inp.seed, inp.device, params))


def free(prog: Program) -> None:
    """Drop the program's state (weights, moments, scheduler, layouts)."""
    prog.state = prog.step = prog.sage = None
    gc.collect()
    if prog.inputs.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(config: Dict[str, Any], mix: Dict[str, Any], inputs: Inputs,
                    precision: str = "fp32", half_batch: bool = False) -> Record:
    """The plain reference's first steps from the seed's weights; in a
    lower precision, or with the fault "half of the tokens left out of
    the loss", it is the control put in the program's place."""
    if not inputs.routes:
        raise ValueError("the reference routes by the program's experts: take the program's "
                         "first steps (first_steps) before the reference's")
    weights = fam.weights(config, inputs.seed, inputs.device)
    routes = ref.Routes(inputs.routes)
    losses, grad_norms = ref.train(weights, inputs.batches, config, mix["adamw"], precision,
                                   half_batch, routes)
    change = _change_norms(config, inputs.seed, inputs.device, weights)
    del weights
    if inputs.device.type == "cuda":
        torch.cuda.empty_cache()
    return Record(losses, grad_norms, change, routes.gap)


def _norm_gap(got: Dict[str, float], want: Dict[str, float], names: List[str]) -> float:
    med = check._median(list(want.values()))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)


def numbers(inputs: Inputs, got: Record, want: Record, lr: float = 0.0) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got.losses, want.losses))
    med = check._median(list(want.grad_norms.values()))
    moving = [n for n, g in want.grad_norms.items() if g >= check.ZERO_GRAD_SHARE * med]
    # the program's routes are checked by the fp32 reference; a control
    # in the program's place checks them against its own logits
    routing = want.routing_gap if got.routing_gap is None else got.routing_gap
    return {"loss_gap": loss_gap,
            "grad_gap": _norm_gap(got.grad_norms, want.grad_norms, list(want.grad_norms)),
            "update_gap": _norm_gap(got.change_norms, want.change_norms, moving),
            "routing_gap": routing}


def work_model(config: Dict[str, Any], mix: Dict[str, Any]) -> Dict[str, Any]:
    """The step's model FLOPs and each scheduled call's work, counted on
    the window layers' band (n rows, nnz entries)."""
    n = int(mix["seq_len"]) * int(mix["batch"])
    nnz = lm_work.band_nnz(int(mix["seq_len"]), config["sliding_window"]) * int(mix["batch"])
    return {"step_flops": fam.step_flops(config, mix), "flops_peak": "fp32_flops",
            "call": lambda op, f: gnn_work.call_work(op, f, n, n, nnz)}


def run(r: harness.Run) -> harness.Outcome:
    config, mix = r.cell.config, r.cell.mix
    t = time.perf_counter()
    prog = build(config, r.seed, r.device, r.workdir)
    t_built = time.perf_counter()
    rec = first_steps(prog, mix)
    print(f"set-up: start {t - r.t0:.2f} s, inputs and program {t_built - t:.2f} s, "
          f"first {len(rec.losses)} steps {time.perf_counter() - t_built:.2f} s; "
          f"losses {rec.losses}; {harness.host_memory()}", file=sys.stderr)
    print(f"decisions: {decisions(prog.sage)}", file=sys.stderr)

    def step() -> bool:
        prog.state, metrics = prog.step(prog.state, fam.next_batch(config, mix, prog.tokens))
        return math.isfinite(float(metrics["loss"]))

    w = r.loop(step)
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    ms = w.seconds / w.steps * 1e3
    free(prog)
    want = reference_steps(config, mix, prog.inputs)
    return harness.Outcome({"train_step_ms": ms}, w.steps, w.failed,
                           numbers(prog.inputs, rec, want), peak, work_model(config, mix))
