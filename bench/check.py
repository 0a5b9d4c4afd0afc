"""The numbers that decide ``correct``, and their limits.

Training cells compare three numbers with the reference's three SGD
steps from the same initial weights:

  loss_gap    the largest |loss - reference loss| / |reference loss|
              over the three steps;
  grad_gap    the first gradient, worked out from the state after one
              step as (w0 - w1) / lr on both sides: by the worst leaf,
              | |g| - |g_ref| | over max(|g_ref| of that leaf, the
              median leaf's |g_ref|);
  update_gap  the change w3 - w0 after three steps, by the worst leaf
              as above. Leaves whose reference gradient is under a
              thousandth of the median leaf's move by round-off alone
              and are left out of it.

A cell's limits are in ``workloads/<cell>.json`` with the readings they
were set from.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch

ZERO_GRAD_SHARE = 1e-3


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             names: Optional[List[str]] = None) -> float:
    """Worst leaf's | |got| - |want| | / max(|want|, median leaf |want|)."""
    names = list(want) if names is None else names
    ref = {n: float(torch.linalg.vector_norm(want[n].double())) for n in want}
    med = _median(list(ref.values()))
    worst = 0.0
    for n in names:
        g = float(torch.linalg.vector_norm(got[n].double()))
        worst = max(worst, abs(g - ref[n]) / max(ref[n], med, 1e-30))
    return worst


def training_numbers(w0, prog_losses, prog_w1, prog_w3, ref_losses, ref_w1, ref_w3,
                     lr: float) -> Dict[str, float]:
    """loss_gap, grad_gap and update_gap of a program's three steps
    against the reference's (weights are dicts by leaf name)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses))

    def grad(w1):
        return {n: (w0[n].double() - w1[n].double()) / lr for n in w0}

    def change(w3):
        return {n: w3[n].double() - w0[n].double() for n in w0}

    g_ref = grad(ref_w1)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in g_ref.items()}
    med = _median(list(norms.values()))
    moving = [n for n in w0 if norms[n] >= ZERO_GRAD_SHARE * med]
    return {
        "loss_gap": loss_gap,
        "grad_gap": norm_gap(grad(prog_w1), g_ref),
        "update_gap": norm_gap(change(prog_w3), change(ref_w3), moving),
    }


def load_limits(path: Path) -> Dict[str, float]:
    return {k: float(v) for k, v in json.loads(Path(path).read_text())["limits"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number at or under its limit (and finite)."""
    return all(name in numbers and numbers[name] == numbers[name]
               and numbers[name] <= limit for name, limit in limits.items())
