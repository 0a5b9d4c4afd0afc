"""A run with the timed path broken underneath reports ``correct``
false: each cell on the CPU at a tiny size, the harness's look for a
card skipped, once clean and once per fault a training cell can have (a
step that leaves its state unchanged; half of the batch left out, the
mean taken over the rest). The cells' own limits were read on the card
at the cells' sizes, where the program's gaps are near 1e-8; at this
size the CPU's rounding reads up to 3.3e-7, so the runs here are judged
by `TINY_LIMITS`, read at this size (test_bench_control.py)."""
import time
from pathlib import Path

import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {"num_nodes": 300, "avg_degree": 12.0, "in_dim": 20, "hidden_size": 16}
# read on the CPU over 8 seeds a cell at this size and test_bench_control's: the program
# at most 3.3e-7 in any number, each TF32 control 2.9e-5 or more in its largest
TINY_LIMITS = {"loss_gap": 2e-6, "grad_gap": 2e-6, "update_gap": 2e-6}


def _run(cell_name, tmp_path, seed=2 ** 33 + 9):
    cell = harness.load_cell(ROOT, cell_name)
    cell.config = dict(cell.config, **{k: v for k, v in TINY.items() if k in cell.config})
    cell.limits = TINY_LIMITS
    return harness.run_cell(cell, seed, 0.5, False, torch.device("cpu"), time.perf_counter(),
                            tmp_path)


def _no_update(monkeypatch):
    from repro_torch import train_gnn

    def frozen(model, loss_fn, lr=train_gnn.LR):
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return float(loss.detach())

    monkeypatch.setattr(train_gnn, "sgd_step", frozen)


def _half_batch_gat(monkeypatch):
    from repro_torch.models import gnn

    real = gnn.GAT.forward

    def half(self, csr, x, sage=None):
        out = real(self, csr, x, sage=sage)
        return out[: out.shape[0] // 2] * 2 ** 0.5  # 0.5 |out|^2 / n: the mean of the half

    monkeypatch.setattr(gnn.GAT, "forward", half)


CASES = [(cell, fault) for cell in ("gat-products.train",)
         for fault in (None, _no_update, _half_batch_gat)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'clean'}" for c, f in CASES])
def test_fault_turns_correct_false(cell, fault, tmp_path, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    result = _run(cell, tmp_path)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert all(c["value"] is not None for c in result["checks"].values())
