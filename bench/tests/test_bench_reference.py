"""The plain reference against the port's CPU path on tiny graphs (the
test may import both; the reference itself imports neither the port nor
the JAX package)."""
import pytest
import torch

from bench import models
from bench.reference import gnn as ref

CPU = torch.device("cpu")
GAT_CFG = {"family": "gat", "graph_generator": "lognormal", "num_nodes": 300,
           "avg_degree": 12.0, "degree_sigma": 1.1, "graph_seed": 0, "dedup": True,
           "in_dim": 20, "hidden_size": 16}


def _close(a, b, rtol=2e-5):
    assert float((a - b).abs().max()) <= rtol * float(b.abs().max()) + 1e-7


@pytest.mark.parametrize("with_scheduler", [False, True])
@pytest.mark.parametrize("cfg", [GAT_CFG], ids=["gat"])
def test_full_graph_loss_and_gradients(cfg, with_scheduler, tmp_path):
    from repro_torch.core import AutoSage, ScheduleCache

    fam = models.family(cfg)
    inputs = models.make_inputs(cfg, 11, CPU)
    model = fam.program_model(cfg, inputs.weights, CPU)
    csr = models.program_csr(inputs.graph)
    sage = (AutoSage(cache=ScheduleCache(path=str(tmp_path / "c.json")), device="cpu")
            if with_scheduler else None)
    loss = fam.program_loss(cfg, model, csr, inputs.x, inputs.y, sage)()
    loss.backward()
    p = ref.Pattern(inputs.graph.rowptr, inputs.graph.colind, inputs.graph.n_cols)
    with ref.fp32_matmul():
        want_loss, want = fam.reference_loss(cfg, p, inputs)(inputs.weights)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    got = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for name in want:
        _close(got[name], want[name])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.5, 1.0 + 2 ** -10])
    got = ref.tf32_round(x)
    # 10 mantissa bits: half a unit rounds to even, 1.5 units up
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.5, 1.0 + 2 ** -10]
    assert torch.equal(ref.tf32_round(got), got)
    a, b = torch.randn(64, 300), torch.randn(300, 32)
    rel = float((ref.mm(a, b, "tf32") - a @ b).abs().max() / (a @ b).abs().max())
    assert 1e-5 < rel < 1e-2
    with pytest.raises(ValueError):
        ref.mm(a, b, "fp16")


def test_operands_round_forward_and_the_gradient_rounds_backward():
    t = torch.tensor([1.0 + 2 ** -11 + 2 ** -20, 2.0], requires_grad=True)
    fine = torch.tensor([1.0 + 2 ** -12, 1.0])
    out = ref.result(ref.operand(t, "tf32") * 1.0, "tf32")
    assert out.tolist() == ref.tf32_round(t.detach()).tolist()
    out.backward(fine)
    assert t.grad.tolist() == [1.0, 1.0]  # 1 + 2**-12 is rounded away on the way back
    assert ref.operand(t, "fp32") is t and ref.result(t, "fp32") is t


@pytest.mark.parametrize("precision", ["tf32", "tf32_sparse"])
def test_each_control_departs_from_fp32_by_rounding(precision):
    inputs = models.make_inputs(GAT_CFG, 5, CPU)
    p = ref.Pattern(inputs.graph.rowptr, inputs.graph.colind, inputs.graph.n_cols)
    exact, g = ref.gat_loss(p, inputs.x)(inputs.weights)
    low, g_low = ref.gat_loss(p, inputs.x, precision)(inputs.weights)
    assert 1e-7 < abs(float(low) - float(exact)) / float(exact) < 1e-2
    for n in g:
        rel = float((g_low[n] - g[n]).abs().max() / g[n].abs().max())
        assert 1e-6 < rel < 1e-2
    with pytest.raises(ValueError):
        ref.gat_loss(p, inputs.x, "bf16")
