"""The MoE's grouped expert product (`models/moe.py` `_ragged_dot`, a
`torch.autograd.Function` with a backward written out) against the
formulation autograd differentiates itself: one `x[lo:hi] @ w[e]` per
non-empty group under autograd, concatenated, with zero rows past the
last group. The products are the same calls on the same shapes, so the
output and both gradients are equal to the bit on the CPU in fp32, and
with bf16 activations over fp32 weights `dw` comes out in the weights'
dtype, equal too.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_config, reduced
from repro_torch.core import obs
from repro_torch.models import api, moe, transformer
from repro_torch.train.loss import cross_entropy

E, D, F = 4, 6, 5

# name -> (rows, bounds): E + 1 bounds over `rows` sorted rows
CASES = {
    "even": (12, [0, 3, 6, 9, 12]),
    "empty_first": (12, [0, 0, 4, 8, 12]),
    "empty_middle": (12, [0, 5, 5, 9, 12]),
    "empty_last": (12, [0, 4, 8, 12, 12]),
    "rows_past_end": (12, [0, 2, 5, 7, 9]),
    "one_group_all_rows": (12, [0, 0, 12, 12, 12]),
    "one_row_each": (4, [0, 1, 2, 3, 4]),
}


def _oracle(x, w, bounds):
    """The per-group slicing autograd differentiates on its own."""
    parts = [x[bounds[e]:bounds[e + 1]] @ w[e].to(x.dtype)
             for e in range(w.shape[0]) if bounds[e + 1] > bounds[e]]
    if bounds[-1] < x.shape[0]:
        parts.append(x.new_zeros((x.shape[0] - bounds[-1], w.shape[-1])))
    return torch.cat(parts)


def _inputs(rows, seed=0, x_dtype=torch.float32, w_dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, D), generator=gen).to(x_dtype)
    w = torch.randn((E, D, F), generator=gen).to(w_dtype)
    g = torch.randn((rows, F), generator=gen).to(x_dtype)
    return x, w, g


def _run(fn, x, w, g, bounds):
    """fn's output and the gradients of x and w under the upstream g."""
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    out = fn(x, w, bounds)
    out.backward(g)
    return out.detach(), x.grad, w.grad


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_and_gradients_equal_the_oracle(name):
    rows, bounds = CASES[name]
    x, w, g = _inputs(rows)
    got = _run(moe._ragged_dot, x, w, g, bounds)
    want = _run(_oracle, x, w, g, bounds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # rows past the last group: zero output and zero gradient
    assert not got[0][bounds[-1]:].any() and not got[1][bounds[-1]:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_of_products_equals_the_oracle(name):
    """`_expert_compute`'s three products over one sorted input, whose
    gradient sums two (gate and up)."""
    rows, bounds = CASES[name]
    x, w, _ = _inputs(rows, seed=1)
    w = torch.randn((E, D, D), generator=torch.Generator().manual_seed(2))
    g = torch.randn((rows, D), generator=torch.Generator().manual_seed(3))

    def chain(ragged):
        def f(xs, w, bounds):
            h = torch.nn.functional.silu(ragged(xs, w, bounds))
            u = ragged(xs, w.flip(0), bounds)
            return ragged(h * u, w, bounds)
        return f

    got = _run(chain(moe._ragged_dot), x, w, g, bounds)
    want = _run(chain(_oracle), x, w, g, bounds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["even", "empty_middle", "rows_past_end"])
def test_under_non_reentrant_checkpoint(name):
    rows, bounds = CASES[name]
    x, w, g = _inputs(rows, seed=4)

    def remat(ragged):
        def f(x, w, bounds):
            return checkpoint(lambda a, b: torch.tanh(ragged(a, b, bounds)), x, w,
                              use_reentrant=False)
        return f

    before = obs.REGISTRY.total(obs.MOE_GROUPED_TOTAL, **{"pass": "forward"})
    got = _run(remat(moe._ragged_dot), x, w, g, bounds)
    # the forward and its recompute
    assert obs.REGISTRY.total(obs.MOE_GROUPED_TOTAL, **{"pass": "forward"}) - before == 2
    want = _run(lambda a, b, bs: torch.tanh(_oracle(a, b, bs)), x, w, g, bounds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["even", "empty_first", "rows_past_end"])
def test_bf16_activations_over_fp32_weights(name):
    rows, bounds = CASES[name]
    x, w, g = _inputs(rows, seed=5, x_dtype=torch.bfloat16)
    got = _run(moe._ragged_dot, x, w, g, bounds)
    want = _run(_oracle, x, w, g, bounds)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["even", "empty_middle", "rows_past_end", "one_row_each"])
def test_gradcheck_float64(name):
    rows, bounds = CASES[name]
    x, w, _ = _inputs(rows, seed=6, x_dtype=torch.float64, w_dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: moe._ragged_dot(a, b, bounds), (x, w))


@pytest.mark.parametrize("wants", [(True, True), (True, False), (False, True)])
def test_backward_takes_only_the_asked_products(wants):
    """Two products per non-empty group when both gradients are asked
    for, one when one is; no add and no full-size zero tensor."""
    rows, bounds = CASES["empty_middle"]
    x, w, g = _inputs(rows, seed=7)
    x.requires_grad_(wants[0])
    w.requires_grad_(wants[1])
    out = moe._ragged_dot(x, w, bounds)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func._overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        out.backward(g)
    groups = sum(bounds[e + 1] > bounds[e] for e in range(E))
    assert ops.names.count("mm") == groups * sum(wants)
    padded = {"select_backward", "slice_backward", "zeros", "new_zeros", "add", "add_", "cat"}
    assert not padded & set(ops.names)
    assert (x.grad is not None, w.grad is not None) == wants


def test_counter_reads_one_forward_and_one_backward_per_call():
    rows, bounds = CASES["even"]
    x, w, g = _inputs(rows, seed=8)

    def count(p):
        return obs.REGISTRY.total(obs.MOE_GROUPED_TOTAL, **{"pass": p})

    f0, b0 = count("forward"), count("backward")
    _run(moe._ragged_dot, x, w, g, bounds)
    assert (count("forward") - f0, count("backward") - b0) == (1, 1)
    with torch.no_grad():
        moe._ragged_dot(x, w, bounds)
    assert (count("forward") - f0, count("backward") - b0) == (2, 1)


def test_meta_call_returns_the_right_shapes():
    rows, bounds = CASES["rows_past_end"]
    x = torch.empty((rows, D), device="meta", requires_grad=True)
    w = torch.empty((E, D, F), device="meta", requires_grad=True)
    out = moe._ragged_dot(x, w, bounds)
    assert out.shape == (rows, F) and out.is_meta
    dx, dw = torch.autograd.grad(out, (x, w), torch.empty((rows, F), device="meta"))
    assert dx.shape == x.shape and dw.shape == w.shape and dx.is_meta and dw.is_meta


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "deepseek_v2_lite_16b"])
def test_whole_model_gradients_equal_the_oracle(arch, monkeypatch):
    """A reduced MoE LM's loss and every parameter's gradient, with remat,
    through the sorted dispatch: equal to the bit with the per-group
    autograd formulation put in the grouped product's place."""
    assert transformer.REMAT
    cfg = reduced(get_config(arch))
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(9))
    assert moe.dispatch_variant(cfg, toks.numel()) == "sorted_ragged"
    cpu = torch.device("cpu")

    def grads():
        model = api.init_model(cfg, 0, torch.float32, device=cpu)
        loss = cross_entropy(api.forward(model, {"tokens": toks}, cfg, device=cpu), toks)[0]
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss, got = grads()
    monkeypatch.setattr(moe, "_ragged_dot", _oracle)
    want_loss, want = grads()
    assert torch.equal(loss, want_loss)
    assert got.keys() == want.keys()
    for name in want:
        assert (got[name] is None) == (want[name] is None), name
        assert want[name] is None or torch.equal(got[name], want[name]), name
