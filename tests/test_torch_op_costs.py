"""repro_torch's op-by-op cost pass (`launch/op_costs.py`) on the CPU: the
twin of tests/test_hlo_costs.py, held against the JAX package's HLO
parser (`repro.launch.hlo_costs.module_costs`) on the same programs.

- FLOPs of small programs (one matmul, a loop of 8, nested 4 x 3, a
  rectangular product) equal JAX's count exactly: eager execution
  counts each executed op, as JAX's pass multiplies a loop body by its
  trip count.
- Reduced models, forward + backward at 2 x 64 tokens with remat:
  qwen3_14b equals JAX exactly, mamba2_2_7b within 1 %; deepseek's gap
  is JAX counting `ragged_dot` densely over every group, pinned exactly.
- Bytes: operand + result bytes per data-moving op; views cost nothing;
  the allocation guard raises on a host tensor over 1 MiB.
- Collectives: per-kind result bytes on a fake (1, 2, 2) process group
  (a subprocess), and the expert-parallel MoE forward's bytes against
  JAX's on 4 fake devices (another subprocess).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jx_get_config
from repro.configs.base import reduced as jx_reduced
from repro.launch.hlo_costs import module_costs
from repro.models import api as jx_api
from repro.train.loss import cross_entropy as jx_cross_entropy
from repro_torch.configs import get_config, reduced
from repro_torch.launch.op_costs import COLLECTIVES, CostMode, HostAllocation, op_costs
from repro_torch.models import api, moe
from repro_torch.models import transformer
from repro_torch.train.loss import cross_entropy

torch.set_num_threads(1)  # see test_torch_spmm.py

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
TIMEOUT_S = 300
A = jax.ShapeDtypeStruct((256, 256), jnp.float32)
MM = 2 * 256**3
META = torch.device("meta")


def _jax_flops(fn, *args):
    return module_costs(jax.jit(fn).lower(*args).compile().as_text()).flops


def _m(*shape):
    return torch.empty(shape, device=META)


# ------------------------------------------------------- small programs
def test_single_matmul_exact():
    assert op_costs(lambda x, y: x @ y, _m(256, 256), _m(256, 256)).flops == MM
    assert _jax_flops(lambda x, y: x @ y, A, A) == MM


def test_loop_counts_every_iteration():
    def loop(c, n):
        for _ in range(n):
            c = c @ c
        return c

    def body(c, _):
        return c @ c, None

    assert op_costs(loop, _m(256, 256), 8).flops == 8 * MM
    assert _jax_flops(lambda x: jax.lax.scan(body, x, None, length=8)[0], A) == 8 * MM


def test_nested_loops():
    def body(c, _):
        return c @ c, None

    def outer(c, _):
        return jax.lax.scan(body, c, None, length=4)[0], None

    def nested(c):
        for _ in range(3):
            for _ in range(4):
                c = c @ c
        return c

    assert op_costs(nested, _m(256, 256)).flops == 12 * MM
    assert _jax_flops(lambda x: jax.lax.scan(outer, x, None, length=3)[0], A) == 12 * MM


def test_rectangular_dot_contraction():
    want = 2 * 128 * 512 * 64
    assert op_costs(lambda a, b: a @ b, _m(128, 512), _m(512, 64)).flops == want
    x = jax.ShapeDtypeStruct((128, 512), jnp.float32)
    y = jax.ShapeDtypeStruct((512, 64), jnp.float32)
    assert _jax_flops(lambda a, b: a @ b, x, y) == want


# ------------------------------------------------------- reduced models
def _jax_grad_flops(arch):
    cfg = jx_reduced(jx_get_config(arch))
    params = jax.eval_shape(lambda k: jx_api.init_model(cfg, k, jnp.float32),
                            jax.random.PRNGKey(0))
    t = jax.ShapeDtypeStruct((2, 64), jnp.int32)

    def loss(p, toks, labels):
        return jx_cross_entropy(jx_api.forward(p, {"tokens": toks}, cfg), labels)[0]

    return _jax_flops(jax.grad(loss), params, t, t), cfg


def _port_grad_costs(arch):
    """(all FLOPs, FLOPs of `moe._ragged_dot` calls in the forward and its
    recompute) of forward + backward of the reduced model at 2 x 64."""
    cfg = reduced(get_config(arch))
    model = api.init_model(cfg, 0, torch.float32, device=META)
    toks = torch.empty((2, 64), dtype=torch.long, device=META)
    ragged = []
    real = moe._ragged_dot

    def counted(x, w, bounds):
        with CostMode() as inner:
            out = real(x, w, bounds)
        ragged.append(inner.costs.flops)
        return out

    moe._ragged_dot = counted
    try:
        with CostMode() as mode:
            cross_entropy(api.forward(model, {"tokens": toks}, cfg, device=META),
                          toks)[0].backward()
    finally:
        moe._ragged_dot = real
    return mode.costs.flops, sum(ragged), cfg


def test_reduced_qwen3_14b_equals_jax_and_analytic():
    """grad of the reduced LM with remat: the same count as JAX's HLO,
    100,663,296, within (0.9, 3) x 6·N·D as JAX's test asserts."""
    assert transformer.REMAT
    jf, jcfg = _jax_grad_flops("qwen3_14b")
    pf, rf, cfg = _port_grad_costs("qwen3_14b")
    assert pf == jf == 100_663_296 and rf == 0
    analytic = 6 * cfg.n_params() * 2 * 64
    assert 0.9 * analytic < pf < 3 * analytic, (pf, analytic)


def test_reduced_qwen3_14b_without_remat_is_6nd(monkeypatch):
    """Without the recompute the count is 81,788,928, exactly 6·N·D: at
    this size the attention products (12·B·S²·H·Dh per layer, forward
    and backward) equal what 6·N·D charges the embedding table, which
    does no product."""
    monkeypatch.setattr(transformer, "REMAT", False)
    pf, _, cfg = _port_grad_costs("qwen3_14b")
    b, s = 2, 64
    attn = cfg.n_layers * 12 * b * s * s * cfg.n_heads * cfg.resolved_head_dim
    assert attn == 6 * cfg.vocab * cfg.d_model * b * s
    assert pf == 6 * cfg.n_params() * b * s == 81_788_928


def test_reduced_mamba2_within_one_percent():
    jf, _ = _jax_grad_flops("mamba2_2_7b")
    pf, _, _ = _port_grad_costs("mamba2_2_7b")
    assert abs(pf / jf - 1) < 0.01, (pf, jf)


def test_reduced_deepseek_gap_is_jax_counting_ragged_dot_densely():
    """XLA's CPU HLO counts `jax.lax.ragged_dot` as a dense product over
    all E groups: E times the routed 2·M·D·F the port counts. Each routed
    product runs in the forward and in remat's recompute (``rf`` counts
    both) and has two products of the same size in its backward, so the
    routed total is 2·rf, and JAX's count is the port's plus (E - 1)
    times it, exactly."""
    jf, jcfg = _jax_grad_flops("deepseek_v2_lite_16b")
    pf, rf, cfg = _port_grad_costs("deepseek_v2_lite_16b")
    assert rf > 0 and pf < jf
    e = cfg.moe.n_experts
    assert jf == pf + (e - 1) * 2 * rf, (jf, pf, rf, e)


# ----------------------------------------------------------------- bytes
def test_matmul_bytes_are_operands_plus_result():
    assert op_costs(lambda x, y: x @ y, _m(256, 256), _m(256, 256)).bytes == 3 * 256**2 * 4


def test_views_cost_nothing():
    x = _m(256, 256)
    c = op_costs(lambda t: t.view(-1).reshape(256, 256).t().transpose(0, 1)[:, 3:].unsqueeze(0)
                 .expand(2, -1, -1).permute(1, 0, 2).detach(), x)
    assert c.bytes == 0 and c.flops == 0


def test_in_place_op_reads_and_writes():
    c = op_costs(lambda a, b: a.add_(b), _m(64, 64), _m(64, 64))
    assert c.bytes == 3 * 64 * 64 * 4  # read a, read b, write a


def test_allocation_guard_raises_on_host_tensors():
    with pytest.raises(HostAllocation, match="allocates nothing"):
        op_costs(lambda: torch.ones(512, 1024))  # 2 MiB on the CPU
    assert op_costs(lambda: torch.ones(4, 4)).bytes == 64  # small host tensors pass


def test_peak_tracks_live_storages():
    def two_temps(x):
        a = x * 2  # 1 MiB (meta), dies after b
        b = a + 1
        del a
        c = b * 3
        return c

    x = _m(512, 512)  # an argument: made before the pass, not counted
    with CostMode() as m:
        two_temps(x)
    assert m.peak_bytes == 2 * 512 * 512 * 4


# ----------------------------------------------------------- collectives
def _worker(mode, out, **env):
    base = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run(["nice", "-n", "10", sys.executable, str(TESTS / "torch_costs_worker.py"),
                        mode, str(out)], capture_output=True, text=True, timeout=TIMEOUT_S,
                       cwd=TESTS, env={**base, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", **env})
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return json.loads(Path(out).read_text())


@pytest.fixture(scope="module")
def colls(tmp_path_factory):
    d = tmp_path_factory.mktemp("costs")
    port = _worker("port", d / "port.json")
    jx = _worker("jax", d / "jax.json", JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return port, jx


@pytest.mark.parametrize("case, kind, nbytes", [
    ("psum_model", "all-reduce", 3 * 5 * 4),
    ("psum_data_model", "all-reduce", 2 * 3 * 5 * 4),  # one all-reduce per axis
    ("psum_pod", "all-reduce", 0),  # an axis of one rank issues nothing
    ("all_gather_data", "all-gather", 2 * 3 * 5 * 4),  # the gathered result
    ("all_to_all_data", "all-to-all", 4 * 5 * 4),
])
def test_collective_bytes_per_kind(colls, case, kind, nbytes):
    got = colls[0][case]
    assert got[kind] == nbytes
    assert set(got) == set(COLLECTIVES)
    assert sum(got.values()) == nbytes


def test_ep_moe_collectives_equal_jax(colls):
    """The expert-parallel MoE forward on (1, 2, 2): the dispatch,
    expert-id and return all-to-alls and the 'model' psum carry the
    same bytes per rank as JAX's per-device module (no combiner merged
    or split one at this size)."""
    port, jx = colls
    for kind in COLLECTIVES:
        assert port["moe_ep"][kind] == jx["moe_ep"].get(kind, 0.0), kind
    assert port["moe_ep"]["all-to-all"] > 0 and port["moe_ep"]["all-reduce"] > 0
