"""Subprocess work for tests/test_torch_op_costs.py (run as a script:
``python torch_costs_worker.py MODE OUT.json``); a process group and a
forced XLA device count are process-global, so each side runs alone.

* ``port``: this process joins a fake process group of 4 ranks as rank
  0, builds the (1, 2, 2) mesh on the meta device and writes the
  per-kind collective bytes of `collectives.psum`, `all_gather` and
  `all_to_all` on known shapes, and of the expert-parallel MoE forward
  at ``reduced(qwen3_moe_235b_a22b)``, under `launch.op_costs.CostMode`.
* ``jax``: on 4 fake CPU devices (XLA_FLAGS must force them), JAX's
  `hlo_costs.module_costs(...).coll` of the same MoE forward.
"""
import json
import sys

MESH = (1, 2, 2)
BATCH, SEQ, CF = 4, 8, 8.0
ARCH = "qwen3_moe_235b_a22b"


def port(out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_costs import CostMode
    from repro_torch.models import moe
    from repro_torch.models.modules import make_generator

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_mesh(dict(zip(("pod", "data", "model"), MESH)), device="meta")
    x = torch.empty((3, 5), device="meta")
    res = {}
    cases = {
        "psum_model": lambda: collectives.psum(x, mesh, "model"),
        "psum_data_model": lambda: collectives.psum(x, mesh, ("data", "model")),
        "psum_pod": lambda: collectives.psum(x, mesh, "pod"),
        "all_gather_data": lambda: collectives.all_gather(x, mesh, "data", dim=0),
        "all_to_all_data": lambda: collectives.all_to_all(torch.empty((4, 5), device="meta"),
                                                           mesh, "data"),
    }
    for name, fn in cases.items():
        with CostMode() as m:
            fn()
        res[name] = dict(m.costs.coll)
    cfg = reduced(get_config(ARCH))
    params = moe.init_moe(make_generator(0, "meta"), cfg, torch.float32)
    specs = moe.moe_param_specs(cfg)
    for leaf in ("w_gate", "w_up", "w_down"):
        setattr(params, leaf, torch.nn.Parameter(
            sharding.local_block(getattr(params, leaf), specs[leaf], mesh).clone()))
    xs = torch.empty((BATCH // MESH[1], SEQ, cfg.d_model), device="meta")  # rank 0's rows
    with torch.no_grad(), CostMode() as m:
        moe.moe_ffn_ep(params, xs, cfg, mesh, capacity_factor=CF)
    res["moe_ep"] = dict(m.costs.coll)
    res["moe_ep_flops"] = m.costs.flops
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def jax_side(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config, reduced
    from repro.launch.hlo_costs import module_costs
    from repro.models import moe

    cfg = reduced(get_config(ARCH))
    params = jax.eval_shape(lambda k: moe.init_moe(k, cfg, jnp.float32), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((BATCH, SEQ, cfg.d_model), jnp.float32)
    mesh = jax.make_mesh(MESH, ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    fn = jax.jit(lambda p, a: moe.moe_ffn_ep(p, a, cfg, mesh, capacity_factor=CF))
    c = module_costs(fn.lower(params, x).compile().as_text())
    with open(out, "w") as f:
        json.dump({"moe_ep": dict(c.coll), "moe_ep_flops": c.flops}, f)


if __name__ == "__main__":
    {"port": port, "jax": jax_side}[sys.argv[1]](sys.argv[2])
    print("OK")
