"""The port's side of tests/test_torch_distributed.py: one rank of a
4-rank gloo world on the CPU, started by

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/torch_dist_worker.py OUT

after tests/torch_dist_jax_refs.py has written OUT/refs.npz. Every case
runs on every rank; each error is reduced over the ranks (max) and rank
0 writes OUT/port.json. Mesh checkpoints go to OUT/port_ck_<case>/.
Run with REPRO_MOE_CF=8 in the environment (nothing drops in training).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.synthetic import PipelineState, token_batch
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    batch_axes_for,
    local_block,
    localize,
    param_specs,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.modules import load_tree, make_generator
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step, shard_state

torch.set_num_threads(1)
CPU = torch.device("cpu")
OUT = Path(sys.argv[1])
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
TRAIN_STEPS = 3
SEQ_SPEC = (None, ("data", "model"), None, None)
results = {}


def record(name, value) -> None:
    """The max of ``value`` over the ranks."""
    t = torch.tensor(float(value), dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    results[name] = float(t)


def rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def tree(npz, prefix):
    """The arrays under ``prefix/`` as a nested dict."""
    out = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return out


def mesh_of(shape):
    return make_mesh(dict(zip(("pod", "data", "model"), shape)), CPU)


refs = np.load(OUT / "refs.npz")
meta = json.loads((OUT / "refs.json").read_text())
meshes = {tuple(s): mesh_of(s) for s in ((1, 2, 2), (2, 2, 1))}
mesh122 = meshes[(1, 2, 2)]


def ep_params(name, cfg, mesh, dtype):
    p = moe.init_moe(make_generator(0, CPU), cfg, dtype)
    load_tree(p, tree(refs, f"moe/{name}/params"))
    specs = {k: v for k, v in moe.moe_param_specs(cfg).items() if k != "shared"}
    localize(p, specs, mesh)
    return p, specs


# ------------------------------------------------------- EP MoE forward
for key, m in meta.items():
    if not key.startswith("moe/"):
        continue
    name = key.split("/")[1]
    cfg = reduced(get_config(m["arch"]))
    mesh = meshes[tuple(m["mesh"])]
    dtype = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    p, _ = ep_params(name, cfg, mesh, dtype)
    x = torch.from_numpy(refs[f"moe/{name}/x"]).to(dtype)
    rows = collectives.rows(x.shape[0], mesh, batch_axes_for(x.shape[0], mesh))
    if m["compact"]:
        os.environ["REPRO_MOE_COMPACT"] = "1"
    try:
        with torch.no_grad():
            out = moe.moe_ffn_ep(p, x[rows], cfg, mesh, capacity_factor=m["cf"])
    finally:
        os.environ.pop("REPRO_MOE_COMPACT", None)
    record(f"moe/{name}/err", rel(out, refs[f"moe/{name}/out"][rows]))
    if name == "overflow":
        t = x[rows].reshape(-1, cfg.d_model)
        _, ids = moe._route(t, p.router, cfg.moe.top_k)
        n_data = 2
        cap = moe.capacity(t.shape[0], cfg.moe.top_k, n_data, m["cf"])
        _, _, _, _, keep, written = moe.dispatch_plan(ids.reshape(-1), cfg.moe.n_experts // n_data,
                                                     n_data, cap)
        lost = torch.tensor([int((keep & ~written).sum()), int((~keep).sum())])
        dist.all_reduce(lost)
        results["moe/overflow/kept_but_lost"] = int(lost[0])
        results["moe/overflow/dropped"] = int(lost[1])

# --------------------------------------------------- EP MoE gradients
for shape in ((1, 2, 2), (2, 2, 1)):
    mesh = meshes[shape]
    cfg = reduced(get_config("qwen3_moe_235b_a22b"))
    full = moe.init_moe(make_generator(0, CPU), cfg)
    load_tree(full, tree(refs, "moe/cf8/params"))
    p, specs = ep_params("cf8", cfg, mesh, torch.float32)
    x = torch.from_numpy(refs["moe/cf8/x"])
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    xr = x.clone().requires_grad_(True)
    (moe.moe_ffn_ref(full, xr, cfg) * r).sum().backward()
    ba = batch_axes_for(x.shape[0], mesh)
    rows = collectives.rows(x.shape[0], mesh, ba)
    xl = x[rows].clone().requires_grad_(True)
    (moe.moe_ffn_ep(p, xl, cfg, mesh, capacity_factor=8.0) * r[rows]).sum().backward()
    tag = "x".join(map(str, shape))
    record(f"moe_grad/{tag}/x", rel(xl.grad, xr.grad[rows]))
    for w in ("w_gate", "w_up", "w_down"):
        # a slice holds its pod's tokens' share: the pods' replicas sum
        g = collectives.psum(getattr(p, w).grad, mesh, "pod")
        record(f"moe_grad/{tag}/{w}", rel(g, local_block(getattr(full, w).grad, specs[w], mesh)))
    router = collectives.psum(p.router.grad, mesh, ba)
    record(f"moe_grad/{tag}/router", rel(router, full.router.grad))

# ------------------------------------------------ sharded attention
acfg = reduced(get_config("qwen3_14b"))
ap = attn.init_gqa(make_generator(0, CPU), acfg)
load_tree(ap, tree(refs, "attn/params"))
k0, v0 = torch.from_numpy(refs["attn/k"]), torch.from_numpy(refs["attn/v"])
for pos in meta["attn"]["pos"]:
    x = torch.from_numpy(refs[f"attn/{pos}/x"])
    positions = torch.full((x.shape[0], 1), pos)
    k_loc = local_block(k0, SEQ_SPEC, mesh122).clone()
    v_loc = local_block(v0, SEQ_SPEC, mesh122).clone()
    before = k_loc.clone()
    with torch.no_grad():
        out, new = attn.csr_window_attention_sharded(
            ap, x, acfg, positions, {"k": k_loc, "v": v_loc, "pos": pos}, mesh122)
    record(f"attn/{pos}/out", rel(out, refs[f"attn/{pos}/out"]))
    record(f"attn/{pos}/k", rel(new["k"], local_block(torch.from_numpy(refs[f"attn/{pos}/k_after"]),
                                                      SEQ_SPEC, mesh122)))
    record(f"attn/{pos}/v", rel(new["v"], local_block(torch.from_numpy(refs[f"attn/{pos}/v_after"]),
                                                      SEQ_SPEC, mesh122)))
    offset = collectives.axis_index(mesh122, ("data", "model")) * k_loc.shape[1]
    changed = (new["k"] != before).any(dim=(0, 2, 3)).nonzero().flatten() + offset
    record(f"attn/{pos}/rows_written_elsewhere", int((changed != pos).sum()))
    record(f"attn/{pos}/owner_wrote", int(pos in changed.tolist()) if
           offset <= pos < offset + k_loc.shape[1] else 1)
    record(f"attn/{pos}/new_pos", new["pos"] - (pos + 1))
    if pos >= acfg.long_sinks:
        with torch.no_grad():
            naive, _ = attn.csr_window_attention(ap, x, acfg, positions,
                                                 {"k": k0.clone(), "v": v0.clone(), "pos": pos})
        record(f"attn/{pos}/vs_naive", rel(out, naive))

# -------------------------------------------------- compressed psum
mesh4 = mesh_of((4, 1, 1))
me = collectives.axis_index(mesh4, "pod")
xr = torch.from_numpy(refs["psum/x"][me:me + 1])
efr = torch.from_numpy(refs["psum/ef"][me:me + 1])
q, scale = compress._quant(xr + efr)
record("psum/q_mismatch", int((q.numpy() != refs[f"psum/q/{me}"]).sum()))
deq = (q.float() * scale).numpy()
record("psum/deq_mismatch", int((deq.view(np.int32) != refs[f"psum/deq/{me}"].view(np.int32)).sum()))
out, new_ef = compress.compressed_psum(xr, mesh4, "pod", efr)
record("psum/out", rel(out, refs["psum/out"][me:me + 1]))
# xf - deq: XLA contracts it into one fused multiply-add, so it is held
# to the scale of its operands, not of the small residual
record("psum/new_ef", float((new_ef - torch.from_numpy(refs["psum/new_ef"][me:me + 1])).abs().max())
       / float((xr + efr).abs().max()))
# error feedback (tests/test_distributed.py::test_compressed_psum_error_feedback)
xs = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
x = xs[me:me + 1]
exact = xs.mean(0)
ef = torch.zeros_like(x)
out, ef = compress.compressed_psum(x, mesh4, "pod", ef)
err1 = float((out[0] - exact).abs().max())
accum = torch.zeros(64)
for _ in range(20):
    out, ef = compress.compressed_psum(x, mesh4, "pod", ef)
    accum = accum + out[0]
record("psum/err1", err1)
record("psum/drift", float((accum / 20 - exact).abs().max()))
tree_out, _ = compress.compressed_psum_tree({"a": x, "b": 2 * x}, mesh4, "pod",
                                            compress.init_ef({"a": x, "b": x}))
record("psum/tree", rel(tree_out["b"], 2 * compress.compressed_psum(
    x, mesh4, "pod", torch.zeros_like(x))[0]))


# ------------------------------------------------------- train steps
def saved(ck_dir, step):
    with np.load(Path(ck_dir) / f"step_{step:08d}" / "arrays.npz") as a:
        return {k: a[k] for k in a.files}


def state_errs(state, want, mesh):
    arrays = ckpt._flatten(state, mesh)
    assert sorted(arrays) == sorted(want), sorted(set(arrays) ^ set(want))
    return max(rel(arrays[k].astype(np.float64), want[k].astype(np.float64)) for k in want)


opt = AdamWConfig(**OPT)
for arch in ("qwen3_14b", "qwen3_moe_235b_a22b"):
    cfg = reduced(get_config(arch))
    ck_jax = OUT / f"ck_{arch}_b4"
    for shape, mesh in meshes.items():
        tag = f"{arch}/{'x'.join(map(str, shape))}"
        for b in (4, 3):
            state = shard_state(init_train_state(cfg, 0, torch.float32, CPU), cfg, mesh)
            state, _ = ckpt.restore(state, str(ck_jax), 0, device=CPU, mesh=mesh)
            step = make_train_step(cfg, opt, device=CPU, mesh=mesh)
            if b == 4:
                batches = [{k: refs[f"train/{arch}_b4/batch{i}/{k}"] for k in ("tokens", "labels")}
                           for i in range(TRAIN_STEPS)]
                want = meta[f"train/{arch}_b4"]
            else:  # a batch that does not divide 'data': its rows are replicated
                batches = [token_batch(cfg, b, 16, PipelineState(seed=7, step=i))
                           for i in range(TRAIN_STEPS)]
                one = init_train_state(cfg, 0, torch.float32, CPU)
                one, _ = ckpt.restore(one, str(ck_jax), 0, device=CPU)
                one_step = make_train_step(cfg, opt, device=CPU)
                want = {"loss": [], "grad_norm": []}
                for bt in batches:
                    one, mt = one_step(one, bt)
                    want["loss"].append(float(mt["loss"]))
                    want["grad_norm"].append(float(mt["grad_norm"]))
            got = {"loss": [], "grad_norm": []}
            for bt in batches:
                state, mt = step(state, bt)
                got["loss"].append(float(mt["loss"]))
                got["grad_norm"].append(float(mt["grad_norm"]))
            for k in ("loss", "grad_norm"):
                record(f"train/{tag}/b{b}/{k}", rel(torch.tensor(got[k]), torch.tensor(want[k])))
            final = saved(ck_jax, TRAIN_STEPS) if b == 4 else ckpt._flatten(one)
            record(f"train/{tag}/b{b}/state", state_errs(state, final, mesh))
            if b == 4:
                ckpt.save(state, str(OUT / f"port_ck_{arch}_{'x'.join(map(str, shape))}"),
                          TRAIN_STEPS, mesh=mesh)

# ------------------------------------------------- elastic restore
cfg = reduced(get_config("qwen3_moe_235b_a22b"))
ck_jax = OUT / "ck_qwen3_moe_235b_a22b_b4"
whole = saved(ck_jax, 0)
for label in ("storage", "param_specs"):
    base = init_train_state(cfg, 0, torch.float32, CPU)
    specs = None if label == "storage" else param_specs(base.params, cfg, mesh122)
    state = shard_state(base, cfg, mesh122, specs)
    state, _ = ckpt.restore(state, str(ck_jax), 0, device=CPU, mesh=mesh122, specs=specs)
    dts = ckpt.as_dtensors(state, mesh122, specs)
    block_err = full_err = 0
    n_sharded = 0
    spec_of = ckpt._specs(state, mesh122, specs)
    for part, prefix in ckpt._PARTS:
        for name, dt in dts[part].items():
            path, idx = api.jax_path(cfg, name)
            a = whole[ckpt._key(prefix, path)]
            a = torch.from_numpy(a if idx is None else a[idx])
            block_err += int(not torch.equal(dt.to_local(), local_block(a, spec_of[name], mesh122)))
            full_err += int(not torch.equal(dt.full_tensor(), a))
            n_sharded += int(tuple(dt.to_local().shape) != tuple(a.shape))
    record(f"restore/{label}/blocks_unequal", block_err)
    record(f"restore/{label}/full_unequal", full_err)
    results[f"restore/{label}/sharded_leaves"] = n_sharded

# ------------------------------------------ activation_constraint
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

from repro_torch.models.transformer import activation_constraint  # noqa: E402

act = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
record("act/plain_unchanged", int(activation_constraint(act, mesh122) is not act))
for sp, spec in (("1", (("pod", "data"), "model", None)), ("0", (("pod", "data"), None, None))):
    os.environ["REPRO_ACT_SP"] = sp
    try:
        out = activation_constraint(DTensor.from_local(act, mesh122, [Replicate()] * 3,
                                                       run_check=False), mesh122)
    finally:
        os.environ.pop("REPRO_ACT_SP")
    record(f"act/sp{sp}/block_unequal",
           int(not torch.equal(out.to_local(), local_block(act, spec, mesh122))))
    record(f"act/sp{sp}/full_unequal", int(not torch.equal(out.full_tensor(), act)))

if collectives.rank() == 0:
    (OUT / "port.json").write_text(json.dumps(results, indent=1))
collectives.finish()
