"""The JAX package's references for tests/test_torch_distributed.py, built
in one process on 4 fake CPU devices (run as a script with the output
directory as its argument; XLA_FLAGS must force 4 host devices).

Writes ``refs.npz`` (inputs and outputs), ``refs.json`` (metrics and
shard maps) and one-device JAX checkpoints under ``ck_<case>/``."""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.checkpoint import ckpt
from repro.configs.base import get_config, reduced
from repro.data.synthetic import PipelineState, token_batch
from repro.models import attention as attn
from repro.models import moe
from repro.optim import compress
from repro.optim.adamw import AdamWConfig
from repro.train.step import init_train_state, make_train_step

OUT = Path(sys.argv[1])
AUTO = (jax.sharding.AxisType.Auto,)
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
TRAIN_STEPS = 3
TRAIN_BATCH = 4  # divides the 'data' axis (the port holds a batch that does not to its own run)
arrays, meta = {}, {}


def mesh_of(shape):
    return jax.make_mesh(shape, ("pod", "data", "model"), axis_types=AUTO * 3)


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        arrays[f"{prefix}/{key}"] = np.asarray(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                                               else leaf)


# ----------------------------------------------------------- EP MoE
def moe_case(name, arch, mesh_shape, cf, batch=4, seq=8, dtype=jnp.float32, overflow=False,
             compact=False):
    cfg = reduced(get_config(arch))
    params = moe.init_moe(jax.random.PRNGKey(0), cfg, dtype)
    x = np.random.default_rng(1).standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    if overflow:
        # every token prefers the experts of data rank 0: its buffer overflows
        u = np.ones(cfg.d_model, np.float32) / np.sqrt(cfg.d_model)
        x = x + 3.0 * u
        e_half = cfg.moe.n_experts // 2
        params["router"] = params["router"].at[:, :e_half].add(jnp.asarray(4.0 * u)[:, None])
    xj = jnp.asarray(x, dtype)
    if compact:
        os.environ["REPRO_MOE_COMPACT"] = "1"
    try:
        mesh = mesh_of(mesh_shape)
        out = jax.jit(lambda p, a: moe.moe_ffn_ep(p, a, cfg, mesh, capacity_factor=cf))(params, xj)
    finally:
        os.environ.pop("REPRO_MOE_COMPACT", None)
    put(f"moe/{name}/params", params)
    arrays[f"moe/{name}/x"] = np.asarray(xj.astype(jnp.float32))
    arrays[f"moe/{name}/out"] = np.asarray(out.astype(jnp.float32))
    meta[f"moe/{name}"] = {"arch": arch, "mesh": mesh_shape, "cf": cf,
                           "dtype": str(jnp.dtype(dtype)), "compact": compact}


moe_case("cf8", "qwen3_moe_235b_a22b", (1, 2, 2), 8.0)
moe_case("cf8_pod", "qwen3_moe_235b_a22b", (2, 2, 1), 8.0)
moe_case("overflow", "qwen3_moe_235b_a22b", (1, 2, 2), 1.25, overflow=True)
moe_case("compact_bf16", "qwen3_moe_235b_a22b", (1, 2, 2), 8.0, dtype=jnp.bfloat16,
         compact=True)
moe_case("deepseek", "deepseek_v2_lite_16b", (1, 2, 2), 8.0)

# ------------------------------------------------- sharded attention
ATTN_L = 128  # 4 shards of 32
acfg = reduced(get_config("qwen3_14b"))
aparams = attn.init_gqa(jax.random.PRNGKey(2), acfg)
put("attn/params", aparams)
rng = np.random.default_rng(3)
kv_shape = (2, ATTN_L, acfg.n_kv_heads, acfg.resolved_head_dim)
k0 = rng.standard_normal(kv_shape).astype(np.float32)
v0 = rng.standard_normal(kv_shape).astype(np.float32)
arrays["attn/k"], arrays["attn/v"] = k0, v0
amesh = mesh_of((1, 2, 2))
pos_list = [0, acfg.long_sinks - 1, acfg.long_window + acfg.long_sinks, 63, 64, 65]
meta["attn"] = {"pos": pos_list}
sharded_step = jax.jit(lambda p, a, positions, cache: attn.csr_window_attention_sharded(
    p, a, acfg, positions, cache, amesh))
for pos in pos_list:
    x = rng.standard_normal((2, 1, acfg.d_model)).astype(np.float32)
    positions = jnp.full((2, 1), pos, jnp.int32)
    cache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.asarray(pos, jnp.int32)}
    out, new = sharded_step(aparams, jnp.asarray(x), positions, cache)
    arrays[f"attn/{pos}/x"] = x
    arrays[f"attn/{pos}/out"] = np.asarray(out)
    arrays[f"attn/{pos}/k_after"] = np.asarray(new["k"])
    arrays[f"attn/{pos}/v_after"] = np.asarray(new["v"])

# -------------------------------------------------- compressed psum
pmesh = jax.make_mesh((4,), ("pod",), axis_types=AUTO)
xc = np.random.default_rng(4).standard_normal((4, 64)).astype(np.float32)
efc = (0.01 * np.random.default_rng(5).standard_normal((4, 64))).astype(np.float32)
out, new_ef = jax.jit(jax.shard_map(
    lambda a, e: compress.compressed_psum(a, "pod", e), mesh=pmesh,
    in_specs=(P("pod", None), P("pod", None)), out_specs=(P("pod", None), P("pod", None)),
    check_vma=False))(jnp.asarray(xc), jnp.asarray(efc))
arrays["psum/x"], arrays["psum/ef"] = xc, efc
arrays["psum/out"], arrays["psum/new_ef"] = np.asarray(out), np.asarray(new_ef)
for r in range(4):  # each rank's quantization, on its own row
    q, scale = compress._quant(jnp.asarray(xc[r:r + 1]) + jnp.asarray(efc[r:r + 1]))
    arrays[f"psum/q/{r}"] = np.asarray(q)
    arrays[f"psum/deq/{r}"] = np.asarray(q.astype(jnp.float32) * scale)

# ------------------------------------------------------- train steps
for arch in ("qwen3_14b", "qwen3_moe_235b_a22b"):
    cfg = reduced(get_config(arch))
    step_fn = jax.jit(make_train_step(cfg, AdamWConfig(**OPT)))
    for b in (TRAIN_BATCH,):
        case = f"{arch}_b{b}"
        state = init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32)
        ckpt.save(state, str(OUT / f"ck_{case}"), 0)
        losses, gnorms = [], []
        for i in range(TRAIN_STEPS):
            batch = token_batch(cfg, b, 16, PipelineState(seed=7, step=i))
            for k, v in batch.items():
                arrays[f"train/{case}/batch{i}/{k}"] = v
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
        ckpt.save(state, str(OUT / f"ck_{case}"), TRAIN_STEPS)
        meta[f"train/{case}"] = {"arch": arch, "batch": b, "loss": losses, "grad_norm": gnorms}

# ------------------------------------------------------- shard maps
smesh = mesh_of((1, 2, 2))
maps = []
for spec, shape in (((None, ("data", "model"), None, None), (2, 8, 3, 2)),
                    (("data", "model"), (4, 6)), (("model", "data"), (4, 6)),
                    (("data", None, "model"), (4, 3, 2)), ((("pod", "data"), None), (4, 2))):
    index = NamedSharding(smesh, P(*spec)).devices_indices_map(shape)
    shards = []
    for dev, idx in index.items():
        coords = [int(c) for c in np.argwhere(smesh.devices == dev)[0]]
        shards.append({"coords": dict(zip(smesh.axis_names, coords)),
                       "index": [[s.start or 0, shape[d] if s.stop is None else s.stop]
                                 for d, s in enumerate(idx)]})
    maps.append({"spec": [list(e) if isinstance(e, tuple) else e for e in spec],
                 "shape": shape, "shards": shards})
meta["shard_maps"] = maps

np.savez(OUT / "refs.npz", **arrays)
(OUT / "refs.json").write_text(json.dumps(meta))
print("OK")
