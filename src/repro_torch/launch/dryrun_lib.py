"""Dry-run core (the port's twin of repro/launch/dryrun_lib.py): cost
every (arch x shape x mesh) cell of the LM configs on the production
meshes without a device.

A cell joins a fake process group of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks in this process, as rank 0, and builds the production mesh over
it on the meta device (`launch.mesh`). Its inputs are meta tensors
(`launch.specs`) cut to rank 0's share as the port's step factories
keep it on a mesh:

* train: the state as `train.step.shard_state` leaves it (expert slices
  by `sharding.storage_specs`, every other weight whole) and the global
  batch, of which the step takes its rows;
* prefill and decode: the weights in the same layout, the batch cut by
  `sharding.batch_specs` / `local_block`, and a cache for those rows
  over the whole sequence (the port's steps read no cache cut by
  length, which JAX's `cache_specs` asks for decode).
  A long_decode cell runs the sharded CSR window attention
  (``REPRO_LONG_ATTN=sharded``, the port's context-parallel decode):
  every row on every rank, each attention layer's k/v cut to the rank's
  slice of the sequence over ('data', 'model') as `launch.serve`'s
  demo-lm keeps it.

Then it runs the port's own step factory once under
`launch.op_costs.CostMode`: rank 0's program stands for every rank, as
the SPMD per-device module does in JAX. Collectives go to the fake
group, which returns at once. There is nothing to compile: ``pass_s``
is the time of the pass.

``memory`` holds the argument bytes (the rank's state, batch and
cache), the output bytes and the temp bytes (the peak of the live bytes
the step allocates, tracked per storage). Per-rank state that does not
fit one H100 is not a failure: the cell is ``ok`` with its bytes, and
``fits_one_h100`` says so.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_costs
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch.serve import _keep_seq_slice
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
    shard_state,
)

LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]
H100_BYTES = 79.65 * 2**30  # the memory one H100 80GB HBM3 reports
_MESHES: Dict[bool, Any] = {}


def join_fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (leaving any other group first): its collectives return at once."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake world of its size, on meta."""
    n = 1
    for size in production_shape(multi_pod).values():
        n *= size
    join_fake_world(n)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod, device="meta")
    return _MESHES[multi_pod]


def _rank_batch(batch: Dict, cfg, mesh) -> Dict:
    specs = shd.batch_specs(batch, cfg, mesh)
    return {k: shd.local_block(v, specs[k], mesh).clone() for k, v in batch.items()}


def _rank_model(cfg, mesh):
    model = sp.params_specs(cfg)
    shd.localize(model, shd.storage_specs(model, cfg, mesh), mesh)
    return model


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """(step, args, argument bytes, meta) of one cell: ``step(*args)`` is
    rank 0's step on its share of the meta inputs (nothing is lowered:
    the step runs eagerly under the cost pass)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    seq_split = False
    if shape.kind == "train":
        state = shard_state(sp.state_specs(cfg), cfg, mesh)
        batch = sp.train_batch_specs(cfg, shape)  # global: the step takes its rows
        step = make_train_step(cfg, AdamWConfig(), device="meta", mesh=mesh)
        args = (state, batch)
        arg_bytes = op_costs.tensor_bytes((list(state.params.parameters()), state.step,
                                           state.opt)) + \
            op_costs.tensor_bytes(_rank_batch(batch, cfg, mesh))
    else:
        model = _rank_model(cfg, mesh)
        seq_split = shape.kind == "long_decode" and cfg.family != "audio"
        if shape.kind == "prefill":
            batch = _rank_batch(sp.prefill_batch_specs(cfg, shape), cfg, mesh)
            step = make_prefill_step(cfg, device="meta", mesh=mesh)
        else:
            batch = {"tokens": sp.decode_token_specs(shape.global_batch)}
            if not seq_split:  # with the sequence split, every rank decodes every row
                batch = _rank_batch(batch, cfg, mesh)
            step = make_decode_step(cfg, long_ctx=shape.kind == "long_decode", device="meta",
                                    mesh=mesh)
        rows = batch["tokens"].shape[0]
        cache = sp.cache_specs_abstract(cfg, rows, shape.seq_len)
        if seq_split:
            cache = _keep_seq_slice(cache, mesh)
        inputs = batch if shape.kind == "prefill" else batch["tokens"]
        args = (model, inputs, cache)
        arg_bytes = op_costs.tensor_bytes((list(model.parameters()), inputs, cache))
    meta = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(dist.get_world_size()),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.active_params(),
        "tokens_per_step": shape.global_batch * (
            shape.seq_len if shape.kind in ("train", "prefill") else 1),
        "long_attn": "sharded" if seq_split else None,
    }
    return step, args, arg_bytes, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    t0 = time.time()
    try:
        step, args, arg_bytes, meta = lower_cell(arch, shape_name, multi_pod)
        env = {"REPRO_LONG_ATTN": "sharded"} if meta["long_attn"] else {}
        with _env(**env), op_costs.CostMode() as mode:
            out = step(*args)
        roof = rf.analyze(mode.costs)
        mem = {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(op_costs.storage_bytes(out)),
            "temp_size_in_bytes": int(mode.peak_bytes),
        }
        del out, args, step
        mf = rf.model_flops(meta["n_active_params"], meta["tokens_per_step"],
                            "train" if meta["kind"] == "train" else "serve")
        chips = meta["n_devices"]
        result = {
            **meta,
            "ok": True,
            "pass_s": round(time.time() - t0, 1),
            "n_ops": mode.n_ops,
            "roofline": roof.to_dict(),
            "memory": mem,
            "fits_one_h100": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            <= H100_BYTES,
            "model_flops_total": mf,
            "op_flops_total": roof.flops * chips,
            "useful_flops_ratio": (mf / (roof.flops * chips)) if roof.flops else None,
        }
    except Exception as e:
        result = {
            "arch": arch,
            "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "ok": False,
            "pass_s": round(time.time() - t0, 1),
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    finally:
        gc.collect()
    return result


def finish() -> None:
    """Leave the fake process group."""
    _MESHES.clear()
    collectives.finish()


def load_results(path: str) -> Dict[str, Dict]:
    p = Path(path)
    if p.exists():
        return json.loads(p.read_text())
    return {}


def save_results(path: str, results: Dict[str, Dict]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(results, indent=1, sort_keys=True))
    tmp.replace(p)


def cell_key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"
