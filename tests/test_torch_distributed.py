"""The port's multi-device paths against the JAX package on the CPU.

One module fixture runs, each process under `nice` with its own timeout:
1. tests/torch_dist_jax_refs.py: the JAX references on 4 fake devices
   (EP MoE, sharded CSR window attention, the int8 error-feedback psum,
   one-device train steps and checkpoints, device shard maps);
2. tests/torch_dist_worker.py on 4 gloo ranks (torch.distributed.run):
   every port case, its errors reduced over the ranks;
3. the launchers under torch.distributed.run: launch.train crashing on
   4 ranks and resuming on 2, and demo-lm on 2 ranks, each against a
   one-rank run.
The tests read what those wrote. Tolerances (relative to max |ref|):
outputs 1e-4 (bf16 2e-2), gradients 1e-3, the compressed psum 1e-6
with its int8 values bit-equal, train steps 1e-4, restores bit-equal.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.train.step import init_train_state as jax_init_train_state
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import local_block
from repro_torch.launch import serve, train

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TESTS = Path(__file__).resolve().parent
TIMEOUT_S = 300
OUT_TOL, BF16_TOL, GRAD_TOL, PSUM_TOL, STEP_TOL = 1e-4, 2e-2, 1e-3, 1e-6, 1e-4
MOE_CASES = ("cf8", "cf8_pod", "overflow", "compact_bf16", "deepseek")
ATTN_POS = (0, 7, 72, 63, 64, 65)  # 0, sinks - 1, window + sinks, a shard boundary +- 1
SINKS = 8  # reduced() long_sinks
TRAIN_ARGS = ["--device", "cpu", "--arch", "qwen3_moe_235b_a22b", "--reduced", "--steps", "6",
              "--batch", "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]
DEMO_RUNS = {  # name: (demo-lm arguments, environment)
    "sharded_long_ctx": (["--arch", "qwen3_14b", "--long-ctx", "--gen", "8"],
                         {"REPRO_LONG_ATTN": "sharded"}),
    "moe_rows": (["--arch", "qwen3_moe_235b_a22b", "--gen", "8"], {"REPRO_MOE_CF": "8"}),
}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return {**env, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", **extra}


def _run(cmd, **env):
    return subprocess.run(["nice", "-n", "10", *cmd], capture_output=True, text=True,
                          env=_env(**env), timeout=TIMEOUT_S, cwd=TESTS)


def _torchrun(n, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", *args]


def _one_rank(main, argv, **env):
    """``main(argv)`` in this process with ``env`` set: (rc, stdout)."""
    buf = io.StringIO()
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    r = _run([sys.executable, str(TESTS / "torch_dist_jax_refs.py"), str(out)],
             JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    r = _run(_torchrun(4, str(TESTS / "torch_dist_worker.py"), str(out)), REPRO_MOE_CF="8")
    assert r.returncode == 0, r.stderr[-3000:]
    port = json.loads((out / "port.json").read_text())

    ck = out / "train_ck"
    crash = _run(_torchrun(4, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
                           "--ckpt-dir", str(ck), "--crash-at", "3"), REPRO_MOE_CF="8")
    resume = _run(_torchrun(2, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
                            "--ckpt-dir", str(ck)), REPRO_MOE_CF="8")
    ref_ck = out / "train_ref"
    one = _one_rank(train.main, TRAIN_ARGS + ["--ckpt-dir", str(ref_ck)], REPRO_MOE_CF="8")
    demos = {}
    for name, (args, env) in DEMO_RUNS.items():
        argv = ["demo-lm", "--device", "cpu", "--reduced", *args]
        demos[name] = (_run(_torchrun(2, "-m", "repro_torch.launch.serve", *argv), **env),
                       _one_rank(serve.main, argv, **env))
    return {"out": out, "port": port, "crash": crash, "resume": resume, "one": one,
            "ck": ck, "ref_ck": ref_ck, "demos": demos,
            "meta": json.loads((out / "refs.json").read_text())}


# ------------------------------------------------------------ EP MoE
@pytest.mark.parametrize("case", MOE_CASES)
def test_ep_moe_forward_matches_jax(runs, case):
    """moe_ffn_ep on 4 ranks against JAX's moe_ffn_ep on the same mesh
    ((1, 2, 2); cf8_pod: (2, 2, 1)): capacity 8, 1.25 with an overflowing
    destination, REPRO_MOE_COMPACT=1 in bf16, deepseek's shared expert."""
    tol = BF16_TOL if case == "compact_bf16" else OUT_TOL
    assert runs["port"][f"moe/{case}/err"] <= tol


def test_overflowing_destination_loses_its_last_kept_slot(runs):
    """The overflow case drops copies, and in the overflowing buffer the
    kept copy sorted into slot cap - 1 gets nothing back (JAX's CPU
    scatter lets the last, dropped, write win); the output still equals
    JAX's (test above), so the port reproduces it."""
    assert runs["port"]["moe/overflow/dropped"] > 0
    assert runs["port"]["moe/overflow/kept_but_lost"] > 0
    assert runs["port"]["moe/overflow/err"] <= OUT_TOL


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
@pytest.mark.parametrize("leaf", ["x", "w_gate", "w_up", "w_down", "router"])
def test_ep_moe_gradients_match_one_device(runs, mesh, leaf):
    """Gradients of sum(out * r) through moe_ffn_ep against the port's
    one-device moe_ffn_ref: x on each rank's rows, each expert slice
    (summed over the pods that hold it), the router summed over the
    batch axes. On (1, 2, 2) the slices are halves of 'model': a psum
    whose backward summed would double them."""
    assert runs["port"][f"moe_grad/{mesh}/{leaf}"] <= GRAD_TOL


# ------------------------------------------------- sharded attention
@pytest.mark.parametrize("pos", ATTN_POS)
def test_sharded_attention_matches_jax(runs, pos):
    """csr_window_attention_sharded on (1, 2, 2) against JAX's: the output
    and every rank's cache slice after the write."""
    p = runs["port"]
    assert p[f"attn/{pos}/out"] <= OUT_TOL
    assert p[f"attn/{pos}/k"] <= OUT_TOL and p[f"attn/{pos}/v"] <= OUT_TOL
    assert p[f"attn/{pos}/new_pos"] == 0


@pytest.mark.parametrize("pos", ATTN_POS)
def test_sharded_attention_writes_only_the_owning_shard(runs, pos):
    assert runs["port"][f"attn/{pos}/rows_written_elsewhere"] == 0
    assert runs["port"][f"attn/{pos}/owner_wrote"] == 1


@pytest.mark.parametrize("pos", [p for p in ATTN_POS if p >= SINKS])
def test_sharded_attention_matches_the_naive_band_past_the_sinks(runs, pos):
    """Where pos >= long_sinks the two bands agree (below it the naive
    path keeps sinks beyond pos, the sharded one masks them)."""
    assert runs["port"][f"attn/{pos}/vs_naive"] <= OUT_TOL


# --------------------------------------------------- compressed psum
def test_compressed_psum_quantizes_bit_equal_to_jax(runs):
    assert runs["port"]["psum/q_mismatch"] == 0
    assert runs["port"]["psum/deq_mismatch"] == 0


def test_compressed_psum_matches_jax(runs):
    assert runs["port"]["psum/out"] <= PSUM_TOL
    assert runs["port"]["psum/new_ef"] <= PSUM_TOL  # relative to max |x + ef|
    assert runs["port"]["psum/tree"] == 0


def test_compressed_psum_error_feedback(runs):
    """tests/test_distributed.py::test_compressed_psum_error_feedback's
    inequalities on 4 ranks over 'pod'."""
    err1, drift = runs["port"]["psum/err1"], runs["port"]["psum/drift"]
    assert err1 < 0.05
    assert drift < err1 / 2 + 1e-6


# ------------------------------------------------------- train steps
@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "qwen3_moe_235b_a22b"])
def test_train_steps_on_a_mesh_match_jax(runs, arch, mesh):
    """3 steps of make_train_step(mesh=) from JAX's initial checkpoint on
    JAX's batches (4 rows) against JAX's one-device steps: losses, grad
    norms, and every weight, moment and count after them."""
    for k in ("loss", "grad_norm", "state"):
        assert runs["port"][f"train/{arch}/{mesh}/b4/{k}"] <= STEP_TOL, k


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "qwen3_moe_235b_a22b"])
def test_train_steps_with_replicated_rows_match_one_device(runs, arch, mesh):
    """A batch of 3 rows does not divide 'data', so every data rank holds
    all of them (JAX replicates it): the mesh steps equal the port's
    one-device steps."""
    for k in ("loss", "grad_norm", "state"):
        assert runs["port"][f"train/{arch}/{mesh}/b3/{k}"] <= STEP_TOL, k


# --------------------------------------------------- elastic restore
@pytest.mark.parametrize("specs", ["storage", "param_specs"])
def test_jax_checkpoint_restores_onto_a_mesh(runs, specs):
    """JAX's one-device checkpoint onto (1, 2, 2) by the steps' layout
    and by the full param_specs rules: every local block is its slice of
    the saved array bit for bit, and the DTensors' full_tensor() the
    whole array."""
    p = runs["port"]
    assert p[f"restore/{specs}/blocks_unequal"] == 0
    assert p[f"restore/{specs}/full_unequal"] == 0
    assert p[f"restore/{specs}/sharded_leaves"] > 0


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2x1"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "qwen3_moe_235b_a22b"])
def test_port_mesh_checkpoint_restores_in_jax(runs, arch, mesh):
    """The 4-rank port checkpoint after 3 steps through the JAX package's
    restore: every leaf within STEP_TOL of JAX's own 3-step state."""
    cfg = jax_reduced(jax_get_config(arch))
    template = jax.eval_shape(
        lambda: jax_init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32))
    got, _ = jckpt.restore(template, str(runs["out"] / f"port_ck_{arch}_{mesh}"))
    want, _ = jckpt.restore(template, str(runs["out"] / f"ck_{arch}_b4"), step=3)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= STEP_TOL * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("sp", ["1", "0"])
def test_activation_constraint_is_a_layout_only(runs, sp):
    """A plain per-rank tensor comes back as it is; a replicated DTensor
    (4, 8, 6) on (1, 2, 2) is redistributed to rows over ('pod',
    'data') and, unless REPRO_ACT_SP=0, the sequence over 'model', its
    values unchanged."""
    p = runs["port"]
    assert p["act/plain_unchanged"] == 0
    assert p[f"act/sp{sp}/block_unequal"] == 0 and p[f"act/sp{sp}/full_unequal"] == 0


def test_local_blocks_are_the_jax_device_shards(runs):
    """local_block at each device's mesh coordinates is the index JAX's
    NamedSharding gives that device, for the context-parallel
    ('data', 'model') entry and others."""
    class FakeMesh:
        shape = {"pod": 1, "data": 2, "model": 2}

    for m in runs["meta"]["shard_maps"]:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in m["spec"])
        t = np.arange(int(np.prod(m["shape"]))).reshape(m["shape"])
        for shard in m["shards"]:
            want = t[tuple(slice(a, b) for a, b in shard["index"])]
            np.testing.assert_array_equal(local_block(t, spec, FakeMesh(), shard["coords"]), want)


# ---------------------------------------------------------- launchers
def test_train_launcher_crashes_on_4_ranks_and_resumes_on_2(runs):
    """launch.train under torch.distributed.run: a crash at step 3 on 4
    ranks (step 2 committed), a resume on 2, and the final checkpoint
    within STEP_TOL of an uninterrupted one-rank run's."""
    from repro_torch.checkpoint import ckpt

    crash, resume, (rc, one_out) = runs["crash"], runs["resume"], runs["one"]
    assert "[train] simulating crash at step 3" in crash.stdout, crash.stderr[-3000:]
    assert crash.returncode != 0
    assert "[dist] backend gloo: 4 ranks on cpu" in crash.stdout
    assert resume.returncode == 0, resume.stderr[-3000:]
    assert "[train] resumed from step 2" in resume.stdout
    assert "[dist] backend gloo: 2 ranks on cpu" in resume.stdout
    assert rc == 0 and ckpt.latest_step(str(runs["ck"])) == 6
    with np.load(runs["ck"] / "step_00000006" / "arrays.npz") as a, \
            np.load(runs["ref_ck"] / "step_00000006" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            assert np.abs(x - y).max() <= STEP_TOL * max(np.abs(y).max(), 1e-30), k
    last = [ln for ln in resume.stdout.splitlines() if ln.startswith("[train] step=5 ")]
    want = [ln for ln in one_out.splitlines() if ln.startswith("[train] step=5 ")]
    loss = lambda ln: float(re.search(r"loss=(\S+)", ln).group(1))  # noqa: E731
    assert len(last) == 1 and abs(loss(last[0]) - loss(want[0])) <= 1e-4 + 1e-9


@pytest.mark.parametrize("name", list(DEMO_RUNS))
def test_demo_lm_on_2_ranks_matches_one_rank(runs, name):
    """demo-lm under torch.distributed.run on 2 ranks (rows split, or
    with REPRO_LONG_ATTN=sharded every rank on its slice of the cache's
    sequence): rank 0 prints the one-rank run's greedy tokens."""
    proc, (rc, one_out) = runs["demos"][name]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rc == 0
    tokens = [ln for ln in proc.stdout.splitlines() if "sample generations" in ln]
    want = [ln for ln in one_out.splitlines() if "sample generations" in ln]
    assert len(tokens) == 1 and tokens == want


def test_backend_follows_the_topology(monkeypatch):
    """nccl only where every local rank has a card of its own; no retry
    on another backend (init raises what init_process_group raises)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert collectives.backend_for(torch.device("cpu")) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert collectives.backend_for(torch.device("cuda", 0)) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert collectives.backend_for(torch.device("cuda", 0)) == "nccl"


def test_rank_device_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert collectives.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.rank_device()
