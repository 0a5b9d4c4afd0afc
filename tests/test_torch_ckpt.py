"""LLM training around the step in repro_torch: synthetic data and the
prefetcher, checkpoints on the JAX package's on-disk layout, and the
training launcher (`repro_torch.launch.train`), on the CPU.

Twins of tests/test_train_ckpt.py, plus checkpoints that cross packages:
a JAX-written TrainState restores in the port and a port-written one in
the JAX package, with equal leaves and next steps within RTOL = 1e-4 of
max |ref| per leaf (fp32 sums in another order). Shapes: `reduced()`
configs, B = 2, S = 32; the launcher runs in-process on the CPU.
"""
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ARCH_IDS, get_config, reduced
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tconfigs
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import PipelineState, batches, token_batch
from repro_torch.launch import train
from repro_torch.models import api as tapi
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep

torch.set_num_threads(1)
RTOL = 1e-4
CPU = "cpu"
LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]
B, S = 2, 32
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)


def _tcfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


def _close(name, got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-30), f"{name}: max err {err:.3e}, max |ref| {scale:.3e}"


def _leaves_equal(a, b):
    """Two states in JAX's layout hold equal leaves (a's keys are b's)."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for (path, x), y in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


def _state_np(state):
    """A JAX TrainState's leaves as numpy (layout kept)."""
    return jax.tree.map(np.asarray, state)


def _port_state(arch, seed=0, dtype=torch.float32):
    return tstep.init_train_state(_tcfg(arch), seed, dtype, device=CPU)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_token_batch_equals_jax_bit_for_bit(arch):
    """Every family's batch (vlm patch labels of -1, audio frames, ...)
    from the same (seed, step)."""
    cfg, tcfg = reduced(get_config(arch)), _tcfg(arch)
    for seed, step in ((0, 0), (7, 3)):
        want = jsynthetic.token_batch(cfg, B, S, jsynthetic.PipelineState(seed, step))
        got = token_batch(tcfg, B, S, PipelineState(seed, step))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if cfg.family == "vlm":
        assert (got["labels"][:, :cfg.vlm_patches] == -1).all()


def test_batches_iterator_equals_jax():
    cfg, tcfg = reduced(get_config("internvl2_1b")), _tcfg("internvl2_1b")
    it, jit_ = batches(tcfg, B, S, seed=3, start_step=2), jsynthetic.batches(cfg, B, S, 3, 2)
    for _ in range(3):
        got, want = next(it), next(jit_)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_matches_sequential():
    """Twin of test_train_ckpt.py's: the double-buffered prefetcher yields
    exactly the (step, batch) sequence of sequential generation, from any
    resume point, as JAX's prefetcher does."""
    tcfg, cfg = _tcfg("qwen3_14b"), reduced(get_config("qwen3_14b"))

    def make(s):
        return token_batch(tcfg, 2, 16, PipelineState(7, s))

    pf = Prefetcher(make, start_step=3, depth=2)
    jpf = jpipeline.Prefetcher(
        lambda s: jsynthetic.token_batch(cfg, 2, 16, jsynthetic.PipelineState(7, s)),
        start_step=3, depth=2)
    try:
        for expect_step in range(3, 8):
            step, batch = next(pf)
            jstep_, jbatch = next(jpf)
            assert step == jstep_ == expect_step
            np.testing.assert_array_equal(batch["tokens"], make(expect_step)["tokens"])
            np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
    finally:
        pf.close()
        jpf.close()


# ------------------------------------------------------------- training
def test_loss_decreases_tiny_lm():
    """Twin of test_train_ckpt.py's (same optimizer, steps and bar)."""
    tcfg = _tcfg("qwen3_14b")
    state = tstep.init_train_state(tcfg, 0, torch.float32, device=CPU)
    step = tstep.make_train_step(tcfg, AdamWConfig(lr=3e-3, total_steps=70, warmup_steps=5),
                                 device=CPU)
    pipe = PipelineState(0, 0)
    losses = []
    for _ in range(60):
        state, m = step(state, token_batch(tcfg, B, S, pipe))
        pipe.step += 1
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert int(state.step) == int(state.opt.count) == 60


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """Twin of test_train_ckpt.py's: save, then restore into another state
    (other weights, zero moments): every leaf equal, the extra back."""
    tcfg = _tcfg("internlm2_20b")
    state = _port_state("internlm2_20b", 0, dtype)
    step = tstep.make_train_step(tcfg, AdamWConfig(**OPT), device=CPU)
    state, _ = step(state, token_batch(tcfg, B, S, PipelineState(0, 0)))
    d = ckpt.save(state, str(tmp_path), 7, extra={"pipeline": {"seed": 0, "step": 7}})
    assert (Path(d) / "COMMITTED").exists()
    other = _port_state("internlm2_20b", 1, dtype)
    restored, extra = ckpt.restore(other, str(tmp_path), device=CPU)
    assert extra["pipeline"]["step"] == 7
    assert int(restored.step) == int(restored.opt.count) == 1
    assert restored.params is other.params  # loaded in place
    for (n, a), b in zip(state.params.named_parameters(), restored.params.parameters()):
        assert b.dtype == dtype and torch.equal(a, b), n
    for part in ("m", "v"):
        for n, a in getattr(state.opt, part).items():
            assert torch.equal(a, getattr(restored.opt, part)[n]), (part, n)


def test_checkpoint_latest_and_prune(tmp_path):
    """Twin of test_train_ckpt.py's."""
    state = _port_state("mamba2_2_7b")
    for s in (5, 10, 15, 20):
        ckpt.save(state, str(tmp_path), s)
    assert ckpt.latest_step(str(tmp_path)) == 20
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 20
    kept = sorted(p.name for p in Path(tmp_path).iterdir() if p.name.startswith("step_"))
    assert kept == ["step_00000015", "step_00000020"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, str(tmp_path / "none"), device=CPU)


def test_uncommitted_checkpoint_ignored(tmp_path):
    """Twin of test_train_ckpt.py's: a partial write has no COMMITTED."""
    state = _port_state("mamba2_2_7b")
    ckpt.save(state, str(tmp_path), 5)
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 5
    _, extra = ckpt.restore(_port_state("mamba2_2_7b", 1), str(tmp_path), device=CPU)
    assert extra == {}
    assert not any(p.name.startswith(".tmp_") for p in tmp_path.iterdir())


_LAYER_KEY = {  # one stacked (or head) layer leaf per layout
    "qwen3_14b": ".params/tail_blocks/attn/wq",
    "recurrentgemma_2b": ".params/tail_blocks/sub_0/mixer/w_x",
    "deepseek_v2_lite_16b": ".params/head_blocks/0/attn/wq",
    "whisper_small": ".params/dec_layers/self_attn/wq",
}


@pytest.mark.parametrize("arch", list(_LAYER_KEY))
def test_checkpoint_layout_equals_jax(tmp_path, arch):
    """The same keys (`.step`, `.params/embed`, stacked
    `.params/tail_blocks/...`, hybrid `sub_i`, `head_blocks/0`,
    `.opt/.count`, `.opt/.m/...`), shapes and dtypes as the JAX
    package's save of the same config."""
    cfg = reduced(get_config(arch))
    jstate = jstep.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32)
    jckpt.save(jstate, str(tmp_path / "jax"), 1)
    ckpt.save(_port_state(arch), str(tmp_path / "port"), 1)
    man = {k: json.loads((tmp_path / k / "step_00000001" / "manifest.json").read_text())
           for k in ("jax", "port")}
    for field in ("keys", "shapes", "dtypes"):
        assert man["port"][field] == man["jax"][field], field
    assert {".step", ".opt/.count", ".opt/.m/embed", ".opt/.v/embed", _LAYER_KEY[arch]} <= set(
        man["port"]["keys"])


def _jax_step_fn(cfg):
    return jax.jit(jstep.make_train_step(cfg, jadamw.AdamWConfig(**OPT)))


def _jax_state_from_port(tcfg, state):
    s = tapi.train_state_to_numpy(tcfg, state)
    j = jax.tree.map(jnp.asarray, s)
    return jstep.TrainState(j.step, j.params, jadamw.OptState(j.opt.count, j.opt.m, j.opt.v))


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b", "deepseek_v2_lite_16b",
                                  "whisper_small"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    """JAX trains a step and saves; the port restores it (every leaf equal)
    and both take the next step alike."""
    cfg, tcfg = reduced(get_config(arch)), _tcfg(arch)
    jf = _jax_step_fn(cfg)
    b0, b1 = (token_batch(tcfg, B, S, PipelineState(0, s)) for s in range(2))
    jstate, _ = jf(jstep.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32),
                   jax.tree.map(jnp.asarray, b0))
    jckpt.save(jstate, str(tmp_path), 1, extra={"pipeline": {"seed": 0, "step": 1}})
    state, extra = ckpt.restore(_port_state(arch, 5), str(tmp_path), device=CPU)
    assert extra["pipeline"] == {"seed": 0, "step": 1}
    _leaves_equal(tapi.train_state_to_numpy(tcfg, state), _state_np(jstate))
    state, m = tstep.make_train_step(tcfg, AdamWConfig(**OPT), device=CPU)(state, b1)
    jstate, jm = jf(jstate, jax.tree.map(jnp.asarray, b1))
    _close("loss", m["loss"], jm["loss"])
    got, want = tapi.train_state_to_numpy(tcfg, state), _state_np(jstate)
    for part, g, w in (("params", got.params, want.params), ("m", got.opt.m, want.opt.m)):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(g)[0], jax.tree.leaves(w)):
            _close(f"{part} {jax.tree_util.keystr(path)}", a, b)


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b", "deepseek_v2_lite_16b",
                                  "whisper_small"])
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    """The port trains a step and saves; the JAX package restores it into
    its own template (every leaf equal) and both take the next step alike."""
    cfg, tcfg = reduced(get_config(arch)), _tcfg(arch)
    b0, b1 = (token_batch(tcfg, B, S, PipelineState(0, s)) for s in range(2))
    tf = tstep.make_train_step(tcfg, AdamWConfig(**OPT), device=CPU)
    state, _ = tf(_port_state(arch), b0)
    ckpt.save(state, str(tmp_path), 1, extra={"pipeline": {"seed": 0, "step": 1}})
    template = jax.eval_shape(lambda: jstep.init_train_state(cfg, jax.random.PRNGKey(0),
                                                             jnp.float32))
    jstate, extra = jckpt.restore(template, str(tmp_path))
    assert extra["pipeline"]["step"] == 1
    _leaves_equal(tapi.train_state_to_numpy(tcfg, state), _state_np(jstate))
    jstate, jm = _jax_step_fn(cfg)(jax.tree.map(jnp.asarray, jstate),
                                   jax.tree.map(jnp.asarray, b1))
    state, m = tf(state, b1)
    _close("loss", m["loss"], jm["loss"])
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(tapi.train_state_to_numpy(tcfg, state).params)[0],
            jax.tree.leaves(_state_np(jstate.params))):
        _close(jax.tree_util.keystr(path), a, b)


def test_port_restores_a_jax_bf16_checkpoint(tmp_path):
    """JAX writes bf16 leaves as their 2-byte patterns (numpy V2); the port
    reads them back bit for bit and writes them the same way."""
    cfg, tcfg = reduced(get_config("qwen3_14b")), _tcfg("qwen3_14b")
    jstate = jstep.init_train_state(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    jckpt.save(jstate, str(tmp_path / "jax"), 3)
    state, _ = ckpt.restore(_port_state("qwen3_14b", 1, torch.bfloat16), str(tmp_path / "jax"),
                            device=CPU)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate)
    _leaves_equal(tapi.train_state_to_numpy(tcfg, state), want)
    ckpt.save(state, str(tmp_path / "port"), 3)
    with np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as p, \
            np.load(tmp_path / "jax" / "step_00000003" / "arrays.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].tobytes() == j[k].tobytes(), k


def test_restore_checks_device_and_shapes(tmp_path, monkeypatch):
    ckpt.save(_port_state("qwen3_14b"), str(tmp_path), 1)
    narrower = dataclasses.replace(_tcfg("qwen3_14b"), d_ff=96)
    with pytest.raises(ValueError, match="ffn/w_gate: shape"):
        ckpt.restore(tstep.init_train_state(narrower, 0, torch.float32, device=CPU),
                     str(tmp_path), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(_port_state("qwen3_14b"), str(tmp_path))


# -------------------------------------------------------------- launcher
def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    return rc, out.getvalue()


def test_crash_and_resume_launcher(tmp_path):
    """Twin of test_train_ckpt.py's, in-process: the launcher crashes at step
    25 (exit code 17, step 20 committed), resumes from it, and ends with
    the weights an uninterrupted run ends with."""
    args = ["--arch", "qwen3_14b", "--reduced", "--steps", "30", "--batch", "2", "--seq", "32",
            "--ckpt-every", "10", "--log-every", "50", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    rc, out = _main(args + ["--ckpt-dir", ck, "--crash-at", "25"])
    assert rc == 17 and "simulating crash at step 25" in out
    assert ckpt.latest_step(ck) == 20
    rc, out = _main(args + ["--ckpt-dir", ck])
    assert rc == 0, out
    assert "[train] resumed from step 20" in out and "[train] done: 30 steps" in out
    assert ckpt.latest_step(ck) == 30
    kept = sorted(p.name for p in Path(ck).iterdir() if p.name.startswith("step_"))
    assert kept == ["step_00000010", "step_00000020", "step_00000030"]
    ref = str(tmp_path / "ref")
    assert _main(args + ["--ckpt-dir", ref])[0] == 0
    with np.load(Path(ck) / "step_00000030" / "arrays.npz") as a, \
            np.load(Path(ref) / "step_00000030" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    man = json.loads((Path(ck) / "step_00000030" / "manifest.json").read_text())
    assert man["extra"]["pipeline"] == {"seed": 0, "step": 30}


def test_launcher_logs_as_jax_does():
    rc, out = _main(["--arch", "mamba2_2_7b", "--reduced", "--steps", "3", "--batch", "2",
                     "--seq", "32", "--log-every", "2", "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 3
    assert lines[0].startswith("[train] step=0 loss=") and " gnorm=" in lines[0]
    assert lines[1].startswith("[train] step=2 loss=")
    assert lines[2].startswith("[train] done: 3 steps in ")
