"""LLM training in repro_torch (train/loss.py, optim/adamw.py, the train
and eval steps, remat, the train-state carry-over) against the JAX
package on the CPU.

Every LM architecture at `reduced()` starts from the JAX package's
weights (each all-zero leaf replaced by seeded noise, as in
test_torch_lm.py) and takes the same `token_batch` batches (B = 2,
S = 32). Tolerance: fp32 sums in another order, max |port - jax| <=
RTOL * max |jax| per leaf with RTOL = 1e-4 (observed <= 1.1e-5 for
gradients); the bf16 case uses 2e-2. The train-step comparisons run
AdamW at lr 1e-4: AdamW divides each element's moment by its own
RMS, so an element whose gradient is a rounding-level residue moves by
~lr in either package, and at lr 1e-3 that reached 2.3e-4 of max |p|
after three steps (the embedding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config, reduced
from repro.data.synthetic import PipelineState as JxPipe
from repro.data.synthetic import token_batch as jx_token_batch
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.train import loss as jloss
from repro.train import step as jstep
from repro_torch.configs import base as tconfigs
from repro_torch.data.synthetic import PipelineState, token_batch
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttrans
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.train.loss import cross_entropy

torch.set_num_threads(1)
RTOL = 1e-4
CPU = "cpu"
LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]
B, S = 2, 32
STEPS = 3
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)


def _cfgs(arch):
    return reduced(get_config(arch)), tconfigs.reduced(tconfigs.get_config(arch))


def _close(name, got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-30), f"{name}: max err {err:.3e}, max |ref| {scale:.3e}"


def _tree_close(name, got, want, rtol=RTOL):
    gl, gd = jax.tree_util.tree_flatten_with_path(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert jax.tree_util.tree_structure(got) == wd, f"{name}: layout differs"
    for (path, g), w in zip(gl, wl):
        _close(f"{name} {jax.tree_util.keystr(path)}", np.asarray(g), w, rtol)


def _noisy(tree, seed):
    """JAX params as numpy, every all-zero float leaf replaced by
    0.1 * N(0, 1), so the port's use (and gradient) of each is checked."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jax_params(cfg, dtype=jnp.float32):
    return _noisy(jax.jit(lambda k: japi.init_model(cfg, k, dtype))(jax.random.PRNGKey(0)), 0)


def _jax_state(params_np):
    p = _jnp(params_np)
    return jstep.TrainState(jnp.zeros((), jnp.int32), p, jadamw.init_opt_state(p))


def _jax_state_from(state_np):
    """A JAX TrainState from the port's numpy layout (train_state_to_numpy)."""
    return jstep.TrainState(jnp.asarray(state_np.step), _jnp(state_np.params),
                            jadamw.OptState(jnp.asarray(state_np.opt.count),
                                            _jnp(state_np.opt.m), _jnp(state_np.opt.v)))


def _port_grads(model, batch, tcfg):
    logits = tapi.forward(model, batch, tcfg, device=CPU)
    loss, aux = cross_entropy(logits, torch.from_numpy(batch["labels"]))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(),
                                                                            grads)}
    return loss, aux, grads


_RUNS = {}


def _run(arch):
    """JAX and the port on one arch from the same weights and batches: loss
    and gradients, the eval step, and three train steps (the state after
    each). Computed once per arch; the tests below read it."""
    if arch in _RUNS:
        return _RUNS[arch]
    cfg, tcfg = _cfgs(arch)
    pnp = _jax_params(cfg)
    batches = [jx_token_batch(cfg, B, S, JxPipe(0, s)) for s in range(STEPS)]
    r = {"cfg": cfg, "tcfg": tcfg, "pnp": pnp, "batches": batches}

    def loss_fn(p, b):
        return jloss.cross_entropy(japi.forward(p, b, cfg), b["labels"])

    (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_jnp(pnp),
                                                                       _jnp(batches[0]))
    model = tapi.params_from_jax(tcfg, pnp, device=CPU)
    loss, aux, grads = _port_grads(model, batches[0], tcfg)
    r["loss"] = ({"loss": loss, **aux}, {"loss": jl, **jaux})
    r["grads"] = (tapi.tree_to_numpy(tcfg, grads), _np(jg))
    r["eval"] = (tstep.make_eval_step(tcfg, device=CPU)(model, batches[0]),
                 jax.jit(jstep.make_eval_step(cfg))(_jnp(pnp), _jnp(batches[0])))
    del model
    jf = jax.jit(jstep.make_train_step(cfg, jadamw.AdamWConfig(**OPT)))
    tf = tstep.make_train_step(tcfg, adamw.AdamWConfig(**OPT), device=CPU)
    js = _jax_state(pnp)
    ts = tapi.train_state_from_jax(tcfg, _np(js), device=CPU)
    r["steps"] = []
    for b in batches:
        js, jm = jf(js, _jnp(b))
        ts, tm = tf(ts, b)
        r["steps"].append((tapi.train_state_to_numpy(tcfg, ts), _np(js), tm, _np(jm)))
    r["jf"], r["tf"] = jf, tf
    _RUNS[arch] = r
    return r


# ------------------------------------------------------------ loss, AdamW
def test_cross_entropy_masking():
    """Twin of test_gnn_loss_optim.py's: uniform logits, one masked label."""
    logits = torch.zeros((1, 4, 10))
    labels = torch.tensor([[1, 2, -1, 3]])
    loss, aux = cross_entropy(logits, labels, z_loss=0.0)
    np.testing.assert_allclose(float(loss), np.log(10), rtol=1e-5)
    assert float(aux["tokens"]) == 3.0


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_cross_entropy_values_and_logit_gradient_match_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = -1
    lt = torch.from_numpy(logits).requires_grad_()
    loss, aux = cross_entropy(lt, torch.from_numpy(labels), z_loss)
    (g,) = torch.autograd.grad(loss, lt)

    def f(x):
        return jloss.cross_entropy(x, jnp.asarray(labels), z_loss)

    (jl, jaux), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    for k, v in {"loss": loss, **aux}.items():
        _close(k, v, {"loss": jl, **jaux}[k], 1e-6)
    _close("dloss/dlogits", g, jg, 1e-6)
    assert float(g[0, :3].abs().max()) == 0.0  # masked positions get no gradient
    all_masked = cross_entropy(lt.detach(), torch.full((2, 7), -1), z_loss)
    assert float(all_masked[0]) == 0.0 and float(all_masked[1]["tokens"]) == 0.0


def test_schedule_shapes():
    """Twin of test_gnn_loss_optim.py's."""
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, 0)) == 0.0
    assert abs(float(adamw.schedule(cfg, 10)) - 1.0) < 0.11
    assert float(adamw.schedule(cfg, 100)) <= 0.1 + 1e-6


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_schedule_matches_jax(warmup):
    """Steps 0, 1, the end of warmup, mid-run, total_steps and beyond, as
    ints and as int32 tensors."""
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=100, min_lr_frac=0.1)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    for step in (0, 1, warmup, warmup + 1, 55, 100, 101, 250):
        want = float(jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = adamw.schedule(cfg, s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    grads = {"w": rng.standard_normal((5, 3)).astype(np.float32),
             "ln1": rng.standard_normal(3).astype(np.float32),
             "b_up": rng.standard_normal(4).astype(np.float32)}
    jg, jn = jadamw.clip_by_global_norm(_jnp(grads), max_norm)
    tg = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    got, gn = adamw.clip_by_global_norm(tg, max_norm)
    _close("global norm", gn, jn, 1e-6)
    for k in grads:  # every gradient scaled, decayed or not
        _close(k, got[k], jg[k], 1e-6)
        assert got[k] is tg[k]  # in place
    scaled = float(np.linalg.norm(np.concatenate([g.numpy().ravel() for g in got.values()])))
    assert scaled == pytest.approx(min(max_norm, float(jn)), rel=1e-5)


def test_adamw_descends_quadratic():
    """Twin of test_gnn_loss_optim.py's."""
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0, total_steps=100,
                            clip_norm=100.0)
    for _ in range(60):
        params, opt, _ = adamw.adamw_update(cfg, {"w": 2 * params["w"]}, params, opt)
    assert float(params["w"].abs().max()) < 0.5
    assert int(opt.count) == 60


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates of a dict with decayed and undecayed names, weight
    decay 0.5 (so the mask shows), fp32 moments for bf16 weights."""
    rng = np.random.default_rng(2)
    names = ("wq", "ln1", "conv_b", "b_up", "dt_bias", "embed", "w")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = {n: rng.standard_normal((4, 3)).astype(np.float32) for n in names}
    kw = dict(lr=0.05, weight_decay=0.5, warmup_steps=1, total_steps=5, clip_norm=1.0)
    jp = {n: jnp.asarray(a, jdt) for n, a in p0.items()}
    jo = jadamw.init_opt_state(jp)
    tp = {n: torch.from_numpy(a).to(tdt) for n, a in p0.items()}
    to = adamw.init_opt_state(tp)
    assert all(m.dtype == torch.float32 for m in to.m.values())
    for i in range(3):
        g = {n: rng.standard_normal((4, 3)).astype(np.float32) for n in names}
        jp, jo, jaux = jadamw.adamw_update(jadamw.AdamWConfig(**kw),
                                           {n: jnp.asarray(a, jdt) for n, a in g.items()},
                                           jp, jo)
        tp, to, taux = adamw.adamw_update(adamw.AdamWConfig(**kw),
                                          {n: torch.from_numpy(a).to(tdt) for n, a in g.items()},
                                          tp, to)
        rtol = 1e-5 if dtype == "float32" else 2e-2
        for n in names:
            assert tp[n].dtype == tdt
            _close(f"step {i} {n}", tp[n], np.asarray(jp[n], np.float32), rtol)
            _close(f"step {i} m {n}", to.m[n], jo.m[n], rtol)
            _close(f"step {i} v {n}", to.v[n], jo.v[n], rtol)
        _close(f"step {i} grad_norm", taux["grad_norm"], jaux["grad_norm"], rtol)
        _close(f"step {i} lr", taux["lr"], jaux["lr"], 1e-6)
        assert int(to.count) == int(jo.count) == i + 1


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decayed_names_equal_jax(arch):
    """The port's name test decays exactly the leaves JAX's path test does."""
    cfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: japi.init_model(cfg, jax.random.PRNGKey(0), jnp.float32))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]

    def key(path):
        return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)

    jax_decayed = {key(p) for p, _ in flat if jadamw._decay_mask(p)}
    model = tapi.init_model(tcfg, 0, device=CPU)
    port_decayed = {tapi.jax_path(tcfg, n)[0] for n, _ in model.named_parameters()
                    if adamw._decay_mask(n)}
    assert port_decayed == jax_decayed
    assert {tapi.jax_path(tcfg, n)[0] for n, _ in model.named_parameters()} == {
        key(p) for p, _ in flat}


# ------------------------------------------- every LM architecture
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    r = _run(arch)
    got, want = r["loss"]
    for k in ("loss", "nll", "z_loss", "tokens"):
        _close(f"{arch} {k}", got[k], want[k])
    _tree_close(f"{arch} grad", *r["grads"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_eval_step_matches_jax(arch):
    got, want = _run(arch)["eval"]
    assert set(got) == set(want) == {"loss", "nll", "z_loss", "tokens"}
    assert float(got["z_loss"]) == 0.0
    for k in got:
        assert not got[k].requires_grad
        _close(f"{arch} eval {k}", got[k], want[k])


def _check_step(arch, i):
    ts, js, tm, jm = _run(arch)["steps"][i]
    assert int(ts.step) == int(js.step) == i + 1
    assert int(ts.opt.count) == int(js.opt.count) == i + 1
    assert set(tm) == set(jm) == {"loss", "nll", "z_loss", "tokens", "grad_norm", "lr"}
    for k in tm:
        assert isinstance(tm[k], torch.Tensor) and not tm[k].requires_grad
        _close(f"{arch} step {i} {k}", tm[k], jm[k])
    _tree_close(f"{arch} step {i} params", ts.params, js.params)
    _tree_close(f"{arch} step {i} m", ts.opt.m, js.opt.m)
    _tree_close(f"{arch} step {i} v", ts.opt.v, js.opt.v)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_one_train_step_matches_jax(arch):
    _check_step(arch, 0)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_three_train_steps_match_jax(arch):
    for i in range(STEPS):
        _check_step(arch, i)


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b", "whisper_small"])
def test_a_step_in_one_package_continues_in_the_other(arch):
    """JAX takes step 1 and the port steps 2 and 3; the port takes step 1
    and JAX steps 2 and 3: both end where each package alone ends."""
    r = _run(arch)
    tcfg, b = r["tcfg"], r["batches"]
    ts = tapi.train_state_from_jax(tcfg, r["steps"][0][1], device=CPU)
    for batch in b[1:]:
        ts, _ = r["tf"](ts, batch)
    _tree_close(f"{arch} JAX then port", tapi.train_state_to_numpy(tcfg, ts).params,
                r["steps"][-1][1].params)
    js = _jax_state_from(r["steps"][0][0])
    for batch in b[1:]:
        js, _ = r["jf"](js, _jnp(batch))
    _tree_close(f"{arch} port then JAX", _np(js.params), r["steps"][-1][0].params)
    _tree_close(f"{arch} port then JAX m", _np(js.opt.m), r["steps"][-1][0].opt.m)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_state_round_trips_through_the_jax_layout(arch):
    """train_state_from_jax then train_state_to_numpy gives JAX's leaves
    back exactly, in JAX's layout."""
    cfg, tcfg = _cfgs(arch)
    want = _np(_jax_state(_jax_params(cfg)))
    want = want._replace(step=np.asarray(4, np.int32), opt=want.opt._replace(
        count=np.asarray(4, np.int32), m=_noisy(want.opt.m, 1), v=_noisy(want.opt.v, 2)))
    got = tapi.train_state_to_numpy(tcfg, tapi.train_state_from_jax(tcfg, want, device=CPU))
    for name, g, w in (("params", got.params, want.params), ("m", got.opt.m, want.opt.m),
                       ("v", got.opt.v, want.opt.v)):
        assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(w), name
        for a, bb in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_array_equal(a, bb)
    assert int(got.step) == int(got.opt.count) == 4


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_leaves_the_gradients_unchanged(arch, monkeypatch):
    """Activation checkpointing of the tail units (and Whisper's layers)
    recomputes the forward in the backward: the same gradients, bit for
    bit, as without it."""
    _, tcfg = _cfgs(arch)
    model = tapi.init_model(tcfg, 3, device=CPU)
    batch = token_batch(tcfg, B, S, PipelineState(1, 0))
    grads = {}
    for on in (True, False):
        monkeypatch.setattr(ttrans, "REMAT", on)
        grads[on] = _port_grads(model, batch, tcfg)[2]
    for n in grads[True]:
        assert torch.equal(grads[True][n], grads[False][n]), n


def test_remat_checkpoints_the_tail_units_only(monkeypatch):
    """A hybrid's period is one unit; its head layers run outside."""
    _, tcfg = _cfgs("recurrentgemma_2b")
    calls = []
    real = ttrans.checkpoint

    def spy(fn, *args, **kw):
        calls.append(len(args[1]))
        return real(fn, *args, **kw)

    monkeypatch.setattr(ttrans, "checkpoint", spy)
    model = tapi.init_model(tcfg, 0, device=CPU)
    tapi.forward(model, token_batch(tcfg, B, S, PipelineState(0, 0)), tcfg, device=CPU)
    head, unit, reps = ttrans._stack_plan(tcfg)
    assert calls == [len(unit)] * reps and len(head) + len(unit) * reps == tcfg.n_layers
    with torch.no_grad():
        tapi.forward(model, token_batch(tcfg, B, S, PipelineState(0, 0)), tcfg, device=CPU)
    assert len(calls) == reps  # no remat without grad


def test_bf16_loss_and_gradients_match_jax():
    """bf16 weights (init_train_state's default dtype), fp32 logits."""
    cfg, tcfg = _cfgs("qwen3_14b")
    pnp = _jax_params(cfg, jnp.bfloat16)
    batch = jx_token_batch(cfg, B, S, JxPipe(0, 0))

    def loss_fn(p, b):
        return jloss.cross_entropy(japi.forward(p, b, cfg), b["labels"])

    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_jnp(pnp), _jnp(batch))
    model = tapi.params_from_jax(tcfg, pnp, device=CPU)
    assert model.embed.dtype == torch.bfloat16
    loss, _, grads = _port_grads(model, batch, tcfg)
    _close("bf16 loss", loss, jl, 2e-2)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    _tree_close("bf16 grad", tapi.tree_to_numpy(tcfg, grads),
                jax.tree.map(lambda a: np.asarray(a, np.float32), jg), 2e-2)


def test_init_train_state_is_bf16_with_fp32_moments():
    _, tcfg = _cfgs("mamba2_2_7b")
    st = tstep.init_train_state(tcfg, 0, device=CPU)
    assert st.params.embed.dtype == torch.bfloat16 and int(st.step) == 0
    assert st.params.blocks[0].mixer.a_log.dtype == torch.float32  # as JAX keeps it
    assert all(m.dtype == torch.float32 and not m.any() for m in st.opt.m.values())
    assert set(st.opt.m) == set(st.opt.v) == {n for n, _ in st.params.named_parameters()}
    assert int(st.opt.count) == 0 and st.opt.count.dtype == torch.int32
    assert all(p.requires_grad for p in st.params.parameters())


def test_serving_stays_grad_free():
    """Prefill and decode run under no_grad although the weights train."""
    _, tcfg = _cfgs("qwen3_14b")
    model = tapi.init_model(tcfg, 0, device=CPU)
    cache = tapi.init_cache(tcfg, 1, 8, torch.float32, device=CPU)
    logits, cache = tapi.prefill(model, {"tokens": np.zeros((1, 4), np.int32)}, tcfg, cache,
                                 device=CPU)
    assert not logits.requires_grad and not cache["layers"][0]["k"].requires_grad


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device=, the training entry points ask for CUDA and raise
    where there is none: no fallback to the CPU."""
    from repro_torch.launch import train

    _, tcfg = _cfgs("qwen3_14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tstep.init_train_state(tcfg, 0),
                 lambda: tstep.make_train_step(tcfg, adamw.AdamWConfig()),
                 lambda: tstep.make_eval_step(tcfg),
                 lambda: train.main(["--arch", "qwen3_14b", "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
