"""Mellum2 in the port against the benchmark's plain reference
(bench/reference/mellum2.py), at the reduced size on the CPU: d 64, 4
query heads over 2 KV heads of 16, window 8, 32 tokens, 8 experts top-2
of width 32, the four layers of one LLLG period. The port runs its
normal LM path (`make_train_step`, `lm_forward`) with and without the
scheduler; the reference computes the same model from its equations.
Also: the band CSR against the benchmark's generator, YaRN's
frequencies against the formula, the layer plan, and the JAX-twin
config surface left as it was."""
import copy
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.gen import causal_band
from bench.models import mellum2 as fam
from bench.reference import mellum2 as ref
from bench.work import lm as lm_work
from repro_torch.configs import ARCH_IDS, ArchConfig, mellum2
from repro_torch.configs.layers import FULL, WINDOW, layer_plan
from repro_torch.core import AutoSage, ScheduleCache, obs
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.modules import yarn_freqs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEQ = 32
SEED = 2 ** 35 + 3
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "sliding_window": 8}
MIX = {"seq_len": SEQ, "batch": 1}
OPT = json.loads((ROOT / "bench" / "traffic" / "lm-pretrain-8k.json").read_text())["adamw"]
# fp32 on both sides, the same equations in another order of operations
# (CSR kernels against dense masked products, per-expert loops against a
# sorted dispatch): agreement to a few ulps of the largest value
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5


def _config():
    config = json.loads((ROOT / "bench" / "configs" / "mellum2-12b.json").read_text())
    return dict(config, **TINY)


def _program(config, sage):
    cfg = fam.program_config(config)
    model = transformer.init_lm(cfg, 0, torch.float32, CPU)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, w in fam.iter_weights(config, SEED, CPU):
            params[name].copy_(w)
    return cfg, model


def _batch(config):
    return fam.next_batch(config, MIX, fam.token_generator(SEED, CPU))


def _sage(tmp_path):
    return AutoSage(cache=ScheduleCache(path=str(tmp_path / "cache.json")), device=CPU)


def _close(got, want, tol):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, (float((got - want).abs().max()), scale)


@pytest.mark.parametrize("scheduled", [False, True], ids=["plain", "scheduled"])
def test_logits_loss_and_grads_match_the_reference(scheduled, tmp_path):
    config = _config()
    cfg, model = _program(config, None)
    sage = _sage(tmp_path) if scheduled else None
    batch = _batch(config)
    logits = transformer.lm_forward(model, batch, cfg, sage=sage)
    w = fam.weights(config, SEED, CPU)
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    want_logits = ref.forward(leaves, batch["tokens"][0], config)
    _close(logits[0].detach(), want_logits.detach(), LOGIT_TOL)

    from repro_torch.train.loss import cross_entropy

    loss, _ = cross_entropy(logits, batch["labels"])
    want_loss = ref.loss_of(leaves, batch, config)
    assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-6 * abs(
        float(want_loss.detach()))
    names = list(w)
    got = torch.autograd.grad(loss, [dict(model.named_parameters())[n] for n in names])
    want = torch.autograd.grad(want_loss, [leaves[n] for n in names])
    for n, g, h in zip(names, got, want):
        _close(g, h, GRAD_TOL)


@pytest.mark.parametrize("scheduled", [False, True], ids=["plain", "scheduled"])
def test_one_adamw_step_matches_the_reference(scheduled, tmp_path):
    """The port's train step (AdamW, clip, warm-up) against the
    reference's. Adam's first update is lr * g / (|g| + eps): where the
    gradient is ~1e-7 of its leaf's largest its sign is rounding, so the
    weights are compared where |g| is above 1e-4 of the leaf's largest;
    there the updated weights agree to two ulps of fp32 (the update,
    ~lr = 3e-6 at the first warm-up step, is rounded into weights of
    ~1e-2, where one ulp is ~1e-9)."""
    config = _config()
    cfg, model = _program(config, None)
    from repro_torch.optim.adamw import init_opt_state

    state = TrainState(torch.zeros((), dtype=torch.int32), model, init_opt_state(model))
    step = make_train_step(cfg, AdamWConfig(**OPT), device=CPU,
                           sage=_sage(tmp_path) if scheduled else None)
    batch = _batch(config)
    state, metrics = step(state, batch)
    w = fam.weights(config, SEED, CPU)
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    grads = dict(zip(w, torch.autograd.grad(ref.loss_of(leaves, batch, config),
                                            list(leaves.values()))))
    after = dict(w)
    losses, grad_norms = ref.train(after, [batch], config, OPT)
    assert abs(float(metrics["loss"]) - losses[0]) <= 1e-6 * abs(losses[0])
    params = dict(state.params.named_parameters())
    for n in w:
        g = grads[n]
        sure = g.abs() > 1e-4 * g.abs().max()
        assert bool(sure.any())
        torch.testing.assert_close(params[n].detach()[sure], after[n][sure], rtol=2.4e-7,
                                   atol=1e-10)
        m_norm = float(torch.linalg.vector_norm(state.opt.m[n].double())) / (1 - OPT["b1"])
        assert m_norm == pytest.approx(grad_norms[n], rel=1e-5)


def test_scheduled_attention_equals_the_unscheduled(tmp_path):
    config = _config()
    cfg, model = _program(config, None)
    batch = _batch(config)
    plain = transformer.lm_forward(model, batch, cfg)
    sched = transformer.lm_forward(model, batch, cfg, sage=_sage(tmp_path))
    _close(sched.detach(), plain.detach(), LOGIT_TOL)


@pytest.mark.parametrize("seq,window,batch", [(32, 8, 1), (50, 7, 3), (5, 8, 2), (1, 1, 1)])
def test_band_csr_equals_the_benchmark_generator(seq, window, batch):
    csr = attn_mod.band_csr(seq, window, batch)
    g = causal_band.band(seq, window, batch, CPU)
    rowptr, colind = g.host_arrays()
    np.testing.assert_array_equal(csr.rowptr, rowptr)
    np.testing.assert_array_equal(csr.colind, colind)
    assert csr.nnz == lm_work.band_nnz(seq, window) * batch
    csr.validate()
    assert not csr.has_duplicate_edges()


def test_band_csr_is_memoized_and_counted():
    before_built = obs.REGISTRY.get(obs.BAND_CSR_TOTAL, event="built") or 0
    before_hits = obs.REGISTRY.get(obs.BAND_CSR_TOTAL, event="hits") or 0
    a = attn_mod.band_csr(37, 5, 2)
    b = attn_mod.band_csr(37, 5, 2)
    assert a is b
    assert (obs.REGISTRY.get(obs.BAND_CSR_TOTAL, event="hits") or 0) >= before_hits + 1
    assert (obs.REGISTRY.get(obs.BAND_CSR_TOTAL, event="built") or 0) >= before_built


def test_full_band_matches_the_dense_causal_window_mask():
    csr = attn_mod.band_csr(12, 4, 1)
    dense = np.zeros((12, 12), bool)
    for r in range(12):
        dense[r, csr.colind[csr.rowptr[r]:csr.rowptr[r + 1]]] = True
    q, k = np.arange(12)[:, None], np.arange(12)[None, :]
    np.testing.assert_array_equal(dense, (k <= q) & (k > q - 4))


def test_yarn_frequencies_against_the_formula():
    r = mellum2.FULL_ROPE
    dim = 128
    got = yarn_freqs(dim, r.theta, r.factor, r.original_max_positions, r.beta_fast,
                     r.beta_slow).double().numpy()

    def d_of(rot):
        return dim * math.log(r.original_max_positions / (2 * math.pi * rot)) / (
            2 * math.log(r.theta))

    low, high = math.floor(d_of(r.beta_fast)), math.ceil(d_of(r.beta_slow))
    assert (low, high) == (18, 35)
    base = 1.0 / r.theta ** (np.arange(0, dim, 2) / dim)
    share = np.clip((np.arange(dim // 2) - low) / (high - low), 0, 1)
    want = base * (1 - share) + base / r.factor * share
    np.testing.assert_allclose(got, want, rtol=2e-6)
    np.testing.assert_allclose(got[:low], base[:low], rtol=2e-6)
    np.testing.assert_allclose(got[high:], base[high:] / 16, rtol=2e-6)
    assert r.attention_factor == pytest.approx(0.1 * math.log(16) + 1)
    # the reference computes the same frequencies on its own
    rp = _config()["rope_parameters"]["full_attention"]
    np.testing.assert_allclose(ref.yarn_inv_freq(dim, rp, CPU).double().numpy(), want, rtol=2e-6)


def test_layer_plan_is_three_window_layers_then_a_full_one():
    plan = layer_plan(mellum2.CONFIG)
    assert [a.kind for a in plan] == [WINDOW, WINDOW, WINDOW, FULL] * 7
    assert {a.window for a in plan if a.kind == WINDOW} == {1024}
    assert all(a.window is None and a.rope.kind == "yarn" for a in plan if a.kind == FULL)
    assert all(a.rope.kind == "default" and a.rope.theta == 5e5 for a in plan if a.kind == WINDOW)
    cut = layer_plan(dataclasses.replace(mellum2.CONFIG, n_layers=4))
    assert [a.kind for a in cut] == [WINDOW, WINDOW, WINDOW, FULL]
    published = json.loads((ROOT / "bench" / "configs" / "mellum2-12b.json").read_text())
    assert [("sliding_attention" if a.kind == WINDOW else "full_attention") for a in plan] == \
        published["layer_types"]


def test_other_configs_have_no_plan_and_the_twin_surface_is_unchanged():
    from repro_torch.configs import get_config

    assert "mellum2" not in " ".join(ARCH_IDS)
    assert all(layer_plan(get_config(a)) is None for a in ARCH_IDS)
    assert [f.name for f in dataclasses.fields(ArchConfig)] == [
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
        "head_dim", "qkv_bias", "qk_norm", "rope_theta", "norm_eps", "tie_embeddings", "moe",
        "mla", "ssm", "hybrid", "enc_dec", "vlm_patches", "long_window", "long_sinks", "source"]
    assert get_config("mellum2") is mellum2.CONFIG


def test_published_widths_and_parameter_count():
    c = mellum2.CONFIG
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.vocab) == (2304, 32, 4, 128, 98304)
    assert (c.moe.n_experts, c.moe.top_k, c.moe.d_expert, c.moe.n_shared) == (64, 8, 896, 0)
    four = dataclasses.replace(c, n_layers=4)
    shapes = fam.weight_shapes(json.loads(
        (ROOT / "bench" / "configs" / "mellum2-12b.json").read_text()))
    # n_params counts the matrices, not the norms' weights
    assert four.n_params() == sum(math.prod(s) for _, s in shapes if len(s) > 1) == 2123956224
    assert fam.program_config(json.loads(
        (ROOT / "bench" / "configs" / "mellum2-12b.json").read_text())) == four


def test_mesh_step_refuses_a_scheduler():
    with pytest.raises(ValueError):
        make_train_step(mellum2.REDUCED, AdamWConfig(), device=CPU, mesh=object(),
                        sage=object())


def test_moe_rows_counter_counts_dispatched_copies(tmp_path):
    config = _config()
    cfg, model = _program(config, None)
    before = obs.REGISTRY.total(obs.MOE_ROWS_TOTAL)
    with torch.no_grad():
        transformer.lm_forward(model, _batch(config), cfg)
    assert obs.REGISTRY.total(obs.MOE_ROWS_TOTAL) - before == 4 * SEQ * 2


def test_spans_of_the_plan_are_recorded(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    monkeypatch.setenv("AUTOSAGE_OBS_DIR", str(tmp_path / "obs"))
    config = _config()
    cfg, model = _program(config, None)
    obs.reset()
    try:
        step = make_train_step(cfg, AdamWConfig(**OPT), device=CPU, sage=_sage(tmp_path))
        from repro_torch.optim.adamw import init_opt_state

        step(TrainState(torch.zeros((), dtype=torch.int32), model, init_opt_state(model)),
             _batch(config))
        names = set(obs.span_names())
    finally:
        obs.reset()
    assert {"lm.swa_attention", "lm.full_attention", "lm.moe", "lm.head", "lm.loss",
            "run", "softmax.recompute"} <= names


def test_cache_paths_take_each_layers_window_and_rope():
    """Prefill through the cache (dense masked path) gives the training
    forward's last logits: the plan's windows and ropes reach it too."""
    config = _config()
    cfg, model = _program(config, None)
    batch = _batch(config)
    with torch.no_grad():
        full = transformer.lm_forward(model, batch, cfg)
        cache = transformer.init_lm_cache(cfg, 1, SEQ, torch.float32, CPU)
        last, _ = transformer.lm_prefill(model, {"tokens": batch["tokens"]}, cfg,
                                         copy.deepcopy(cache))
    _close(last[0, 0], full[0, -1], LOGIT_TOL)
