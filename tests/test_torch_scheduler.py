"""repro_torch's scheduler on the CPU: a twin of examples/quickstart.py
with the hand-kernel families probed through their plain versions
(AUTOSAGE_PROBE_PALLAS=1), the schedule cache and its replay contract,
cache files shared with the JAX package, estimates keyed off the
PORTED_FROM table, and the device rule."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import estimate as jx_est
from repro.core import registry as jx_registry
from repro.core import transfer as jx_transfer
from repro.core.cache import ScheduleCache as JxCache
from repro.core.features import HardwareSpec as JxHw
from repro.core.features import InputFeatures as JxFeat
from repro.kernels import ref as jx_ref
from repro.sparse import CSR as JxCSR
from repro.sparse import graph_signature as jx_graph_signature
from repro_torch import api
from repro_torch.core import (
    AutoSage,
    HardwareSpec,
    InputFeatures,
    ReplayMiss,
    ScheduleCache,
    parse_key,
)
from repro_torch.core import estimate as est
from repro_torch.core import registry
from repro_torch.sparse import erdos_renyi, hub_skew

torch.set_num_threads(1)  # see test_torch_spmm.py

CPU = torch.device("cpu")


@pytest.fixture
def probe_kernels(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")


def _sage(path, **kw):
    return AutoSage(cache=ScheduleCache(path=path, **kw), device="cpu",
                    probe_iters=2, probe_cap_ms=200)


@pytest.mark.parametrize("graph", ["erdos_renyi", "hub_skew"])
def test_quickstart_twin_decides_caches_replays(tmp_path, probe_kernels, graph):
    csr = (erdos_renyi(3000, 1.5e-3, seed=0) if graph == "erdos_renyi"
           else hub_skew(3000, 4, 0.05, 300, seed=0))
    path = str(tmp_path / "cache.json")
    sage = _sage(path)
    b = np.random.default_rng(0).standard_normal((csr.n_cols, 64)).astype(np.float32)
    out = api.spmm(csr, torch.from_numpy(b), sage=sage, differentiable=False)
    d = sage.decide(csr, 64, "spmm")
    assert d.from_cache
    first = sage.cache.get(sage.cache.keys_for_op("spmm")[0])
    assert any("_cuda" in name for name in first["estimates_ms"])
    assert d.choice == "baseline" or d.choice in first["probe_ms"]
    exp = jx_ref.spmm_ref(csr.rowptr, csr.colind, None, b)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-4)
    # replay in a fresh scheduler: the same choice, no probe
    replay = _sage(path, replay_only=True)
    d_r = replay.decide(csr, 64, "spmm")
    assert d_r.from_cache and d_r.choice == d.choice
    with pytest.raises(ReplayMiss):
        replay.decide(csr, 48, "spmm")  # unseen key: F is part of it


def test_pinned_kernel_families_run_through_the_cache(tmp_path, probe_kernels):
    """Pinning a family through the cache (the replay path) runs it."""
    csr = hub_skew(800, 4, 0.05, 120, seed=1)
    b = torch.from_numpy(
        np.random.default_rng(1).standard_normal((csr.n_cols, 40)).astype(np.float32))
    exp = api.spmm(csr, b)
    path = str(tmp_path / "cache.json")
    sage = _sage(path)
    sage.decide(csr, 40, "spmm")
    key = sage.cache.keys_for_op("spmm")[0]
    feat = InputFeatures.from_csr(csr, 40, "spmm")
    names = [v.full_name() for v in registry.candidates(feat, sage.hw, CPU)]
    assert {n.split("[")[0] for n in names} >= {
        "block_ell_cuda", "ragged_ell_cuda", "merge_path_cuda", "hub_ragged_cuda"}
    for name in names:
        sage.cache.put(key, {"choice": name, "probe_ms": {}, "estimates_ms": {}})
        pinned = _sage(path, replay_only=True)
        d = pinned.decide(csr, 40, "spmm")
        assert d.choice == name and d.variant.full_name() == name
        out = api.spmm(csr, b, sage=pinned, differentiable=False)
        torch.testing.assert_close(out, exp, rtol=1e-5, atol=1e-5)


def test_cache_files_load_in_both_packages(tmp_path, probe_kernels):
    csr = erdos_renyi(1200, 2e-3, seed=4)
    path = str(tmp_path / "port.json")
    sage = _sage(path)
    d = sage.decide(csr, 32, "spmm")
    key = sage.cache.keys_for_op("spmm")[0]
    jx = JxCache(path=path, replay_only=False)
    assert jx.get(key)["choice"] == d.choice
    assert jx.get(key)["schema"] == 6
    assert jx.get(key)["neutral"]["features"] == InputFeatures.from_csr(
        csr, 32, "spmm").to_neutral()
    # the reverse: a JAX-written file loads, parses and replays here
    jpath = str(tmp_path / "jax.json")
    jcache = JxCache(path=jpath, replay_only=False)
    jx_csr = JxCSR(csr.rowptr, csr.colind, None, csr.n_rows, csr.n_cols)
    jkey = JxCache.key("cpu:cpu:jax", jx_graph_signature(jx_csr), 32, "spmm", 0.95)
    jcache.put(jkey, {"choice": "baseline", "probe_ms": {"baseline": 1.0},
                      "estimates_ms": {}})
    port = ScheduleCache(path=jpath, replay_only=True)
    assert port.get(jkey)["choice"] == "baseline"
    assert parse_key(jkey).sig == InputFeatures.from_csr(csr, 32, "spmm").graph_sig


def _jx_feat(feat):
    return JxFeat(**dataclasses.asdict(feat))


def test_estimates_follow_the_ported_family():
    """On a shared roofline profile each CUDA variant is costed exactly as
    the repro variant of its PORTED_FROM family (F <= 128: one step per
    slot in both)."""
    csr = hub_skew(2000, 4, 0.05, 400, seed=2)
    feat = InputFeatures.from_csr(csr, 64, "spmm")
    pool = registry.candidates(feat, HardwareSpec.cpu(), CPU, include_kernels=True)
    jx_pool = {
        (v.name, tuple(sorted((k, x) for k, x in v.knobs.items() if k != "f_tile"))): v
        for v in jx_registry.candidates(_jx_feat(feat), JxHw.cpu(), include_pallas=True)
        if v.knobs.get("f_tile", 128) == 128
    }
    for v in pool:
        family = registry.PORTED_FROM[v.name]
        twin = jx_pool[(family, tuple(sorted(v.knobs.items())))]
        mine = est.estimate(feat, HardwareSpec.cpu(), v.name, v.knobs)
        theirs = jx_est.estimate(_jx_feat(feat), JxHw.cpu(), twin.name, twin.knobs)
        assert mine == pytest.approx(theirs, rel=1e-12), v.full_name()


def test_h100_charges_sddmm_families_by_their_own_step():
    """The CPU profiles charge the SDDMM block families ``step_s``, as the
    JAX package does. The h100 profile charges them ``sddmm_step_s`` (fitted
    on the SDDMM kernel) and the SpMM families ``step_s`` (fitted on the
    ragged SpMM kernel): moving one constant moves only its own families'
    estimates."""
    for hw in (HardwareSpec.cpu(), HardwareSpec.cpu_wide()):
        assert hw.sddmm_step_s == hw.step_s
    h100 = HardwareSpec.h100()
    assert h100.sddmm_step_s != h100.step_s
    csr = hub_skew(2000, 4, 0.05, 400, seed=2)
    for op, moved, kept in (("attention_bwd_e", "sddmm_step_s", "step_s"),
                            ("spmm", "step_s", "sddmm_step_s")):
        feat = InputFeatures.from_csr(csr, 256, op)
        pool = [v for v in registry.candidates(feat, h100, CPU, include_kernels=True)
                if v.name in ("block_ell_cuda", "ragged_ell_cuda", "merge_path_cuda")]
        assert {v.name for v in pool} == {"block_ell_cuda", "ragged_ell_cuda",
                                          "merge_path_cuda"}, op
        for v in pool:
            base = est.estimate(feat, h100, v.name, v.knobs)
            more = dataclasses.replace(h100, **{moved: 2 * getattr(h100, moved)})
            other = dataclasses.replace(h100, **{kept: 2 * getattr(h100, kept)})
            assert est.estimate(feat, more, v.name, v.knobs) > base, (op, v.full_name())
            assert est.estimate(feat, other, v.name, v.knobs) == base, (op, v.full_name())


def test_h100_charges_fused_attention_families_by_their_own_step():
    """The CPU profiles charge the fused attention families ``step_s``, as
    the JAX package does. The h100 profile charges them ``attn_step_s``
    (fitted on the redesigned ragged attention kernel): moving it moves
    the fused families' estimates and no composed pipe's, and moving
    ``step_s`` or ``sddmm_step_s`` leaves the fused families' alone."""
    for hw in (HardwareSpec.cpu(), HardwareSpec.cpu_wide()):
        assert hw.attn_step_s == hw.step_s
    h100 = HardwareSpec.h100()
    assert h100.attn_step_s != h100.step_s
    feat = InputFeatures.from_csr(_attn_graph("hub_skew"), 256, "attention")
    pool = registry.candidates(feat, h100, CPU, include_kernels=True)
    fused = {"fused_attention_cuda", "ragged_attention_cuda"}
    assert {v.name for v in pool} >= fused | {"pipe"}
    for v in pool:
        base = est.estimate(feat, h100, v.name, v.knobs)
        more = dataclasses.replace(h100, attn_step_s=2 * h100.attn_step_s)
        if v.name in fused:
            assert est.estimate(feat, more, v.name, v.knobs) > base, v.full_name()
        else:
            assert est.estimate(feat, more, v.name, v.knobs) == base, v.full_name()
        for kept in ("step_s", "sddmm_step_s"):
            other = dataclasses.replace(h100, **{kept: 2 * getattr(h100, kept)})
            if v.name in fused:
                assert est.estimate(feat, other, v.name, v.knobs) == base, (kept, v.name)


def test_h100_fused_attention_estimate_counts_live_cell_gathers():
    """The h100 profile models the CUDA attention kernels: one k and one v
    row gathered and one logit computed per live cell, where the CPU
    profiles keep the JAX package's whole-tile gathers per stored slot.
    The composed pipes' estimates do not depend on it."""
    for hw in (HardwareSpec.cpu(), HardwareSpec.cpu_wide()):
        assert not hw.attn_live_gathers
    h100 = HardwareSpec.h100()
    assert h100.attn_live_gathers
    whole_tile = dataclasses.replace(h100, attn_live_gathers=False)
    csr = _attn_graph("hub_skew")
    f = 256
    feat = InputFeatures.from_csr(csr, f, "attention")
    pool = registry.candidates(feat, h100, CPU, include_kernels=True)
    fused = {"fused_attention_cuda", "ragged_attention_cuda"}
    assert {v.name for v in pool} >= fused
    no_step = dataclasses.replace(h100, attn_step_s=0.0)
    for v in pool:
        base = est.estimate(feat, h100, v.name, v.knobs)
        if v.name not in fused:
            assert est.estimate(feat, whole_tile, v.name, v.knobs) == base, v.full_name()
            continue
        assert base < est.estimate(feat, whole_tile, v.name, v.knobs), v.name
        eff = est._block_ell_elems(feat, v.knobs, v.name == "ragged_attention_cuda", v.name)
        bytes_moved = (2 * csr.n_rows + 2 * csr.n_cols) * f * 4 + eff * 4 + csr.nnz * 2 * f * 4
        flops = 4.0 * csr.nnz * f + 8.0 * csr.nnz
        assert est.estimate(feat, no_step, v.name, v.knobs) == pytest.approx(
            max(bytes_moved / h100.hbm_bw, flops / h100.peak_flops), rel=1e-12), v.name


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the one for machines without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoSage(cache=ScheduleCache(path=None))
    assert AutoSage(cache=ScheduleCache(path=None), device="cpu").device == CPU


def test_entry_neutral_ranking_reads_as_a_jax_donor(tmp_path, probe_kernels):
    """A probed entry written by the port carries the neutral ranking the
    JAX package's transfer tier reads from a peer device class."""
    csr = hub_skew(1500, 4, 0.05, 150, seed=6)
    sage = _sage(str(tmp_path / "fleet.json"))
    d = sage.decide(csr, 48, "spmm")
    assert d.probe_ms
    entry = JxCache(path=str(tmp_path / "fleet.json")).get(sage.cache.keys_for_op("spmm")[0])
    base = registry.baseline(InputFeatures.from_csr(csr, 48, "spmm"), sage.hw, CPU)
    want = jx_transfer.build_ranking(d.probe_ms, d.estimates_ms, base.full_name())
    assert entry["neutral"]["ranking"] == want
    assert jx_transfer.ranking_of(entry, base.full_name()) == want
    assert [r["name"] for r in want][0] == min(d.probe_ms, key=d.probe_ms.get)


# ------------------------------------------------ pipeline-level attention
def _attn_graph(kind):
    if kind == "hub_skew":
        return hub_skew(300, 3, 0.1, 40, seed=2).dedup_edges()
    return erdos_renyi(300, 2e-2, seed=3).dedup_edges()  # balanced: row-ELL pipes apply


def _jx_attn_pool(feat, hw=None):
    return jx_registry.candidates(_jx_feat(feat), hw or JxHw.cpu(), include_pallas=True)


@pytest.mark.parametrize("kind", ["hub_skew", "erdos_renyi"])
def test_attention_candidates_and_estimates_match_jax(kind):
    """The attention pool is the JAX package's, variant for variant through
    PORTED_FROM, and each candidate is costed exactly as its twin under a
    shared roofline profile."""
    csr = _attn_graph(kind)
    feat = InputFeatures.from_csr(csr, 32, "attention")
    pool = registry.candidates(feat, HardwareSpec.cpu(), CPU, include_kernels=True)
    jx_pool = _jx_attn_pool(feat)
    assert [(registry.PORTED_FROM[v.name], v.knobs, v.is_baseline) for v in pool] == [
        (v.name, v.knobs, v.is_baseline) for v in jx_pool]
    assert {v.name for v in pool} >= {"pipe", "fused_attention_cuda", "ragged_attention_cuda"}
    if kind == "erdos_renyi":
        assert sum(v.name == "pipe" for v in pool) == 4
    for v, twin in zip(pool, jx_pool):
        mine = est.estimate(feat, HardwareSpec.cpu(), v.name, v.knobs)
        theirs = jx_est.estimate(_jx_feat(feat), JxHw.cpu(), twin.name, twin.knobs)
        assert mine == pytest.approx(theirs, rel=1e-12), v.full_name()
    base = registry.baseline(feat, HardwareSpec.cpu(), CPU)
    assert base.full_name() == jx_registry.baseline(_jx_feat(feat), JxHw.cpu()).full_name()


def test_attention_gates_duplicates_and_layout_budget():
    """Duplicate edges shut the fused kernels out, as in the JAX package;
    the fused memory gates compare against the profile's layout budget:
    512 MB on the CPU profile shuts them out of Reddit-0.25's features
    (58,241 rows, max degree 52,755, 27.8 M edges), the H100's admits
    them."""
    multi = hub_skew(300, 3, 0.1, 40, seed=2)
    feat = InputFeatures.from_csr(multi, 32, "attention")
    assert feat.dup_edges
    names = {v.name for v in registry.candidates(feat, HardwareSpec.cpu(), CPU, True)}
    assert names == {v.name for v in _jx_attn_pool(feat)} == {"pipe"}
    reddit = dataclasses.replace(
        InputFeatures.from_csr(_attn_graph("hub_skew"), 256, "attention"),
        n_rows=58_241, n_cols=58_241, nnz=27_777_678, avg_deg=477.0, deg_max=52_755.0,
    )
    assert HardwareSpec.cpu().layout_budget_bytes == 512e6
    assert {v.name for v in registry.candidates(reddit, HardwareSpec.cpu(), CPU, True)} == {
        v.name for v in _jx_attn_pool(reddit)} == {"pipe"}
    on_card = {v.name for v in registry.candidates(reddit, HardwareSpec.h100(), CPU, True)}
    assert on_card == {"pipe", "fused_attention_cuda", "ragged_attention_cuda"}


def test_decide_attention_then_replay(tmp_path, probe_kernels, monkeypatch):
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    csr = _attn_graph("hub_skew")
    path = str(tmp_path / "attn.json")
    sage = _sage(path)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
               for n in (csr.n_rows, csr.n_cols, csr.n_cols))
    out = api.attention(csr, q, k, v, sage=sage, differentiable=False)
    d = sage.decide_attention(csr, 16)
    assert d.from_cache and d.op == "attention"
    entry = sage.cache.get(sage.cache.keys_for_op("attention")[0])
    assert entry["op"] == "attention" and entry["probe_ms"]
    assert any("_cuda" in name for name in entry["estimates_ms"])
    exp = jx_ref.csr_attention_ref(csr.rowptr, csr.colind, q.numpy(), k.numpy(), v.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)
    replay = _sage(path, replay_only=True)
    d_r = replay.decide_attention(csr, 16)
    assert d_r.from_cache and d_r.choice == d.choice and not d_r.probe_ms
    with pytest.raises(ReplayMiss):
        replay.decide_attention(csr, 24)
    lines = (tmp_path / "telemetry" / "attention_decisions.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["from_cache"] for r in records] == [False, True, True]
    assert records[0]["choice"] == d.choice and records[0]["probe_ms"] == entry["probe_ms"]
    # gradients enabled: the forward replays, the backward ops are decided
    qg = q.clone().requires_grad_()
    api.attention(csr, qg, k, v, sage=sage).sum().backward()
    assert sage.cache.keys_for_op("attention_bwd_e") and torch.isfinite(qg.grad).all()


def test_attention_cache_entries_load_both_ways(tmp_path, probe_kernels):
    """op and stage_ms survive both directions: a port-written attention
    entry reads in the JAX package, and a JAX-written one replays here."""
    csr = _attn_graph("erdos_renyi")
    path = str(tmp_path / "port.json")
    d = _sage(path).decide_attention(csr, 16, stage_breakdown=True)
    assert d.stage_ms
    key = ScheduleCache(path=path).keys_for_op("attention")[0]
    jx = JxCache(path=path).get(key)
    assert jx["op"] == "attention" and jx["stage_ms"] == d.stage_ms
    assert jx["choice"] == d.choice and jx["schema"] == 6
    # the reverse: a JAX-layout entry pinning a composed pipe
    jpath = str(tmp_path / "jax.json")
    pipe = "pipe[sddmm=row_ell,spmm=gather_segsum]"
    JxCache(path=jpath).put(key, {"choice": pipe, "probe_ms": {}, "estimates_ms": {},
                                  "op": "attention", "stage_ms": {"sddmm": 1.5}})
    d_r = _sage(jpath, replay_only=True).decide_attention(csr, 16)
    assert d_r.choice == pipe and d_r.variant.full_name() == pipe
    assert d_r.stage_ms == {"sddmm": 1.5}


def test_span_totals_split_a_decide(tmp_path, probe_kernels, monkeypatch):
    """With AUTOSAGE_OBS set, the flight recorder's span totals split an
    attention decide into its stages; without it nothing is recorded."""
    from repro_torch.core import obs

    csr = _attn_graph("erdos_renyi")
    before = obs.span_totals_ms()
    _sage(str(tmp_path / "off.json")).decide_attention(csr, 16)
    assert obs.span_totals_ms() == before
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    _sage(str(tmp_path / "on.json")).decide_attention(csr, 16)
    after = obs.span_totals_ms()
    assert {"decide", "features", "estimate", "probe", "guardrail"} <= set(after)
    grew = {k: v - before.get(k, 0.0) for k, v in after.items()}
    assert grew["decide"] >= grew["probe"] > 0


# ------------------------------------------------ training (backward) ops
TRAIN_OPS = ["sddmm", "spmm_dyn", "spmm_bwd_b", "spmm_bwd_vals", "spmm_bwd_b_dyn",
             "sddmm_bwd_x", "sddmm_bwd_y", "attention_bwd_e", "attention_bwd_p",
             "attention_bwd_q", "attention_bwd_k", "attention_bwd_v"]


def _pool_pairs(feat, hw, jhw):
    pool = registry.candidates(feat, hw, CPU, include_kernels=True)
    jx_pool = [v for v in jx_registry.candidates(_jx_feat(feat), jhw, include_pallas=True)
               if v.knobs.get("f_tile", 128) == 128]
    return pool, jx_pool


@pytest.mark.parametrize("profile", ["cpu", "cpu_wide"])
@pytest.mark.parametrize("op", TRAIN_OPS)
def test_training_op_candidates_and_estimates_match_jax(op, profile):
    """Every training op's pool is the JAX package's, variant for variant
    through PORTED_FROM (the Pallas f_tile twins folded), with the same
    baseline, and each candidate is costed exactly as its twin; on a
    skewed graph (row-ELL gated out) and a balanced one. F <= 128, where
    a Pallas and a CUDA SpMM step both cover the whole feature tile."""
    hw, jhw = HardwareSpec.from_profile(profile), JxHw.from_profile(profile)
    for csr in (hub_skew(2000, 4, 0.05, 400, seed=2), erdos_renyi(800, 4e-3, seed=3)):
        for f in (16, 64, 128):
            feat = InputFeatures.from_csr(csr, f, op)
            pool, jx_pool = _pool_pairs(feat, hw, jhw)
            assert [(registry.PORTED_FROM[v.name], v.knobs, v.is_baseline) for v in pool] == [
                (v.name, {k: x for k, x in v.knobs.items() if k != "f_tile"}, v.is_baseline)
                for v in jx_pool]
            for v, twin in zip(pool, jx_pool):
                mine = est.estimate(feat, hw, v.name, v.knobs)
                theirs = jx_est.estimate(_jx_feat(feat), jhw, twin.name, twin.knobs)
                assert mine == pytest.approx(theirs, rel=1e-12), (op, f, v.full_name())
            base = registry.baseline(feat, hw, CPU)
            assert base.full_name() == jx_registry.baseline(_jx_feat(feat), jhw).full_name()
    # the SDDMM estimate has no per-F tile difference: equal at F = 256 too
    if op_kind_is_sddmm(op):
        feat = InputFeatures.from_csr(hub_skew(2000, 4, 0.05, 400, seed=2), 256, op)
        for v, twin in zip(*_pool_pairs(feat, hw, jhw)):
            assert est.estimate(feat, hw, v.name, v.knobs) == pytest.approx(
                jx_est.estimate(_jx_feat(feat), jhw, twin.name, twin.knobs), rel=1e-12)


def op_kind_is_sddmm(op):
    from repro_torch.core.features import op_kind

    return op_kind(op) == "sddmm"


def test_sddmm_gates_against_the_layout_budget():
    """At Reddit-0.25 (deduplicated) the 512 MB CPU budget shuts every
    block SDDMM family out, as in the JAX package; the H100's admits
    ragged and merge-path, while dense-W's n_rows * deg_max * bc * 4 =
    98.3 GB stays above it."""
    reddit = dataclasses.replace(
        InputFeatures.from_csr(hub_skew(300, 3, 0.1, 40, seed=2), 256, "attention_bwd_e"),
        n_rows=58_241, n_cols=58_241, nnz=27_777_678, avg_deg=477.0, deg_max=52_755.0,
    )
    names = {v.name for v in registry.candidates(reddit, HardwareSpec.cpu(), CPU, True)}
    assert names == {v.name for v in jx_registry.candidates(_jx_feat(reddit), JxHw.cpu(),
                                                            include_pallas=True)}
    assert names == {"gather_dot"}
    on_card = {v.full_name() for v in registry.candidates(reddit, HardwareSpec.h100(), CPU,
                                                          True)}
    assert {n.split("[")[0] for n in on_card} == {"gather_dot", "ragged_ell_cuda",
                                                  "merge_path_cuda"}
    assert len(on_card) == 5  # ragged 8x8 and 16x8, merge tile_slots 8 and 16


def _train_step_grad(api_mod, graph, b, sage):
    """Gradient of sum(spmm(graph, b)^2) w.r.t. b through the facade."""
    bt = torch.from_numpy(b).requires_grad_()
    (api_mod.spmm(graph, bt, sage=sage) ** 2).sum().backward()
    return bt.grad.numpy()


def test_backward_cache_entries_replay_in_both_packages(tmp_path, monkeypatch):
    """A JAX-written cache holding forward and backward keys replays in
    the port (same choices, same gradient), and a port-written one in the
    JAX package. Library-op pools on both sides, so every cached choice
    exists in both; the device part of the key is pinned to the port's
    with the JAX package's AUTOSAGE_DEVICE_SIG_OVERRIDE."""
    import jax
    import jax.numpy as jnp

    from repro import api as jx_api
    from repro.core import AutoSage as JxSage
    from repro.sparse import power_law as jx_power_law
    from repro_torch.core import device_sig
    from repro_torch.sparse import power_law

    g = power_law(300, 1.6, avg_deg=6.0, n_cols=200, seed=11)
    jg = jx_power_law(300, 1.6, avg_deg=6.0, n_cols=200, seed=11)
    b = np.random.default_rng(8).standard_normal((g.n_cols, 16)).astype(np.float32)
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", device_sig(CPU))

    def jx_grad(sage):
        return np.asarray(jax.grad(lambda b: (jx_api.spmm(jg, b, sage=sage) ** 2).sum())(
            jnp.asarray(b)))

    jpath = str(tmp_path / "jax.json")
    want = jx_grad(JxSage(cache=JxCache(path=jpath), probe_iters=2, probe_cap_ms=100))
    written = {k: e["choice"] for k, e in json.loads(open(jpath).read()).items()}
    assert {k.split("|")[3] for k in written} == {"spmm", "spmm_bwd_b"}
    port = AutoSage(cache=ScheduleCache(path=jpath, replay_only=True), device="cpu")
    np.testing.assert_allclose(_train_step_grad(api, g, b, port), want, rtol=1e-4, atol=1e-4)
    for key, choice in written.items():
        _, _, f, op, _ = key.split("|")
        graph = g if op == "spmm" else g.transpose()
        assert port.decide(graph, int(f[2:]), op).choice == choice

    ppath = str(tmp_path / "port.json")
    got = _train_step_grad(api, g, b, _sage(ppath))
    port_written = {k: e["choice"] for k, e in json.loads(open(ppath).read()).items()}
    assert set(port_written) == set(written)
    replay = JxSage(cache=JxCache(path=ppath, replay_only=True))
    np.testing.assert_allclose(jx_grad(replay), got, rtol=1e-4, atol=1e-4)
    assert {k: e["choice"] for k, e in json.loads(open(ppath).read()).items()} == port_written


# ----------------------------------------- the legacy "csr_attention" op
@pytest.mark.parametrize("pallas", [False, True], ids=["library", "kernels"])
def test_legacy_csr_attention_candidates_and_decision_match_jax(pallas, monkeypatch):
    """The legacy per-op op draws the attention pool, variant for variant
    the JAX package's; its estimate branch costs none of them in either
    package (KeyError), so both decide the baseline through the decide
    rescue: empty estimates, tier "fault", nothing cached."""
    from repro.core import AutoSage as JxSage
    from repro.core import obs as jx_obs
    from repro.sparse import hub_skew as jx_hub_skew
    from repro_torch.core import obs

    if pallas:
        monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    else:
        monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    csr = hub_skew(300, 4, 0.1, 20, seed=0).dedup_edges()
    jcsr = jx_hub_skew(300, 4, 0.1, 20, seed=0).dedup_edges()
    feat = InputFeatures.from_csr(csr, 32, "csr_attention")
    pool = registry.candidates(feat, HardwareSpec.cpu(), CPU)
    jx_pool = jx_registry.candidates(_jx_feat(feat), JxHw.cpu(), include_pallas=pallas)
    assert [(registry.PORTED_FROM[v.name], v.knobs, v.is_baseline) for v in pool] == [
        (v.name, v.knobs, v.is_baseline) for v in jx_pool]
    assert len(pool) == (6 if pallas else 4)
    for v, twin in zip(pool, jx_pool):
        with pytest.raises(KeyError):
            est.estimate(feat, HardwareSpec.cpu(), v.name, v.knobs)
        with pytest.raises(KeyError):
            jx_est.estimate(_jx_feat(feat), JxHw.cpu(), twin.name, twin.knobs)
    labels = dict(op="csr_attention", scheduler="exact", tier="fault")
    before, jbefore = (obs.REGISTRY.total("autosage_decides_total", **labels),
                       jx_obs.REGISTRY.total("autosage_decides_total", **labels))
    sage = AutoSage(cache=ScheduleCache(path=None), device="cpu", probe_iters=1,
                    probe_cap_ms=50)
    jsage = JxSage(cache=JxCache(path=None), probe_iters=1, probe_cap_ms=50)
    d, jd = sage.decide(csr, 32, "csr_attention"), jsage.decide(jcsr, 32, "csr_attention")
    assert (d.choice, d.estimates_ms, d.from_cache) == (jd.choice, jd.estimates_ms,
                                                        jd.from_cache) == ("baseline", {},
                                                                           False)
    assert d.variant.full_name() == jd.variant.full_name() == \
        "pipe[sddmm=gather_dot,spmm=gather_segsum]"
    assert obs.REGISTRY.total("autosage_decides_total", **labels) == before + 1
    assert jx_obs.REGISTRY.total("autosage_decides_total", **labels) == jbefore + 1
    assert len(sage.cache) == len(jsage.cache) == 0
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (csr.n_rows, 32)).astype(np.float32)) for i in range(3))
    out = sage.build_runner(csr, d)(q, k, v)
    want = jx_ref.csr_attention_ref(csr.rowptr, csr.colind, *(x.numpy() for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_legacy_csr_attention_pinned_fused_entry_replays(tmp_path, probe_kernels):
    """A cache entry under a legacy key that pins a fused kernel is
    constructible: replay serves it and its runner matches the oracle
    (the plain version here; the CUDA kernel on the card)."""
    csr = hub_skew(300, 4, 0.1, 20, seed=0).dedup_edges()
    feat = InputFeatures.from_csr(csr, 32, "csr_attention")
    name = next(v.full_name() for v in registry.candidates(feat, HardwareSpec.cpu(), CPU)
                if v.name == "ragged_attention_cuda")
    path = str(tmp_path / "legacy.json")
    from repro_torch.core import device_sig

    ScheduleCache(path=path).put(
        ScheduleCache.key(device_sig(CPU), feat.graph_sig, 32, "csr_attention", 0.95),
        {"choice": name, "probe_ms": {}, "estimates_ms": {}})
    replay = _sage(path, replay_only=True)
    d = replay.decide(csr, 32, "csr_attention")
    assert d.from_cache and d.choice == name and d.variant.name == "ragged_attention_cuda"
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (csr.n_rows, 32)).astype(np.float32)) for i in range(3))
    want = jx_ref.csr_attention_ref(csr.rowptr, csr.colind, *(x.numpy() for x in (q, k, v)))
    np.testing.assert_allclose(replay.build_runner(csr, d)(q, k, v).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
