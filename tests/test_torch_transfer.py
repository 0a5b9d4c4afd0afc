"""repro_torch's cross-device decision transfer on the CPU: the twin of
tests/test_transfer.py, held against the JAX package.

- Plan level: the re-rank and calibration invariants on handcrafted
  donor entries, as in the JAX file.
- Parity: `plan_transfer` and `best_plan` give the same choice,
  ``confident`` flag, agreement and predicted ms as the JAX package's on
  the same donor entry (rtol 1e-9; the `cpu` and `cpu_wide` profiles
  cost every port variant exactly as its JAX family), with library
  names and with the JAX package's Pallas names, which the port maps to
  its own through ``registry.PORTED_FROM``.
- A cache written by the JAX package (its CPU probes of the Pallas
  variants in interpret mode) is the donor of the port's decide.
- The device-signature override and the batch scheduler's transfer
  tier (confident zero-probe accepts, budgeted confirm-or-flip probes,
  replay, exact-key transfer, telemetry).

Every BatchScheduler here probes through a fixed per-family timer
(monkeypatched in the test only), so no verdict depends on wall-clock
probes; numbers that come from estimates are compared at rtol 1e-9.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import AutoSage as JxSage
from repro.core import ScheduleCache as JxCache
from repro.core import probe as jx_probe
from repro.core import registry as jx_registry
from repro.core import transfer as jx_transfer
from repro.core.features import HardwareSpec as JxHw
from repro.core.features import InputFeatures as JxFeat
from repro.sparse import fixed_degree as jx_fixed_degree
from repro_torch.core import (
    AutoSage,
    BatchScheduler,
    HardwareSpec,
    InputFeatures,
    ScheduleCache,
    device_sig,
    features_from_neutral,
    registry,
    telemetry,
)
from repro_torch.core import probe as probe_mod
from repro_torch.core import transfer as transfer_mod
from repro_torch.kernels import ref
from repro_torch.sparse import fixed_degree, hub_skew, sample_subgraph_stream

torch.set_num_threads(1)  # see test_torch_spmm.py

F = 16
ALPHA = 0.95
CPU = torch.device("cpu")


@dataclasses.dataclass
class _FakeVariant:
    """Just enough Variant surface for plan_transfer: a real estimate-
    model name plus knobs, so local re-estimation is exact and the probe
    numbers of the donor entry can be handcrafted."""

    name: str
    knobs: dict = dataclasses.field(default_factory=dict)

    def full_name(self) -> str:
        if not self.knobs:
            return self.name
        ks = ",".join(f"{k}={v}" for k, v in sorted(self.knobs.items()))
        return f"{self.name}[{ks}]"


def _feat(seed=0, n=1024, deg=12) -> InputFeatures:
    return InputFeatures.from_csr(fixed_degree(n, deg, seed=seed), F, "spmm")


def _entry(ranking, choice, probed_at=100.0):
    return {"choice": choice, "probed": True, "neutral": {"ranking": ranking},
            "stats": {"probed_at": probed_at, "probes": 1}}


def _names():
    base = _FakeVariant("gather_segsum")
    a = _FakeVariant("row_ell")
    b = _FakeVariant("hub_split_ell", {"hub_threshold": 24})
    return base, a, b, {a.full_name(): a, b.full_name(): b}


def _est(feat, hw, v):
    return transfer_mod.est_mod.estimates_for(feat, hw, [v]).popitem()[1]


# ------------------------------------------------------------ plan level
def test_same_roofline_transfer_reproduces_peer_ranking():
    feat, hw = _feat(), HardwareSpec.cpu()
    base, a, b, by_name = _names()
    ranking = [
        {"name": b.full_name(), "probe_ms": 1.0, "est_ms": _est(feat, hw, b)},
        {"name": a.full_name(), "probe_ms": 2.0, "est_ms": _est(feat, hw, a)},
        {"name": "baseline", "probe_ms": 5.0, "est_ms": _est(feat, hw, base)},
    ]
    plan = transfer_mod.plan_transfer(
        "bucket|peer|r10.z13.s0.d-2.w0.simple|F=16|spmm|a=0.95",
        _entry(ranking, b.full_name()), feat, hw, by_name, base, ALPHA,
    )
    assert plan.choice == b.full_name() and plan.top1_agrees
    assert plan.rank_agreement == 1.0 and plan.source_device == "peer"
    np.testing.assert_allclose(plan.predicted_ms[b.full_name()], 1.0)
    np.testing.assert_allclose(plan.predicted_ms["baseline"], 5.0)


def test_unit_residuals_rerank_by_local_roofline():
    feat, hw = _feat(), HardwareSpec.cpu()
    base, a, b, by_name = _names()
    local_best = a if _est(feat, hw, a) < _est(feat, hw, b) else b
    local_worst = b if local_best is a else a
    ranking = [
        {"name": local_worst.full_name(), "probe_ms": 1.0, "est_ms": 1.0},
        {"name": local_best.full_name(), "probe_ms": 2.0, "est_ms": 2.0},
        {"name": "baseline", "probe_ms": 50.0, "est_ms": 50.0},
    ]
    plan = transfer_mod.plan_transfer(
        "k|peer|sig|F=16|spmm|a=0.95", _entry(ranking, local_worst.full_name()),
        feat, hw, by_name, base, ALPHA,
    )
    assert plan.choice == local_best.full_name()
    assert not plan.top1_agrees and not plan.confident


def test_predicted_space_guardrail_falls_back_to_baseline():
    feat, hw = _feat(), HardwareSpec.cpu()
    base, a, _, by_name = _names()
    ranking = [
        {"name": "baseline", "probe_ms": 1.0, "est_ms": 1.0},
        {"name": a.full_name(), "probe_ms": 100.0, "est_ms": 1.0},
    ]
    plan = transfer_mod.plan_transfer(
        "k|peer|sig|F=16|spmm|a=0.95", _entry(ranking, "baseline"),
        feat, hw, by_name, base, ALPHA,
    )
    assert plan.choice == "baseline" and not plan.guardrail.accepted and plan.top1_agrees


def test_unconstructible_candidates_skipped():
    feat, hw = _feat(), HardwareSpec.cpu()
    base, a, _, by_name = _names()
    ranking = [
        {"name": "imaginary_pallas[z=1]", "probe_ms": 0.1, "est_ms": 0.1},
        {"name": a.full_name(), "probe_ms": 1.0, "est_ms": 1.0},
        {"name": "baseline", "probe_ms": 5.0, "est_ms": 5.0},
    ]
    plan = transfer_mod.plan_transfer(
        "k|peer|sig|F=16|spmm|a=0.95", _entry(ranking, "imaginary_pallas[z=1]"),
        feat, hw, by_name, base, ALPHA,
    )
    assert "imaginary_pallas[z=1]" in plan.skipped
    assert plan.choice == a.full_name()


def test_v4_entry_without_neutral_synthesizes_ranking():
    base, a, _, _ = _names()
    entry = {
        "choice": a.full_name(),
        "probe_ms": {"baseline": 4.0, a.full_name(): 1.0},
        "estimates_ms": {base.full_name(): 3.5, a.full_name(): 0.9},
    }
    ranking = transfer_mod.ranking_of(entry, base.full_name())
    assert [r["name"] for r in ranking] == [a.full_name(), "baseline"]
    assert ranking[1]["est_ms"] == 3.5


def test_never_probed_entry_donates_nothing():
    base = _names()[0]
    assert transfer_mod.ranking_of({"choice": "baseline"}, base.full_name()) == []
    assert transfer_mod.plan_transfer(
        "k|peer|sig|F=16|spmm|a=0.95", {"choice": "baseline", "probe_ms": {}},
        _feat(), HardwareSpec.cpu(), {}, base, ALPHA) is None


def test_confirm_margin_controls_confidence(monkeypatch):
    feat, hw = _feat(), HardwareSpec.cpu()
    base, a, _, by_name = _names()
    entry = _entry([{"name": a.full_name(), "probe_ms": 1.0, "est_ms": 1.0},
                    {"name": "baseline", "probe_ms": 5.0, "est_ms": 5.0}], a.full_name())
    key = "k|peer|sig|F=16|spmm|a=0.95"
    assert transfer_mod.plan_transfer(key, entry, feat, hw, by_name, base, ALPHA,
                                      margin=1.0).confident
    strict = transfer_mod.plan_transfer(key, entry, feat, hw, by_name, base, ALPHA,
                                        margin=1e9)
    assert strict.top1_agrees and not strict.confident
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1e9")
    assert not transfer_mod.plan_transfer(key, entry, feat, hw, by_name, base,
                                          ALPHA).confident


def test_peer_entries_match_regime_modulo_device(tmp_path):
    c = ScheduleCache(path=str(tmp_path / "c.json"))
    sig = "r10.z13.s0.d-2.w0.simple"
    key = ScheduleCache.bucket_key("devB", sig, 16, "spmm", 0.95)
    same = ScheduleCache.bucket_key("devA", sig, 16, "spmm", 0.95)
    newer = ScheduleCache.bucket_key("devC", sig, 16, "spmm", 0.95)
    for k, e in ((same, {"choice": "x", "stats": {"probed_at": 1.0}}),
                 (newer, {"choice": "y", "stats": {"probed_at": 2.0}}),
                 (ScheduleCache.bucket_key("devA", sig, 32, "spmm", 0.95), {"choice": "x"}),
                 (ScheduleCache.bucket_key("devA", sig, 16, "spmm", 0.98), {"choice": "x"}),
                 (ScheduleCache.key("devA", sig, 16, "spmm", 0.95), {"choice": "x"}),
                 (ScheduleCache.quarantine_key("devA", "x"), {"choice": "x"}),
                 (key, {"choice": "self"})):
        c.put(k, e)
    assert [k for k, _ in c.peer_entries(key)] == [newer, same]  # freshest first


# ------------------------------------------------ against the JAX package
def test_local_name_maps_every_ported_family():
    for name, jax_family in registry.PORTED_FROM.items():
        assert transfer_mod.local_name(f"{jax_family}[bc=8,rb=8]") == f"{name}[bc=8,rb=8]"
        assert transfer_mod.local_name(name) == name
    assert (transfer_mod.local_name("ragged_ell_pallas[bc=8,f_tile=256,ragged=True,rb=8]")
            == "ragged_ell_cuda[bc=8,ragged=True,rb=8]")
    assert transfer_mod.local_name("baseline") == "baseline"
    assert transfer_mod.local_name("imaginary_pallas[z=1]") == "imaginary_pallas[z=1]"


def test_two_jax_tiles_map_to_one_port_variant_the_faster_stands(monkeypatch):
    """JAX's SpMM kernels carry an f_tile knob the port's do not: both
    tiles of one blocking map to the port's one variant, whose residual
    comes from the faster probe."""
    (feat, hw, by_name, base), _ = _pools("cpu", True, monkeypatch)
    name = "ragged_ell_cuda[bc=8,ragged=True,rb=8]"
    ranking = [
        {"name": "ragged_ell_pallas[bc=8,f_tile=128,ragged=True,rb=8]", "probe_ms": 1.0,
         "est_ms": 2.0},
        {"name": "ragged_ell_pallas[bc=8,f_tile=256,ragged=True,rb=8]", "probe_ms": 3.0,
         "est_ms": 2.0},
        {"name": "baseline", "probe_ms": 9.0, "est_ms": 9.0},
    ]
    plan = transfer_mod.plan_transfer("k|jax|s|F=64|spmm|a=0.95",
                                      _entry(ranking, ranking[0]["name"]), feat, hw,
                                      by_name, base, ALPHA)
    assert plan.residuals[name] == 0.5 and plan.skipped == []
    assert plan.peer_choice == name and set(plan.predicted_ms) == {name, "baseline"}


def _pools(profile, pallas, monkeypatch, graph=("fixed", 1024, 12), f=64):
    """(feat, hw, by_name, base) of each package for one graph; JAX's
    Pallas SpMM pool cut to f_tile 128, the tile the port's kernels use
    at F <= 128, so the two pools pair one to one."""
    if pallas:
        monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    else:
        monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS", raising=False)
    _, n, deg = graph
    g, jg = fixed_degree(n, deg, seed=3), jx_fixed_degree(n, deg, seed=3)
    feat, jfeat = InputFeatures.from_csr(g, f, "spmm"), JxFeat.from_csr(jg, f, "spmm")
    hw, jhw = HardwareSpec.from_profile(profile), JxHw.from_profile(profile)
    cands = registry.candidates(feat, hw, CPU)
    jcands = [v for v in jx_registry.candidates(jfeat, jhw) if v.knobs.get("f_tile", 128) == 128]
    by_name = {v.full_name(): v for v in cands}
    jby_name = {v.full_name(): v for v in jcands}
    return ((feat, hw, by_name, registry.baseline(feat, hw, CPU)),
            (jfeat, jhw, jby_name, jx_registry.baseline(jfeat, jhw)))


def _donor(jby_name, jbase, jfeat, jhw, seed):
    """A JAX-side donor entry over every JAX candidate: seeded probe ms,
    estimates from the JAX model under the donor's profile."""
    rng = np.random.default_rng(seed)
    est = jx_transfer.est_mod.estimates_for(jfeat, jhw, list(jby_name.values()) + [jbase])
    probe = {"baseline": float(rng.uniform(1, 10))}
    probe.update({n: float(rng.uniform(0.5, 12)) for n in jby_name})
    choice = min(probe, key=probe.get)
    return {"choice": choice, "probed": True, "probe_ms": probe, "estimates_ms": est,
            "neutral": {"ranking": jx_transfer.build_ranking(probe, est, jbase.full_name())},
            "stats": {"probed_at": 5.0}}


@pytest.mark.parametrize("pallas", [False, True], ids=["library", "pallas-names"])
@pytest.mark.parametrize("profiles", [("cpu", "cpu_wide"), ("cpu_wide", "cpu")])
@pytest.mark.parametrize("seed", range(4))
def test_plan_and_best_plan_equal_jax(pallas, profiles, seed, monkeypatch):
    """Same donor entry (written with the JAX package's names), same
    local profile: the port's plan equals JAX's, names mapped."""
    donor_profile, local_profile = profiles
    (feat, hw, by_name, base), (jfeat, jhw, jby_name, jbase) = _pools(
        local_profile, pallas, monkeypatch)
    entry = _donor(jby_name, jbase, jfeat, JxHw.from_profile(donor_profile), seed)
    key = "bucket|jax-dev|sig|F=64|spmm|a=0.95"
    for margin in (None, 1.0):
        plan = transfer_mod.plan_transfer(key, entry, feat, hw, by_name, base, ALPHA,
                                          margin=margin)
        jplan = jx_transfer.plan_transfer(key, entry, jfeat, jhw, jby_name, jbase, ALPHA,
                                          margin=margin)
        assert plan.choice == transfer_mod.local_name(jplan.choice)
        assert plan.peer_choice == transfer_mod.local_name(jplan.peer_choice)
        assert (plan.confident, plan.top1_agrees, plan.skipped) == (
            jplan.confident, jplan.top1_agrees, jplan.skipped)
        np.testing.assert_allclose(plan.rank_agreement, jplan.rank_agreement, rtol=1e-9)
        jpred = {transfer_mod.local_name(n): v for n, v in jplan.predicted_ms.items()}
        assert set(plan.predicted_ms) == set(jpred)
        for n, v in plan.predicted_ms.items():
            np.testing.assert_allclose(v, jpred[n], rtol=1e-9)
        assert plan.guardrail.accepted == jplan.guardrail.accepted
    peers = [("bucket|other|sig|F=64|spmm|a=0.95", {"choice": "x"}), (key, entry)]
    best = transfer_mod.best_plan(peers, feat, hw, by_name, base, ALPHA)
    jbest = jx_transfer.best_plan(peers, jfeat, jhw, jby_name, jbase, ALPHA)
    assert best.source_key == jbest.source_key == key
    assert best.choice == transfer_mod.local_name(jbest.choice)
    assert best.confident == jbest.confident


def test_quarantined_names_are_skipped_like_jax(monkeypatch):
    (feat, hw, by_name, base), (jfeat, jhw, jby_name, jbase) = _pools("cpu", True, monkeypatch)
    entry = _donor(jby_name, jbase, jfeat, jhw, 7)
    out = {n for n in entry["probe_ms"] if n != "baseline"}
    jx_out = sorted(out)[:2]
    plan = transfer_mod.plan_transfer(
        "k|jax|s|F=64|spmm|a=0.95", entry, feat, hw, by_name, base, ALPHA,
        excluded={transfer_mod.local_name(n) for n in jx_out})
    jplan = jx_transfer.plan_transfer(
        "k|jax|s|F=64|spmm|a=0.95", entry, jfeat, jhw, jby_name, jbase, ALPHA,
        excluded=set(jx_out))
    assert sorted(plan.skipped) == sorted(transfer_mod.local_name(n) for n in jplan.skipped)
    assert plan.choice == transfer_mod.local_name(jplan.choice)


def _fixed_timer(fn, device, iters=1, cap_ms=0.0, name="?"):
    ms = _FAMILY_MS.get(name.split("[")[0], 6.0)
    return probe_mod.ProbeResult(name, ms, [ms], 1, False)


def _jx_fixed_timer(fn, iters=1, cap_ms=0.0, name="?"):
    ms = _FAMILY_MS.get(name.split("[")[0], 6.0)
    return jx_probe.ProbeResult(name, ms, [ms], 1, False)


# fixed per-family probe costs: a JAX Pallas family and its port
# counterpart cost the same
_FAMILY_MS = {"gather_segsum": 10.0, "dense": 8.0, "row_ell": 3.0, "hub_split_ell": 5.0,
              "ragged_ell_pallas": 2.0, "ragged_ell_cuda": 2.0,
              "block_ell_pallas": 4.0, "block_ell_cuda": 4.0,
              "merge_path_pallas": 2.5, "merge_path_cuda": 2.5}


@pytest.fixture
def fixed_probe(monkeypatch):
    monkeypatch.setattr(probe_mod, "time_callable", _fixed_timer)
    monkeypatch.setattr(jx_probe, "time_callable", _jx_fixed_timer)


def test_jax_written_donor_transfers_through_ported_from(tmp_path, monkeypatch, fixed_probe):
    """The JAX package decides on its CPU (Pallas variants in the pool,
    AUTOSAGE_PROBE_PALLAS=1) and writes the file; the port, as another
    device class, re-ranks that entry with every Pallas name mapped and
    nothing skipped, and its plan equals JAX's own re-rank of the entry
    under the port's profile."""
    path, f = str(tmp_path / "fleet.json"), 64  # Pallas SpMM applies from F = 32
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", "cpu")
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "jax-cpu")
    jg = jx_fixed_degree(1024, 12, seed=5)
    jsage = JxSage(cache=JxCache(path=path), probe_iters=1, probe_cap_ms=25, probe_frac=0.25)
    jd = jsage.decide(jg, f, "spmm")
    assert jd.probe_ms and any("_pallas" in n for n in jd.probe_ms)
    jsage.cache.flush()

    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "torch-cpu")
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", "cpu_wide")
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1.0")
    g = fixed_degree(1024, 12, seed=5)
    sage = AutoSage(cache=ScheduleCache(path=path), device="cpu", probe_iters=1,
                    probe_cap_ms=25, probe_frac=0.25)
    feat = InputFeatures.from_csr(g, f, "spmm")
    key = ScheduleCache.key("torch-cpu", feat.graph_sig, f, "spmm", sage.alpha)
    (peer_key, entry), = sage.cache.peer_entries(key)
    assert peer_key.startswith("jax-cpu|")
    cands = registry.candidates(feat, sage.hw, CPU)
    by_name = {v.full_name(): v for v in cands}
    base = registry.baseline(feat, sage.hw, CPU)
    plan = transfer_mod.plan_transfer(peer_key, entry, feat, sage.hw, by_name, base, ALPHA)
    jfeat = JxFeat.from_csr(jg, f, "spmm")
    jcands = jx_registry.candidates(jfeat, JxHw.cpu_wide())
    jplan = jx_transfer.plan_transfer(
        peer_key, entry, jfeat, JxHw.cpu_wide(), {v.full_name(): v for v in jcands},
        jx_registry.baseline(jfeat, JxHw.cpu_wide()), ALPHA)
    assert plan.skipped == [] and all("_pallas" not in n for n in plan.predicted_ms)
    assert plan.choice == transfer_mod.local_name(jplan.choice)
    assert plan.confident == jplan.confident
    for n, v in jplan.predicted_ms.items():
        np.testing.assert_allclose(plan.predicted_ms[transfer_mod.local_name(n)], v,
                                   rtol=1e-9)
    d = sage.decide(g, f, "spmm")
    assert d.transfer["source_device"] == "jax-cpu"
    assert d.transfer["peer_choice"] == transfer_mod.local_name(jd.choice)
    if d.transfer["verdict"] == "confirmed" and not d.probe_ms:
        assert d.choice == plan.choice  # served as planned, zero probes
    want = ref.spmm_ref(torch.from_numpy(g.rowptr), torch.from_numpy(g.colind), None,
                        torch.ones(g.n_cols, f))
    np.testing.assert_allclose(sage.build_runner(g, d)(torch.ones(g.n_cols, f)).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


def test_device_sig_override(monkeypatch):
    monkeypatch.delenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", raising=False)
    real = device_sig(CPU)
    assert real.count(":") >= 2  # platform:kind:torch<version>
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "sim-x")
    assert device_sig(CPU) == "sim-x"
    monkeypatch.delenv("AUTOSAGE_DEVICE_SIG_OVERRIDE")
    assert device_sig(CPU) == real


def test_hw_profile_override(monkeypatch):
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", "cpu_wide")
    hw = HardwareSpec.current(CPU)
    assert hw.name == "cpu_wide" and hw.hbm_bw > HardwareSpec.cpu().hbm_bw
    with pytest.raises(KeyError):
        HardwareSpec.from_profile("not-a-profile")


def test_neutral_features_roundtrip():
    feat = _feat()
    neutral = feat.to_neutral()
    assert json.loads(json.dumps(neutral)) == neutral
    assert features_from_neutral(neutral) == feat
    assert features_from_neutral({**neutral, "future_field": 1}) == feat
    with pytest.raises(ValueError):
        features_from_neutral({"n_rows": 4})


# ------------------------------------------------- scheduler integration
def _tiny_sage(path=None, **kw):
    return AutoSage(cache=ScheduleCache(path=path, **kw), device="cpu", probe_iters=1,
                    probe_cap_ms=25, probe_frac=0.25)


def _stream(n=6, seed=4):
    parents = [fixed_degree(2048, 12, seed=1), fixed_degree(2048, 48, seed=2),
               hub_skew(2048, 6, 0.10, 60, seed=3)]
    return sample_subgraph_stream(parents, n, rows_per_graph=256, seed=seed)


def _warm_peer(monkeypatch, path, sig="simA", profile="cpu", stream=None):
    """Finalize a device-A BatchScheduler over the stream into ``path``."""
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", sig)
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", profile)
    with BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000) as bs:
        for g in stream or _stream():
            bs.decide(g, F, "spmm")
    assert bs.stats()["probes_run"] >= 1
    return bs


def _as_device_b(monkeypatch, sig="simB", profile="cpu_wide"):
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", sig)
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", profile)


def test_batch_transfer_tier_beats_cold_start(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(8)
    cold_probes = _warm_peer(monkeypatch, path, stream=stream).stats()["probes_run"]
    _as_device_b(monkeypatch)
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs.decide(g, F, "spmm")
    bs.finalize()
    s = bs.stats()
    assert s["transfers"] >= 1 and s["probes_run"] < cold_probes
    assert s["transfers_pending"] == 0
    assert s["transfers_confirmed"] + s["transfers_flipped"] == s["transfers"]
    assert any(ev["source"] in ("transfer", "transfer-pending") for ev in bs.trace)


def test_confident_transfer_costs_zero_probes(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1.0")
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs.decide(g, F, "spmm")
    bs.finalize()
    s = bs.stats()
    assert 1 <= s["transfer_probe_free"] <= s["transfers_confirmed"]
    assert s["probes_run"] + s["transfer_probe_free"] <= s["buckets"]


def test_pending_transfer_confirmed_or_flipped_by_one_budgeted_probe(
        monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1e9")
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs.decide(g, F, "spmm")
    bs.finalize()
    s = bs.stats()
    assert s["transfers"] >= 1 and s["transfer_probe_free"] == 0
    assert s["probes_run"] == s["buckets"]
    assert s["transfers_confirmed"] + s["transfers_flipped"] == s["transfers"]
    for row in bs.bucket_stats():
        if row["transferred"]:
            assert row["transfer_verdict"] in ("confirmed", "flipped")
            assert row["transfer_source"] == "simA"


def test_zero_budget_pending_transfer_keeps_serving_prediction(
        monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1e9")
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=0.0)
    for g in stream:
        d = bs.decide(g, F, "spmm")
        assert d.transfer is not None or d.choice == "baseline"
    bs.finalize()
    s = bs.stats()
    assert s["probes_run"] == 0 and s["transfers"] >= 1
    assert s["transfers_pending"] == s["transfers"]
    assert {ev["source"] for ev in bs.trace} <= {"transfer-pending", "provisional"}


def test_transferred_decisions_replay_bit_identically(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(8)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    choices = [bs.decide(g, F, "spmm").choice for g in stream]
    bs.finalize()

    def replay():
        rbs = BatchScheduler(AutoSage(cache=ScheduleCache(path=path, replay_only=True),
                                      device="cpu"))
        out = [rbs.decide(g, F, "spmm").choice for g in stream]
        assert rbs.stats()["probes_run"] == 0
        return out

    assert replay() == choices == replay()


def test_warm_reopen_adopts_confirmed_transfer(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1.0")
    bs1 = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs1.decide(g, F, "spmm")
    bs1.finalize()
    assert bs1.stats()["transfer_probe_free"] >= 1
    bs2 = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs2.decide(g, F, "spmm")
    s2 = bs2.stats()
    assert s2["probes_run"] == 0 and s2["transfers"] == 0
    assert s2["warm_cache_opens"] == s2["buckets"]


def test_exact_key_transfer_in_autosage_decide(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "exact.json")
    csr = fixed_degree(1024, 12, seed=5)
    monkeypatch.setenv("AUTOSAGE_DEVICE_SIG_OVERRIDE", "simA")
    monkeypatch.setenv("AUTOSAGE_HW_PROFILE", "cpu")
    a = _tiny_sage(path)
    assert a.decide(csr, F, "spmm").probe_ms
    a.cache.flush()
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER_MARGIN", "1.0")
    b = _tiny_sage(path)
    db = b.decide(csr, F, "spmm")
    assert db.transfer is not None and db.transfer["source_device"] == "simA"
    if db.transfer["verdict"] == "confirmed" and not db.probe_ms:
        key = ScheduleCache.key(device_sig(CPU), InputFeatures.from_csr(csr, F, "spmm")
                                .graph_sig, F, "spmm", b.alpha)
        entry = b.cache.get(key)
        assert entry["transfer"]["source_device"] == "simA" and entry["probed"] is False
    db2 = b.decide(csr, F, "spmm")
    assert db2.from_cache and db2.choice == db.choice


def test_transfer_disabled_by_env(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    a = _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    monkeypatch.setenv("AUTOSAGE_TRANSFER", "0")
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    for g in stream:
        bs.decide(g, F, "spmm")
    bs.finalize()
    s = bs.stats()
    assert s["transfers"] == 0 and s["probes_run"] == a.stats()["probes_run"]


def test_transferred_spmm_matches_oracle(monkeypatch, tmp_path, fixed_probe):
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    _warm_peer(monkeypatch, path, stream=stream)
    _as_device_b(monkeypatch)
    bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
    rng = np.random.default_rng(0)
    for g in stream[:3]:
        b_mat = torch.from_numpy(rng.standard_normal((g.n_cols, F)).astype(np.float32))
        out, d = bs.spmm(g, b_mat)
        exp = ref.spmm_ref(torch.from_numpy(g.rowptr), torch.from_numpy(g.colind), None, b_mat)
        np.testing.assert_allclose(out.numpy(), exp.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=f"transferred choice {d.choice}")
    assert bs.stats()["transfers"] >= 1


def test_decide_events_record_transfer_provenance(monkeypatch, tmp_path, fixed_probe):
    tele = tmp_path / "tele"
    monkeypatch.setenv("AUTOSAGE_TELEMETRY_DIR", str(tele))
    path = str(tmp_path / "fleet.json")
    stream = _stream(6)
    try:
        _warm_peer(monkeypatch, path, stream=stream)
        _as_device_b(monkeypatch)
        bs = BatchScheduler(_tiny_sage(path), probe_budget_ms=10_000)
        for g in stream:
            bs.decide(g, F, "spmm")
        bs.finalize()
        assert bs.stats()["transfers"] >= 1
    finally:
        telemetry.close_streams()
    events = [json.loads(line) for line in
              (tele / "decide_events.jsonl").read_text().splitlines()]
    transfers = [e for e in events if e["kind"] == "transfer"]
    assert transfers
    for e in transfers:
        assert e["transfer"]["source_device"] == "simA"
        assert e["transfer"]["verdict"] in ("confirmed", "pending", "flipped")
        assert 0.0 <= e["transfer"]["rank_agreement"] <= 1.0


def test_v5_entry_carries_neutral_ranking(tmp_path):
    sage = _tiny_sage(str(tmp_path / "c.json"))
    csr = fixed_degree(1024, 12, seed=6)
    d = sage.decide(csr, F, "spmm")
    assert d.probe_ms
    key = ScheduleCache.key(device_sig(CPU), InputFeatures.from_csr(csr, F, "spmm").graph_sig,
                            F, "spmm", sage.alpha)
    neutral = sage.cache.get(key)["neutral"]
    assert neutral["op"] == "spmm" and neutral["f"] == F
    assert features_from_neutral(neutral["features"]).nnz == csr.nnz
    names = [r["name"] for r in neutral["ranking"]]
    assert "baseline" in names and set(names) == set(d.probe_ms)
    for r in neutral["ranking"]:
        assert r["probe_ms"] > 0 and r["est_ms"] is not None and r["est_ms"] > 0
