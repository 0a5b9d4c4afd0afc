"""Grouped query heads through CSR attention, on the CPU.

`api.attention` takes q (n, H, D) with k and v (n_cols, Hkv, D): one
scheduled decision at width D and one call of the chosen variant's
grouped runner (core/registry.py `attention_runner`), query head h over
KV head h // (H / Hkv). Held here against H single-head calls of the same
scheduler, forward and gradients of q, k and v, for every attention
variant's CPU path (the four composed pipelines, and the two fused
variants' plain versions with AUTOSAGE_PROBE_PALLAS=1), the reference
path, a resilience fallback and the chain's reference stage; and
`csr_band_attention` against the per-head form it replaced. The grouped
kernel itself is held against the per-head kernel on the card
(tests/test_torch_cuda.py).

Tolerance: 1e-6 of the largest value. The forward of a variant without a
grouped kernel runs the single-head runner head by head, and the fused
variants' plain versions do the same on the CPU, so the forward agrees
to the bit; the k and v gradients sum the group's heads in head order
where autograd sums the single-head calls' slices in its own order."""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import AutoSage, ScheduleCache, obs, registry, resilience
from repro_torch.core.features import InputFeatures
from repro_torch.core.scheduler import Decision
from repro_torch.kernels import attention as ka
from repro_torch.models import attention as attn_mod
from repro_torch.sparse import hub_skew

torch.set_num_threads(1)  # see test_torch_spmm.py

CPU = torch.device("cpu")
TOL = 1e-6
PIPES = [
    "pipe[sddmm=gather_dot,spmm=gather_segsum]",
    "pipe[sddmm=row_ell,spmm=row_ell]",
    "pipe[sddmm=row_ell,spmm=gather_segsum]",
    "pipe[sddmm=gather_dot,spmm=row_ell]",
]
FUSED = ["fused_attention_cuda[bc=8,rb=8]", "ragged_attention_cuda[bc=8,ragged=True,rb=8]"]
HEADS = [(1, 1), (4, 1), (8, 2), (4, 4)]


def _graph(kind):
    """The causal band of a window of 8 over 32 tokens, or a skewed graph
    (hubs of degree 20 over a base degree of 3, duplicate edges removed)."""
    if kind == "band":
        return attn_mod.band_csr(32, 8, 1)
    return hub_skew(72, 3, 0.1, 20, seed=4).dedup_edges()


def _inputs(csr, h, hkv, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(csr.n_rows, h, d, generator=g)
    k = torch.randn(csr.n_cols, hkv, d, generator=g)
    v = torch.randn(csr.n_cols, hkv, d, generator=g)
    return [t.requires_grad_() for t in (q, k, v)]


def _per_head(csr, q, k, v, **kw):
    """H single-head `api.attention` calls, stacked to (n, H, D)."""
    g = q.shape[1] // k.shape[1]
    return torch.stack([api.attention(csr, q[:, i], k[:, i // g], v[:, i // g], **kw)
                        for i in range(q.shape[1])], dim=1)


def _close(got, want):
    assert got.shape == want.shape
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _same_fwd_and_grads(q, k, v, grouped, per_head):
    """grouped(q, k, v) and per_head(q, k, v) agree, and so do the
    gradients of q, k and v under one random cotangent."""
    out, want = grouped(q, k, v), per_head(q, k, v)
    _close(out, want)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    for a, b in zip(torch.autograd.grad(out, (q, k, v), cot),
                    torch.autograd.grad(want, (q, k, v), cot)):
        _close(a, b)
    return out


class Pinned(AutoSage):
    """An AutoSage whose forward "attention" decision is the variant named
    ``choice``; every other op (the backward's) it decides as usual."""

    def __init__(self, choice):
        super().__init__(cache=ScheduleCache(), device="cpu", probe_iters=1)
        self.choice = choice

    def decide(self, csr, f, op, **kw):
        if op != "attention":
            return super().decide(csr, f, op, **kw)
        _, _, by_name = registry.pool(InputFeatures.from_csr(csr, f, op), self.hw, self.device)
        return Decision(op=op, choice=self.choice, variant=by_name[self.choice],
                        guardrail=None, from_cache=False, probe_ms={}, probe_overhead_ms=0.0,
                        probe_iter_ms=0.0, estimates_ms={})


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("AUTOSAGE_OBS", raising=False)
    monkeypatch.delenv("AUTOSAGE_FAULT", raising=False)
    monkeypatch.setenv("AUTOSAGE_OBS_DIR", str(tmp_path / "obs"))
    obs.reset()
    yield
    obs.reset()


def _heads(path):
    return obs.REGISTRY.get(obs.ATTENTION_HEADS_TOTAL, path=path) or 0


@pytest.mark.parametrize("choice", PIPES + FUSED)
@pytest.mark.parametrize("kind", ["band", "skew"])
@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("d", [16, 20])
def test_grouped_call_equals_single_head_calls(monkeypatch, choice, kind, h, hkv, d):
    """Every attention variant's CPU path: one grouped call equals H
    single-head calls, forward and gradients; the fused variants count
    their heads as grouped, the pipelines as looped."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    csr = _graph(kind)
    sage = Pinned(choice)
    q, k, v = _inputs(csr, h, hkv, d, seed=h + d)
    grouped0, looped0 = _heads("grouped"), _heads("looped")
    _same_fwd_and_grads(q, k, v, lambda *a: api.attention(csr, *a, sage=sage),
                        lambda *a: _per_head(csr, *a, sage=sage))
    fused = choice in FUSED
    assert _heads("grouped") == grouped0 + (h if fused else 0)
    assert _heads("looped") == looped0 + (0 if fused else h)


@pytest.mark.parametrize("kind", ["band", "skew"])
@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("scale", [None, 0.3])
def test_reference_path_runs_head_by_head(kind, h, hkv, scale):
    """sage=None, and a custom scale with a scheduler (which routes to the
    reference), equal single-head reference calls; no head is counted."""
    csr = _graph(kind)
    q, k, v = _inputs(csr, h, hkv, 16, seed=3)
    sage = Pinned(PIPES[0]) if scale is not None else None
    _same_fwd_and_grads(q, k, v,
                        lambda *a: api.attention(csr, *a, sage=sage, scale=scale),
                        lambda *a: _per_head(csr, *a, scale=scale))
    assert _heads("grouped") == _heads("looped") == 0


@pytest.mark.parametrize("h,hkv", HEADS)
def test_resilience_fallback_and_reference_stage(monkeypatch, h, hkv):
    """A grouped call whose pinned fused variant faults at every run falls
    back down the chain to the baseline pipeline, head by head, with the
    same output; the chain's reference stage takes grouped calls too."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    monkeypatch.setenv("AUTOSAGE_FAULT_RETRIES", "0")
    monkeypatch.setenv("AUTOSAGE_FAULT", "run:ragged_attention_cuda:raise")
    csr = _graph("band")
    q, k, v = _inputs(csr, h, hkv, 16, seed=5)
    sage = Pinned(FUSED[1])
    fallbacks0 = obs.REGISTRY.total("autosage_fallback_total")
    out = _same_fwd_and_grads(q, k, v, lambda *a: api.attention(csr, *a, sage=sage),
                              lambda *a: _per_head(csr, *a))
    assert obs.REGISTRY.total("autosage_fallback_total") > fallbacks0
    assert _heads("grouped") == 0 and _heads("looped") == h
    run = resilience.reference_runner(csr.structural(), "attention", CPU)
    _close(run(q.detach(), k.detach(), v.detach()), out.detach())
    assert _heads("looped") == 2 * h


def test_non_differentiable_grouped_call_and_its_run_span(monkeypatch):
    """differentiable=False takes the grouped runner too, and the call's
    `run` span carries its query heads."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    monkeypatch.setenv("AUTOSAGE_OBS", "1")
    csr = _graph("band")
    q, k, v = (t.detach() for t in _inputs(csr, 8, 2, 16, seed=6))
    sage = Pinned(FUSED[0])
    out = api.attention(csr, q, k, v, sage=sage, differentiable=False)
    _close(out, _per_head(csr, q, k, v))
    runs = [obs._render(s) for s in obs._spans if s[0] == "run"]
    assert [r["args"].get("heads") for r in runs] == [8]
    assert runs[0]["args"]["op"] == "attention" and runs[0]["args"]["choice"] == FUSED[0]
    assert _heads("grouped") == 8


def test_single_head_calls_count_nothing(monkeypatch):
    """A 2-D q takes the variants' single-head runners as before: no head
    is counted and no grouped launch is made."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    csr = _graph("band")
    q, k, v = _inputs(csr, 1, 1, 16, seed=8)
    for choice in FUSED + PIPES[:1]:
        before = dict(ka.LAUNCHES)
        api.attention(csr, q[:, 0], k[:, 0], v[:, 0], sage=Pinned(choice)).sum().backward()
        assert ka.LAUNCHES["fused_csr_attention_gqa"] == before["fused_csr_attention_gqa"]
        assert ka.LAUNCHES["fused_ragged_attention_gqa"] == before["fused_ragged_attention_gqa"]
    assert _heads("grouped") == _heads("looped") == 0


@pytest.mark.parametrize("bad", ["heads", "width", "kv"])
def test_grouped_shapes_are_checked(bad):
    csr = _graph("band")
    q, k, v = (t.detach() for t in _inputs(csr, 4, 2, 16))
    if bad == "heads":
        k, v = k[:, :1].expand(-1, 3, -1), v[:, :1].expand(-1, 3, -1)
    elif bad == "width":
        k, v = k[..., :8], v[..., :8]
    else:
        k = k[:, 0]
    with pytest.raises(ValueError):
        api.attention(csr, q, k, v, sage=Pinned(PIPES[0]))


def _band_per_head(q, k, v, window, sage):
    """`csr_band_attention` as it was: one `api.attention` call a query
    head on contiguous copies, stacked."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    csr = attn_mod.band_csr(s, window, b)
    qf = q.reshape(b * s, h, dh)
    ks = [k.reshape(b * s, hkv, dh)[:, j].contiguous() for j in range(hkv)]
    vs = [v.reshape(b * s, hkv, dh)[:, j].contiguous() for j in range(hkv)]
    g = h // hkv
    outs = [api.attention(csr, qf[:, i].contiguous(), ks[i // g], vs[i // g], sage=sage)
            for i in range(h)]
    return torch.stack(outs, dim=1).reshape(b, s, h * dh)


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_csr_band_attention_equals_its_per_head_form(scheduled, batch):
    """The window layers' attention, one grouped call, against the per-head
    calls it replaced, with and without the scheduler (its own decisions
    on the CPU pool); (B, S, H, Dh) in, (B, S, H * Dh) out."""
    g = torch.Generator().manual_seed(batch)
    q = torch.randn(batch, 24, 8, 16, generator=g).requires_grad_()
    k = torch.randn(batch, 24, 2, 16, generator=g).requires_grad_()
    v = torch.randn(batch, 24, 2, 16, generator=g).requires_grad_()
    sage = AutoSage(cache=ScheduleCache(), device="cpu", probe_iters=1) if scheduled else None
    out = _same_fwd_and_grads(
        q, k, v, lambda *a: attn_mod.csr_band_attention(*a, 8, sage),
        lambda *a: _band_per_head(*a, 8, sage))
    assert out.shape == (batch, 24, 8 * 16)
    assert _heads("looped") == (8 if scheduled else 0)  # the CPU pool: pipelines


def test_by_head_is_the_grouped_plain_version():
    """The fused wrappers' plain versions (CPU tensors) are the single-head
    plain versions run head by head, query head h over KV head h // G."""
    from repro_torch.sparse import csr_to_block_ell

    csr = _graph("skew")
    bell = csr_to_block_ell(csr.structural())
    rag = bell.to_ragged()
    rargs = [torch.from_numpy(a) for a in
             (rag.blkptr, rag.slot_colblk, (rag.slot_vals != 0).astype(np.float32))]
    dargs = [torch.from_numpy(a) for a in (bell.colblk, (bell.vals != 0).astype(np.float32))]
    q, k, v = (t.detach() for t in _inputs(csr, 6, 3, 20, seed=2))
    out = ka.fused_ragged_attention_gqa(*rargs, q, k, v, n_rows=csr.n_rows)
    dense = ka.fused_csr_attention_gqa(*dargs, q, k, v, n_rows=csr.n_rows)
    for i in range(6):
        want = ka.fused_ragged_attention_plain(*rargs, q[:, i], k[:, i // 2], v[:, i // 2],
                                               n_rows=csr.n_rows)
        assert torch.equal(out[:, i], want)
        _close(dense[:, i], want)
