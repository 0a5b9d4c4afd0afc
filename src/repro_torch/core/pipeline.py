"""Pipeline-level scheduling for CSR attention (SDDMM -> softmax -> SpMM).

Port of repro/core/pipeline.py. A per-op view can never justify a fused
kernel: its benefit — logits and probs never round-trip device memory —
lies *between* the ops. So CSR attention is decided at pipeline
granularity, as one op ("attention") of `AutoSage.decide`:

  1. enumerate composed candidates {sddmm variant x softmax x spmm
     variant} plus the fused CUDA kernels (dense-W and ragged), all
     op="attention" Variants in core/registry.py;
  2. shortlist by the pipeline roofline in core/estimate.py, which
     charges composed candidates the two inter-stage round-trips the
     fused kernels avoid;
  3. micro-probe the shortlist end to end on the same induced subgraphs
     through `AutoSage.probe_candidates` (slope mode);
  4. guardrail (Prop. 1) against the 3-stage gather/segsum baseline and
     cache the joint decision under an op="attention" key with
     deterministic replay (core/cache.py).

Entry points are `repro_torch.api.attention(csr, q, k, v, sage=...)`,
`AutoSage.attention` and `AutoSage.decide_attention`; the GAT layer of
models/gnn.py runs through the first. What is attention's own lives
here: `probe_stage_breakdown`, the per-stage timing of the chosen
pipeline that `decide_attention(..., stage_breakdown=True)` pins with
the entry.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import probe as probe_mod
from repro_torch.core import registry
from repro_torch.kernels import baselines as kb
from repro_torch.sparse.csr import CSR

# the fused variants run as one stage in probe_stage_breakdown
FUSED = ("fused_attention_cuda", "ragged_attention_cuda")


def probe_stage_breakdown(
    sage, csr: CSR, d: int, variant: registry.Variant, seed: int = 0
) -> Dict[str, float]:
    """Median per-stage ms of ``variant`` on the probe subgraph of the
    deciding ``sage`` (its device, probe fraction, iterations and cap).

    For composed pipelines the three stages run in each stage's own
    layout with their inputs made beforehand, so the numbers isolate
    stage cost (mixed-layout conversion shows only in the end-to-end
    probe_ms). A fused kernel is one stage."""
    sub = probe_mod.induced_subgraph(csr, frac=sage.probe_frac, seed=seed)
    q, k, v = probe_mod.default_probe_args("attention", d, sage.device, seed)(sub)

    def _med(fn, name):
        return probe_mod.time_callable(
            fn, sage.device, iters=sage.probe_iters, cap_ms=sage.probe_cap_ms,
            name=name,
        ).median_ms

    if variant.name in FUSED:
        run = variant.build(variant.prepare(sub), sage.device)
        return {"fused": _med(lambda: run(q, k, v), "fused")}

    s_impl = variant.knobs.get("sddmm", "gather_dot")
    m_impl = variant.knobs.get("spmm", "gather_segsum")
    needs_ell = "row_ell" in (s_impl, m_impl)
    prep = registry._prepare_attn_mixed if needs_ell else kb.prepare_csr
    dev = registry._dev(prep(sub), sage.device)
    ell = {"colind": dev["ell_colind"], "val": dev["ell_val"]} if needs_ell else None
    scale = 1.0 / (d ** 0.5)
    out: Dict[str, float] = {}

    # -- SDDMM stage (+ the softmax in the same layout)
    if s_impl == "row_ell":
        def sddmm_fn():
            return kb.sddmm_row_ell(ell, q, k) * scale

        def softmax_fn(lg):
            return kb.ell_masked_softmax(lg, ell["val"] != 0)
    else:
        def sddmm_fn():
            return kb.sddmm_gather_dot(dev, q, k) * scale

        def softmax_fn(lg):
            return kb.row_softmax(dev, lg)
    out["sddmm"] = _med(sddmm_fn, "sddmm")
    logits = sddmm_fn()
    out["softmax"] = _med(lambda: softmax_fn(logits), "softmax")
    probs = softmax_fn(logits)

    # -- value-SpMM stage, consuming probs in its own layout
    if needs_ell:
        er, es = dev["edge_row"].long(), dev["edge_slot"].long()
    if m_impl == "row_ell":
        if probs.dim() == 1:  # CSR probs -> ELL table
            table = probs.new_zeros(ell["colind"].shape)
            table[er, es] = probs
            probs = table

        def spmm_fn():
            return kb.spmm_row_ell({"colind": ell["colind"], "val": probs}, v)
    else:
        if probs.dim() == 2:  # ELL probs -> CSR values
            probs = probs[er, es]

        def spmm_fn():
            return kb.spmm_gather_segsum({**dev, "val": probs}, v)
    out["spmm"] = _med(spmm_fn, "spmm")
    return out
