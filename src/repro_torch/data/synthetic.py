"""Deterministic synthetic data pipelines (a copy of
repro/data/synthetic.py: numpy only, so the same (seed, step) gives
the same arrays in both packages).

Token streams use a Zipf-like unigram distribution with a Markov-ish
structure (next-token depends on previous via a rolling hash) so a real
LM shows decreasing loss. The pipeline state is just (seed, step) —
recorded in checkpoints, so restart-resume is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


def token_batch(
    cfg: ArchConfig, batch: int, seq: int, state: PipelineState
) -> Dict[str, np.ndarray]:
    """One (tokens, labels) batch; tokens[t+1] is the label of tokens[t]."""
    rng = np.random.default_rng((state.seed, state.step))
    v = max(cfg.vocab, 4)
    # zipf-ish unigram with structure: x_{t+1} = (a*x_t + noise) % v
    base = rng.zipf(1.3, size=(batch, seq + 1)) % v
    carry = np.cumsum(base, axis=1) % v
    toks = carry.astype(np.int32)
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.vlm_patches
        out["tokens"] = out["tokens"][:, : seq - p]
        out["patch_embeds"] = rng.standard_normal(
            (batch, p, cfg.d_model), dtype=np.float32
        )
        lbl = out["labels"].copy()
        lbl[:, : p] = -1  # no loss on patch positions
        out["labels"] = lbl
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_dec.enc_seq, cfg.d_model), dtype=np.float32
        )
    return out


def batches(
    cfg: ArchConfig, batch: int, seq: int, seed: int = 0, start_step: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    state = PipelineState(seed, start_step)
    while True:
        yield token_batch(cfg, batch, seq, state)
        state.step += 1
