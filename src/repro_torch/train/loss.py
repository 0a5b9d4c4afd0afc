"""Losses: masked causal cross-entropy + z-loss (port of
repro/train/loss.py)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) f32
    labels: torch.Tensor,  # (B, S) int; -1 = masked
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over unmasked positions (``labels >= 0``) of the
    negative log-likelihood plus ``z_loss`` * logsumexp²; the denominator
    is ``max(mask.sum(), 1)``. Returns (loss, {nll, z_loss, tokens})."""
    mask = (labels >= 0).float()
    labels_safe = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll + zl).sum() / denom
    return loss, {
        "nll": nll.sum() / denom,
        "z_loss": zl.sum() / denom,
        "tokens": mask.sum(),
    }
