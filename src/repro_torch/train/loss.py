"""Losses: masked causal cross-entropy + z-loss (port of
repro/train/loss.py)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy_sums(
    logits: torch.Tensor,  # (B, S, V) f32
    labels: torch.Tensor,  # (B, S) int; -1 = masked
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sums over the unmasked positions (``labels >= 0``): (the loss's,
    the negative log-likelihood's, the z-loss's (``z_loss`` *
    logsumexp²), the number of unmasked positions)."""
    mask = (labels >= 0).float()
    labels_safe = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    return (nll + zl).sum(), nll.sum(), zl.sum(), mask.sum()


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) f32
    labels: torch.Tensor,  # (B, S) int; -1 = masked
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over unmasked positions (``labels >= 0``) of the negative
    log-likelihood plus ``z_loss`` * logsumexp²; the denominator
    is ``max(mask.sum(), 1)``. Returns (loss, {nll, z_loss, tokens})."""
    total, nll, zl, tokens = cross_entropy_sums(logits, labels, z_loss)
    denom = torch.clamp_min(tokens, 1.0)
    loss = total / denom
    return loss, {
        "nll": nll / denom,
        "z_loss": zl / denom,
        "tokens": tokens,
    }
