"""The pattern of a sliding-window layer: the causal band as a CSR.

Over ``batch`` packed sequences of ``seq_len`` tokens, row b·S + t holds
the columns b·S + max(0, t - window + 1) .. b·S + t in order: the
positions a token attends to under a window of ``window`` (itself
included). The LM cells' generator builds it from the traffic's
sequence length and the configuration's ``sliding_window``; the work
counts and the tests read it. Made on the device with torch.
"""
from __future__ import annotations

import torch

from bench.gen.graphs import Graph


def band(seq_len: int, window: int, batch: int, device: torch.device) -> Graph:
    t = torch.arange(seq_len, device=device)
    lo = torch.clamp_min(t - window + 1, 0)
    deg = (t - lo + 1).repeat(batch)
    rowptr = torch.zeros(batch * seq_len + 1, dtype=torch.int64, device=device)
    rowptr[1:] = torch.cumsum(deg, 0)
    rows = torch.repeat_interleave(torch.arange(batch * seq_len, device=device), deg)
    first = lo.repeat(batch) + torch.arange(batch, device=device).repeat_interleave(seq_len) * seq_len
    colind = first[rows] + torch.arange(int(rowptr[-1]), device=device) - rowptr[rows]
    return Graph(rowptr, colind, batch * seq_len, batch * seq_len)
