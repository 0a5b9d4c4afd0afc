"""The paper's own workload: GNN layers over CSR graphs, with
AutoSAGE-scheduled sparse aggregation.

Port of repro/models/gnn.py (``init_gnn``, ``_norm_csr``,
``sage_forward``, ``sage_minibatch_forward``, ``init_gat``,
``gat_layer``):

    GraphSAGE (mean aggregator): H' = act(A_norm @ H @ W_agg + H @ W_self)
    GAT-style CSR attention:     H' = CSR_attention(A, HW_q, HW_k, HW_v)
                                 (SDDMM -> row-softmax -> SpMM, §8.7)

With a scheduler and gradients enabled, `SAGE` and `GAT` train through
it: every forward and backward sparse op is a scheduled decision under
its own op string (core/autodiff.py); under ``torch.no_grad`` only the
forward ops are scheduled. The scheduler is an `AutoSage` or, for
minibatch streams, a `BatchScheduler` (core/batch.py).
src/repro_torch/train_gnn.py takes the training steps.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import api
from repro_torch.configs.gnn_sage import CONFIG as SAGE_CONFIG
from repro_torch.core import obs
from repro_torch.core.features import resolve_device
from repro_torch.sparse.csr import CSR


def norm_csr(csr: CSR) -> CSR:
    """Row-normalized adjacency (mean aggregator)."""
    with obs.span("model.norm_csr"):
        deg = np.maximum(csr.degrees, 1).astype(np.float32)
        val = csr.values_or_ones(np.float32) / np.repeat(deg, csr.degrees)
        return CSR(csr.rowptr, csr.colind, val, csr.n_rows, csr.n_cols)


def _dims(in_dim: int, n_classes: int, d_model: int, n_layers: int) -> List[int]:
    return [in_dim] + [d_model] * (n_layers - 1) + [n_classes]


class SAGE(nn.Module):
    """GraphSAGE with ``n_layers`` mean-aggregation layers. Weights are
    drawn as in `repro.models.gnn.init_gnn` (normal, scaled by
    1/sqrt(d_in)) from a torch.Generator seeded with ``seed``; the values
    differ from JAX's, so parity tests carry JAX's weights over with
    `sage_params_from_jax`."""

    def __init__(
        self,
        in_dim: int,
        n_classes: int,
        d_model: int = SAGE_CONFIG.d_model,
        n_layers: int = SAGE_CONFIG.n_layers,
        *,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        dims = _dims(in_dim, n_classes, d_model, n_layers)
        g = torch.Generator().manual_seed(seed)

        def init(i):
            w = torch.randn(dims[i], dims[i + 1], generator=g) * dims[i] ** -0.5
            return nn.Parameter(w.to(device))

        self.w_agg = nn.ParameterList()
        self.w_self = nn.ParameterList()
        for i in range(n_layers):
            self.w_agg.append(init(i))
            self.w_self.append(init(i))

    def forward(self, csr: CSR, x: torch.Tensor, sage=None) -> torch.Tensor:
        """Logits (n_rows, n_classes). Aggregation runs through the
        scheduler ``sage`` when given, else the torch reference."""
        a = norm_csr(csr)
        n_layers = len(self.w_agg)
        for i in range(n_layers):
            h = x @ self.w_agg[i]
            agg = api.spmm(a, h, sage=sage, differentiable=torch.is_grad_enabled())
            x = agg + x @ self.w_self[i]
            if i < n_layers - 1:
                x = torch.relu(x)
        return x

    def minibatch_forward(self, sub: CSR, batch_rows: np.ndarray, x_full: torch.Tensor,
                          sage=None) -> torch.Tensor:
        """Logits (len(batch_rows), n_classes) of one minibatch step of
        1-hop sampled GraphSAGE. ``sub`` is the rectangular adjacency of
        the batch rows over all nodes (``graph.row_slice(batch_rows)``,
        e.g. one element of `sparse.sample_subgraph_stream`): layer 0 is
        the scheduled aggregation over each row's full neighbourhood, the
        other layers a dense head on the batch rows."""
        a = norm_csr(sub)
        h = x_full @ self.w_agg[0]
        agg = api.spmm(a, h, sage=sage, differentiable=torch.is_grad_enabled())
        xb = x_full[torch.from_numpy(np.asarray(batch_rows, np.int64)).to(x_full.device)]
        out = agg + xb @ self.w_self[0]
        for i in range(1, len(self.w_agg)):
            out = torch.relu(out)
            out = out @ self.w_agg[i] + out @ self.w_self[i]
        return out


def sage_minibatch_forward(model: SAGE, sub: CSR, batch_rows: np.ndarray,
                           x_full: torch.Tensor, sage=None) -> torch.Tensor:
    """`SAGE.minibatch_forward` under the JAX package's function name,
    the model in place of its parameter dict."""
    return model.minibatch_forward(sub, batch_rows, x_full, sage=sage)


def sage_params_from_jax(params_np: Dict[str, Sequence[np.ndarray]], device=None) -> SAGE:
    """A `SAGE` holding the weights of `repro.models.gnn.init_gnn`'s
    output, given as numpy arrays ``{"w_agg": [...], "w_self": [...]}``."""
    w_agg, w_self = params_np["w_agg"], params_np["w_self"]
    n_layers = len(w_agg)
    d_model = w_agg[0].shape[1] if n_layers > 1 else SAGE_CONFIG.d_model
    model = SAGE(w_agg[0].shape[0], w_agg[-1].shape[1], d_model, n_layers, device=device)
    with torch.no_grad():
        for dst, src in zip([*model.w_agg, *model.w_self], [*w_agg, *w_self]):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"weight shape {src.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, np.float32)))
    return model


class GAT(nn.Module):
    """One dot-product graph-attention layer: the paper's CSR-attention
    pipeline over the projections q = x W_q, k = x W_k, v = x W_v. Weights
    are drawn as in `repro.models.gnn.init_gat` (normal, scaled by
    1/sqrt(in_dim)) from a torch.Generator seeded with ``seed``; parity
    tests carry JAX's weights over with `gat_params_from_jax`."""

    def __init__(
        self,
        in_dim: int,
        d_model: int = SAGE_CONFIG.d_model,
        *,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)

        def init():
            w = torch.randn(in_dim, d_model, generator=g) * in_dim ** -0.5
            return nn.Parameter(w.to(device))

        self.wq, self.wk, self.wv = init(), init(), init()

    def forward(self, csr: CSR, x: torch.Tensor, sage=None) -> torch.Tensor:
        """(n_rows, d_model): attention through the scheduler ``sage``
        (one pipeline-level decision) when given, else the torch
        reference. Attention reads the graph's pattern only; deduplicate
        a multigraph first (``csr.dedup_edges()``) or the fused kernels
        stay out of the pool."""
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        return api.attention(csr, q, k, v, sage=sage,
                             differentiable=torch.is_grad_enabled())


def gat_params_from_jax(params_np: Dict[str, np.ndarray], device=None) -> GAT:
    """A `GAT` holding the weights of `repro.models.gnn.init_gat`'s output,
    given as numpy arrays ``{"wq": ..., "wk": ..., "wv": ...}``."""
    in_dim, d_model = params_np["wq"].shape
    model = GAT(in_dim, d_model, device=device)
    with torch.no_grad():
        for name in ("wq", "wk", "wv"):
            src = np.array(params_np[name], np.float32)
            if src.shape != (in_dim, d_model):
                raise ValueError(f"{name} shape {src.shape} != {(in_dim, d_model)}")
            getattr(model, name).copy_(torch.from_numpy(src))
    return model
