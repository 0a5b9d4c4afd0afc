"""The ``gat`` family: the port's `GAT`, one dot-product CSR-attention
layer (q, k, v = x W_q, x W_k, x W_v; out = softmax_row(q k^T / sqrt(d))
v over the graph's pattern), loss 0.5 * mean over rows of |out_i|^2."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from bench.reference import gnn as ref
from bench.work import gnn as work

NAMES = ("wq", "wk", "wv")


def weight_shapes(config: Dict[str, Any]) -> List[Tuple[str, Tuple[int, int]]]:
    return [(n, (config["in_dim"], config["hidden_size"])) for n in NAMES]


def node_classes(config: Dict[str, Any]) -> int:
    return 0


def program_model(config: Dict[str, Any], weights, device):
    import torch

    from repro_torch.models.gnn import GAT

    model = GAT(config["in_dim"], config["hidden_size"], device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def program_loss(config: Dict[str, Any], model, csr, x, y, sage) -> Callable:
    n = csr.n_rows
    return lambda: 0.5 * (model(csr, x, sage=sage) ** 2).sum() / n


def reference_loss(config: Dict[str, Any], pattern: ref.Pattern, inputs,
                   precision: str = "fp32", half_batch: bool = False) -> Callable:
    """With ``half_batch`` the mean is taken over the first half of the rows."""
    keep = pattern.n_rows // 2 if half_batch else None
    return ref.gat_loss(pattern, inputs.x, precision, keep_rows=keep)


def step_flops(config: Dict[str, Any], graph) -> float:
    return work.gat_step_flops(graph.n_rows, graph.nnz, config["in_dim"], config["hidden_size"])
