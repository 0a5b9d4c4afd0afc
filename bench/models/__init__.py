"""A configuration's model on both sides, found by name: the inputs made
from the seed, and the model family's file that builds the port's model
and the plain reference's loss.

A configuration names its family under ``family`` (``models/<family>.py``)
and its graph generator under ``graph_generator`` (``gen/<generator>.py``).
A family file has

  weight_shapes(config)       (name, shape) of every weight, in the
                              port's parameter order
  node_classes(config)        label classes (0: no labels)
  program_model(config, weights, device)
  program_loss(config, model, csr, x, y, sage)
                              the objective over the port's forward
  reference_loss(config, pattern, inputs, precision, half_batch)
                              the plain reference's loss of one step
  step_flops(config, graph)   model FLOPs of one training step

and a generator file ``make(config, gen) -> graphs.Graph``. A name with
no file is refused, never taken for another.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from bench.gen import graphs
from bench.work import gnn as work

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Inputs:
    graph: graphs.Graph
    x: torch.Tensor
    y: Optional[torch.Tensor]
    weights: Dict[str, torch.Tensor]  # initial weights by the port's parameter names


def _by_name(folder: str, name: str, what: str):
    from bench.harness import load_by_path

    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {what} {name!r}: {path.relative_to(BENCH.parent)} does not exist")
    return load_by_path(path)


def family(config: Dict[str, Any]):
    """The configuration's model family module (``models/<family>.py``)."""
    return _by_name("models", config["family"], "model family")


def make_graph(config: Dict[str, Any], device: torch.device) -> graphs.Graph:
    """The configuration's graph from its generator and fixed ``graph_seed``."""
    gen = _by_name("gen", config["graph_generator"], "graph generator")
    return gen.make(config, graphs.device_generator(config["graph_seed"], device))


def make_inputs(config: Dict[str, Any], seed: int, device: torch.device) -> Inputs:
    """The graph, and the features, labels and weights of ``seed``, on
    ``device``."""
    fam = family(config)
    graph = make_graph(config, device)
    gen = graphs.device_generator(seed, device)
    x, y = graphs.node_data(graph.n_rows, config["in_dim"], fam.node_classes(config), gen)
    shapes = fam.weight_shapes(config)
    weights = dict(zip([n for n, _ in shapes], graphs.normal_weights([s for _, s in shapes], gen)))
    return Inputs(graph, x, y, weights)


def program_csr(graph: graphs.Graph):
    """The port's host CSR of the graph."""
    from repro_torch.sparse.csr import CSR

    rowptr, colind = graph.host_arrays()
    return CSR(rowptr, colind, None, graph.n_rows, graph.n_cols)


def full_graph_work(config: Dict[str, Any], graph: graphs.Graph) -> Dict[str, Any]:
    """The work model of one full-graph step for the metric readers."""
    n, nnz = graph.n_rows, graph.nnz
    return {"step_flops": family(config).step_flops(config, graph), "flops_peak": "fp32_flops",
            "call": lambda op, f: work.call_work(op, f, n, n, nnz)}
