"""bench/work's counts against hand counts and torch's FLOP counter on
a small graph."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.gen import graphs, lognormal
from bench.reference import gnn as ref
from bench.work import gnn as work


def test_call_work_by_hand():
    n_rows, n_cols, nnz, f = 10, 12, 30, 8
    flops, nbytes = work.call_work("spmm", f, n_rows, n_cols, nnz)
    assert flops == 2 * 30 * 8
    assert nbytes == 4 * 11 + 4 * 30 + 4 * 30 + 4 * 8 * 12 + 4 * 8 * 10
    flops, nbytes = work.call_work("attention_bwd_e", f, n_rows, n_cols, nnz)
    assert flops == 2 * 30 * 8 and nbytes == 4 * 11 + 4 * 30 + 4 * 8 * 22 + 4 * 30
    flops, nbytes = work.call_work("attention", f, n_rows, n_cols, nnz)
    assert flops == 4 * 30 * 8 and nbytes == 4 * 11 + 4 * 30 + 4 * 8 * (10 + 24 + 10)
    assert work.call_work("spmm_bwd_b", f, n_cols, n_rows, nnz)[0] == flops / 2
    assert work.roofline_s(67e12, 0.0, 67e12, 3.35e12) == 1.0
    assert work.roofline_s(0.0, 3.35e12, 67e12, 3.35e12) == 1.0


def _graph(n=64, deg=5.0):
    gen = graphs.device_generator(3, torch.device("cpu"))
    return lognormal.random_graph(n, deg, 1.0, gen), gen


def test_gat_step_flops_match_the_counted_dense_work():
    g, gen = _graph()
    x, _ = graphs.node_data(g.n_rows, 12, 0, gen)
    w = dict(zip(("wq", "wk", "wv"), graphs.normal_weights([(12, 16)] * 3, gen)))
    p = ref.Pattern(g.rowptr, g.colind, g.n_cols)
    with FlopCounterMode(display=False) as counter:
        ref.gat_loss(p, x)(w)
    dense = counter.get_total_flops()
    assert work.gat_step_flops(g.n_rows, g.nnz, 12, 16) == dense + 12 * g.nnz * 16
