"""The device graph generator's statistics at a small scale (CPU), and
the generator and model family found by the names a configuration
gives."""
import pytest
import torch

from bench.gen import graphs, lognormal

CPU = torch.device("cpu")


def _make(seed, dedup=False, n=4000, deg=40.0, sigma=1.4):
    return lognormal.random_graph(n, deg, sigma, graphs.device_generator(seed, CPU), dedup)


CFG = {"family": "gat", "graph_generator": "lognormal", "num_nodes": 500, "avg_degree": 8.0,
       "degree_sigma": 1.4, "graph_seed": 0, "dedup": True, "in_dim": 6, "hidden_size": 8}


def test_degrees_follow_the_dataset_shape():
    a, b = _make(1), _make(2 ** 40 + 5)
    deg_a = a.rowptr.diff()
    for g in (a, b):
        assert abs(g.nnz / g.n_rows - 40.0) < 2.0  # the floor loses < 1 a row
    assert int(deg_a.min()) >= 1
    # lognormal(sigma 1.4): a heavy tail far above the mean
    assert float(deg_a.max()) > 10 * 40.0
    assert not torch.equal(deg_a, b.rowptr.diff())


def test_inputs_take_the_graph_from_the_config_and_the_rest_from_the_seed():
    from bench import models

    a, b = models.make_inputs(CFG, 1, CPU), models.make_inputs(CFG, 2 ** 40 + 5, CPU)
    assert torch.equal(a.graph.colind, b.graph.colind)
    assert torch.equal(a.graph.rowptr, b.graph.rowptr)
    assert not torch.equal(a.x, b.x) and not torch.equal(a.weights["wq"], b.weights["wq"])
    assert torch.equal(a.x, models.make_inputs(CFG, 1, CPU).x)
    assert a.y is None and sorted(a.weights) == ["wk", "wq", "wv"]


@pytest.mark.parametrize("key,value", [("family", "sage"), ("family", "gat2"),
                                       ("graph_generator", "hub_skew")])
def test_a_name_with_no_file_is_refused(key, value):
    from bench import models

    with pytest.raises(ValueError, match=value):
        models.make_inputs(dict(CFG, **{key: value}), 1, CPU)


def test_columns_sorted_in_range_and_seeded():
    a = _make(7)
    assert torch.equal(a.colind, _make(7).colind)
    assert int(a.colind.min()) >= 0 and int(a.colind.max()) < a.n_cols
    rows = torch.repeat_interleave(torch.arange(a.n_rows), a.rowptr.diff())
    key = rows * a.n_cols + a.colind
    assert bool((key[1:] >= key[:-1]).all())
    rp, ci = a.host_arrays()
    assert rp.dtype.name == ci.dtype.name == "int32" and rp[-1] == a.nnz


def test_dedup_removes_every_repeated_pair():
    a, d = _make(3), _make(3, dedup=True)
    rows = torch.repeat_interleave(torch.arange(d.n_rows), d.rowptr.diff())
    key = rows * d.n_cols + d.colind
    assert bool((key[1:] > key[:-1]).all())
    rows_a = torch.repeat_interleave(torch.arange(a.n_rows), a.rowptr.diff())
    assert d.nnz == torch.unique(rows_a * a.n_cols + a.colind).numel() < a.nnz


def test_weights_and_node_data():
    gen = graphs.device_generator(5, CPU)
    w = graphs.normal_weights([(400, 3), (20, 7)], gen)
    assert [t.shape for t in w] == [(400, 3), (20, 7)]
    assert abs(float(w[0].std()) - 400 ** -0.5) < 0.1 * 400 ** -0.5
    x, y = graphs.node_data(50, 6, 4, gen)
    assert x.shape == (50, 6) and int(y.max()) < 4 and int(y.min()) >= 0
