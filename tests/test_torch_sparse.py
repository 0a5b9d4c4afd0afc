"""repro_torch.sparse against repro.sparse: every generator and layout
builder returns the same arrays for the same input and seed, and the
graph signature (the schedule-cache key) hashes identically."""
import dataclasses

import numpy as np
import pytest

import repro.sparse as jx
from repro.sparse import bsr as jx_bsr
from repro.sparse import generators as jx_gen
import repro_torch.sparse as pt
from repro_torch.sparse import bsr as pt_bsr
from repro_torch.sparse import generators as pt_gen

GENERATORS = [
    ("reddit_like", dict(scale=0.005, seed=0)),
    ("products_like", dict(scale=0.0005, seed=1)),
    ("hub_skew", dict(n=600, base_deg=4, hub_frac=0.1, hub_deg=60, seed=2)),
    ("erdos_renyi", dict(n=800, p=4e-3, seed=3)),
    ("single_hub", dict(n=256, nnz_frac=0.9, seed=4)),
    ("power_law", dict(n=300, alpha=1.7, avg_deg=6.0, n_cols=200, seed=1)),
    ("fixed_degree", dict(n=200, deg=5, n_cols=150, seed=6)),
]


def _assert_same(a, b):
    """Two dataclass layouts hold equal fields (arrays equal with dtype)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _graph(pair):
    name, kw = pair
    return getattr(jx_gen, name)(**kw), getattr(pt_gen, name)(**kw)


@pytest.mark.parametrize("pair", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_and_signature_match(pair):
    j, p = _graph(pair)
    _assert_same(j, p)
    assert jx.graph_signature(j) == pt.graph_signature(p)


def test_signature_of_large_colind_matches():
    """Above 1M edges the signature hashes a stride sample: same path."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4000, 1_200_000)
    cols = rng.integers(0, 4000, 1_200_000)
    j = jx.csr_from_coo(rows, cols, 4000, 4000)
    p = pt.csr_from_coo(rows, cols, 4000, 4000)
    assert jx.graph_signature(j) == pt.graph_signature(p)


@pytest.mark.parametrize("pair", GENERATORS[2:], ids=[g[0] for g in GENERATORS[2:]])
@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_block_ell_ragged_merge_match(pair, rb, bc):
    j, p = _graph(pair)
    jb, pb = jx.csr_to_block_ell(j, rb=rb, bc=bc), pt.csr_to_block_ell(p, rb=rb, bc=bc)
    _assert_same(jb, pb)
    _assert_same(jb.to_ragged(), pb.to_ragged())
    for k, v in jx.block_ell_edge_index(j, jb).items():
        assert np.array_equal(v, pt.block_ell_edge_index(p, pb)[k])
    if (rb, bc) == (8, 8):
        for ts in (3, 8, 16):
            _assert_same(
                jx.build_merge_path(jb.to_ragged(), ts),
                pt.build_merge_path(pb.to_ragged(), ts),
            )


def test_row_subsets_empty_blocks_and_hub_split():
    """Hub-split partitions, a row subset with empty row blocks (dummy
    slots) and an empty subset convert identically."""
    j, p = _graph(GENERATORS[2])
    t = 20
    jh, ph = jx_bsr.hub_split(j, t), pt_bsr.hub_split(p, t)
    for a, b in zip(jh, ph):
        assert np.array_equal(a, b)
    rows = np.concatenate([np.arange(0, 40), np.arange(300, 320)])
    for r in (jh[0], jh[1], rows, np.zeros(0, np.int64)):
        _assert_same(
            jx.csr_to_block_ell(j, rows=r).to_ragged(),
            pt.csr_to_block_ell(p, rows=r).to_ragged(),
        )
    # a graph with empty rows: whole row blocks get the all-zero dummy slot
    jc = jx.CSR(np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 2], np.int32),
                np.array([1, 5], np.int32), None, 9, 9)
    pc = pt.CSR(jc.rowptr, jc.colind, None, 9, 9)
    _assert_same(jx.csr_to_block_ell(jc).to_ragged(), pt.csr_to_block_ell(pc).to_ragged())


def test_csr_methods_match():
    j, p = _graph(GENERATORS[4])
    (jt, jperm), (pt_, pperm) = j.transpose_with_perm(), p.transpose_with_perm()
    _assert_same(jt, pt_)
    assert np.array_equal(jperm, pperm)
    rows = np.arange(0, j.n_rows, 3)
    _assert_same(j.row_slice(rows), p.row_slice(rows))
    _assert_same(j.dedup_edges(), p.dedup_edges())
    assert j.has_duplicate_edges() == p.has_duplicate_edges()
    assert not j.dedup_edges().has_duplicate_edges()
    assert not p.dedup_edges().has_duplicate_edges()


def test_int32_guard_matches():
    for mod in (jx_bsr, pt_bsr):
        mod._check_int32("x", 2**31 - 1)
        with pytest.raises(ValueError, match="overflows int32"):
            mod._check_int32("x", 2**31)


@pytest.mark.parametrize("pair", GENERATORS[2:], ids=[g[0] for g in GENERATORS[2:]])
@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_direct_ragged_builder_matches(pair, rb, bc):
    """csr_to_ragged (no dense-W table) returns the JAX package's
    to_ragged arrays, its BlockELL's padding_frac and, per edge, the
    ragged cell block_ell_edge_index locates — valued and structural."""
    j, p = _graph(pair)
    vals = np.random.default_rng(2).standard_normal(p.nnz).astype(np.float32)
    for jc, pc in ((j, p), (jx.CSR(j.rowptr, j.colind, vals, j.n_rows, j.n_cols),
                            pt.CSR(p.rowptr, p.colind, vals, p.n_rows, p.n_cols))):
        jb = jx.csr_to_block_ell(jc, rb=rb, bc=bc)
        rag, padding_frac, edges = pt.csr_to_ragged(pc, rb, bc)
        _assert_same(jb.to_ragged(), rag)
        assert padding_frac == jb.padding_frac
        idx = jx.block_ell_edge_index(jc, jb)
        flat = jb.to_ragged().blkptr[idx["edge_blkrow"]] + idx["edge_slot"]
        assert np.array_equal(edges["edge_slot"], flat)
        assert np.array_equal(edges["edge_r"], idx["edge_r"])
        assert np.array_equal(edges["edge_c"], idx["edge_c"])
