"""The port's attention oracles, fused-kernel plain versions and composed
pipelines on CPU tensors, against the JAX package on the same numpy
inputs: its jnp oracles (kernels/ref.py), its fused Pallas kernels in
interpret mode and its XLA pipelines (kernels/xla.py).

Tolerance rtol 1e-5, atol 1e-6 * max|ref|: both sides take the same
fp32 products and exponentials in another order (the plain versions use
an exact two-pass softmax where the Pallas kernels carry an online one).
Graphs are deduplicated, as attention requires, and cover empty row
blocks (only the ragged dummy slot), rows without edges inside non-empty
row blocks, and one hub row spanning many slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_pallas as jk
from repro.kernels import ref as jref
from repro.kernels import xla as kx
from repro.sparse import CSR as JxCSR
from repro.sparse import csr_to_block_ell as jx_csr_to_block_ell
from repro_torch.core import HardwareSpec, InputFeatures, registry
from repro_torch.kernels import attention as ka
from repro_torch.kernels import baselines as kb
from repro_torch.kernels import ref as pref
from repro_torch.sparse import CSR, csr_to_block_ell, hub_skew, single_hub

torch.set_num_threads(1)  # see test_torch_spmm.py

GRAPHS = ["hub_skew", "empty_rows", "single_hub"]


def _graph(kind):
    if kind == "hub_skew":
        return hub_skew(160, 3, 0.1, 40, seed=1).dedup_edges()
    if kind == "single_hub":
        return single_hub(96, nnz_frac=0.9, seed=1).dedup_edges()
    # rows 8..31 empty (three row blocks own only their dummy slot), and
    # rows 2 and 45 empty inside row blocks that hold edges
    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 20)]
    deg[2] = deg[45] = 0
    rowptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    colind = rng.integers(0, 70, int(deg.sum())).astype(np.int32)
    return CSR(rowptr, colind, None, deg.size, 70).dedup_edges()


def _qkv(csr, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((csr.n_rows, d)).astype(np.float32),
            rng.standard_normal((csr.n_cols, d)).astype(np.float32),
            rng.standard_normal((csr.n_cols, d)).astype(np.float32))


def _pad(x, n):
    return np.concatenate([x, np.zeros((n - x.shape[0], x.shape[1]), np.float32)])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _mask(bell):
    return (bell.vals != 0).astype(np.float32)


@pytest.mark.parametrize("kind", GRAPHS)
def test_csr_oracles_match_jnp(kind):
    csr = _graph(kind)
    q, k, v = _qkv(csr, 24)
    rp, ci = jnp.asarray(csr.rowptr), jnp.asarray(csr.colind)
    trp, tci = _t(csr.rowptr, csr.colind)
    logits = pref.sddmm_ref(trp, tci, *_t(q, k))
    _close(logits, jref.sddmm_ref(rp, ci, jnp.asarray(q), jnp.asarray(k)))
    _close(pref.row_softmax_ref(trp, tci, logits),
           jref.row_softmax_ref(rp, ci, jnp.asarray(logits.numpy())))
    _close(pref.csr_attention_ref(trp, tci, *_t(q, k, v)),
           jref.csr_attention_ref(rp, ci, *map(jnp.asarray, (q, k, v))))


@pytest.mark.parametrize("kind", GRAPHS)
def test_block_ell_oracles_match_jnp(kind):
    csr = _graph(kind)
    bell = csr_to_block_ell(csr)
    q, k, v = _qkv(csr, 24)
    qp, kp, vp = _pad(q, bell.padded_rows), _pad(k, bell.n_col_blocks * 8), _pad(
        v, bell.n_col_blocks * 8)
    colblk, mask = bell.colblk, _mask(bell)
    tiles = pref.sddmm_block_ell_ref(*_t(colblk, mask, q, k), 8)
    _close(tiles, jref.sddmm_block_ell_ref(*map(jnp.asarray, (colblk, mask, qp, kp)), 8))
    _close(pref.row_softmax_block_ell_ref(tiles, torch.from_numpy(mask)),
           jref.row_softmax_block_ell_ref(jnp.asarray(tiles.numpy()), jnp.asarray(mask)))
    _close(pref.csr_attention_block_ell_ref(*_t(colblk, mask, q, k, v), 8),
           jref.csr_attention_block_ell_ref(
               *map(jnp.asarray, (colblk, mask, qp, kp, vp)), 8))


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("d", [16, 40])
def test_fused_plain_versions_match_pallas(kind, d):
    """Dense-W and ragged plain versions (the wrappers on CPU tensors)
    against the fused Pallas kernels in interpret mode and the CSR
    oracle; rows without edges come out 0."""
    csr = _graph(kind)
    bell = csr_to_block_ell(csr)
    rag = bell.to_ragged()
    q, k, v = _qkv(csr, d, seed=d)
    qp, kp, vp = (jnp.asarray(_pad(q, bell.padded_rows)),
                  jnp.asarray(_pad(k, bell.n_col_blocks * 8)),
                  jnp.asarray(_pad(v, bell.n_col_blocks * 8)))
    tq, tk, tv = _t(q, k, v)
    dense = ka.fused_csr_attention(*_t(bell.colblk, _mask(bell)), tq, tk, tv,
                                   n_rows=csr.n_rows)
    j_dense = jk.fused_csr_attention(jnp.asarray(bell.colblk), jnp.asarray(_mask(bell)),
                                     qp, kp, vp, interpret=True)
    _close(dense, np.asarray(j_dense)[: csr.n_rows])
    rmask = (rag.slot_vals != 0).astype(np.float32)
    ragged = ka.fused_ragged_attention(*_t(rag.blkptr, rag.slot_colblk, rmask),
                                       tq, tk, tv, n_rows=csr.n_rows)
    j_ragged = jk.fused_ragged_attention(
        *map(jnp.asarray, (rag.blkptr, rag.slot_rowblk, rag.slot_colblk, rmask)),
        qp, kp, vp, interpret=True)
    _close(ragged, np.asarray(j_ragged)[: csr.n_rows])
    _close(ragged, jref.csr_attention_ref(jnp.asarray(csr.rowptr), jnp.asarray(csr.colind),
                                          *map(jnp.asarray, (q, k, v))))
    empty = csr.degrees == 0
    assert not np.asarray(dense)[empty].any() and not np.asarray(ragged)[empty].any()
    if kind == "empty_rows":
        assert empty[8:32].all() and empty[2] and (csr.degrees[:8] > 0).sum() == 7


def _pipe_aux(csr, s, m):
    """The port's prepared aux of one composed pipe: numpy for JAX, and
    torch for the port."""
    v = next(v for v in registry._attention_variants(None, False)
             if v.knobs == {"sddmm": s, "spmm": m})
    aux = v.prepare(csr)
    return aux, {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for k, a in aux.items()}


PIPES = {
    ("gather_dot", "gather_segsum"): (kb.attention_csr, kx.attention_csr),
    ("row_ell", "row_ell"): (kb.attention_ell, kx.attention_ell),
    ("row_ell", "gather_segsum"): (kb.attention_ell_to_csr, kx.attention_ell_to_csr),
    ("gather_dot", "row_ell"): (kb.attention_csr_to_ell, kx.attention_csr_to_ell),
}


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("pipe", list(PIPES), ids=lambda p: f"{p[0]}+{p[1]}")
def test_composed_pipes_match_xla(kind, pipe):
    csr = _graph(kind)
    q, k, v = _qkv(csr, 24, seed=3)
    aux_np, aux_t = _pipe_aux(csr, *pipe)
    mine, theirs = PIPES[pipe]
    want = theirs({k_: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for k_, a in aux_np.items()}, *map(jnp.asarray, (q, k, v)))
    _close(mine(aux_t, *_t(q, k, v)), want)


def test_sddmm_stages_match_xla():
    csr = _graph("hub_skew")
    x, y, _ = _qkv(csr, 24, seed=4)
    aux_np, aux_t = _pipe_aux(csr, "row_ell", "gather_segsum")
    ell = {"colind": aux_np["ell_colind"], "val": aux_np["ell_val"]}
    _close(kb.sddmm_row_ell({k: torch.from_numpy(a) for k, a in ell.items()}, *_t(x, y)),
           kx.sddmm_row_ell({k: jnp.asarray(a) for k, a in ell.items()},
                            jnp.asarray(x), jnp.asarray(y)))
    _close(kb.sddmm_gather_dot(aux_t, *_t(x, y)),
           kx.sddmm_gather_dot({k: jnp.asarray(aux_np[k]) for k in ("rowptr", "colind")},
                               jnp.asarray(x), jnp.asarray(y)))
    val = np.random.default_rng(1).standard_normal(csr.nnz).astype(np.float32)
    _close(kb.row_softmax(aux_t, torch.from_numpy(val)),
           kx.row_softmax({k: jnp.asarray(aux_np[k]) for k in ("rowptr", "colind")},
                          jnp.asarray(val)))
    assert {k: a.tolist() for k, a in kb.prepare_edge_slots(csr).items()} == {
        k: a.tolist() for k, a in kx.prepare_edge_slots(
            JxCSR(csr.rowptr, csr.colind, None, csr.n_rows, csr.n_cols)).items()}


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub"])
def test_chunked_equals_unchunked(kind):
    """Every chunked oracle, plain version and pipe gives the same result
    with chunks of a few rows, row blocks or slots as in one chunk."""
    csr = _graph(kind)
    bell = csr_to_block_ell(csr)
    rag = bell.to_ragged()
    q, k, v = _t(*_qkv(csr, 24, seed=5))
    trp, tci = _t(csr.rowptr, csr.colind)
    small, whole = 24 * 5, 1 << 40
    for ch in (small, 24):
        _close(pref.csr_attention_ref(trp, tci, q, k, v, chunk_elems=ch),
               pref.csr_attention_ref(trp, tci, q, k, v, chunk_elems=whole))
        _close(pref.csr_attention_block_ell_ref(*_t(bell.colblk, _mask(bell)), q, k, v, 8,
                                                chunk_elems=ch),
               pref.csr_attention_block_ell_ref(*_t(bell.colblk, _mask(bell)), q, k, v, 8,
                                                chunk_elems=whole))
        rmask = (rag.slot_vals != 0).astype(np.float32)
        args = (*_t(rag.blkptr, rag.slot_colblk, rmask), q, k, v)
        _close(ka.fused_ragged_attention_plain(*args, chunk_elems=ch),
               ka.fused_ragged_attention_plain(*args, chunk_elems=whole))
        dargs = (*_t(bell.colblk, _mask(bell)), q, k, v)
        _close(ka.fused_csr_attention_plain(*dargs, chunk_elems=ch),
               ka.fused_csr_attention_plain(*dargs, chunk_elems=whole))
        for pipe, (fn, _) in PIPES.items():
            _, aux = _pipe_aux(csr, *pipe)
            _close(fn(aux, q, k, v, chunk_elems=ch), fn(aux, q, k, v, chunk_elems=whole))


def test_block_layouts_equal_jax():
    """The fused variants' prepared masks are the JAX package's
    ``(vals != 0)`` tables, made in place without a second copy."""
    csr = _graph("hub_skew")
    jcsr = JxCSR(csr.rowptr, csr.colind, None, csr.n_rows, csr.n_cols)
    jbell = jx_csr_to_block_ell(jcsr)
    dense = registry._prepare_attn_fused(csr, 8, 8)
    ragged = registry._prepare_attn_ragged(csr, 8, 8)
    assert np.array_equal(dense["mask"], (jbell.vals != 0).astype(np.float32))
    assert np.array_equal(dense["colblk"], jbell.colblk)
    jrag = jbell.to_ragged()
    assert np.array_equal(ragged["mask"], (jrag.slot_vals != 0).astype(np.float32))
    assert np.array_equal(ragged["blkptr"], jrag.blkptr)
    assert np.array_equal(ragged["slot_colblk"], jrag.slot_colblk)


def test_wrappers_reject_bad_operands():
    """On a CUDA tensor the wrapper launches or raises; the checks run
    before any launch, so the meta device stands in for a card."""
    dev = torch.device("meta")
    blkptr = torch.zeros(3, dtype=torch.int32, device=dev)
    cb = torch.zeros(2, dtype=torch.int32, device=dev)
    mask = torch.zeros(2, 8, 8, device=dev)
    q, kv = torch.zeros(16, 32, device=dev), torch.zeros(24, 32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ka.fused_ragged_attention(blkptr, cb, mask.double(), q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        ka.fused_ragged_attention(blkptr, cb, mask, torch.zeros(32, 16, device=dev).t(),
                                  kv, kv)
    with pytest.raises(ValueError, match="n_rows"):
        ka.fused_ragged_attention(blkptr, cb, mask, q, kv, kv, n_rows=17)
    with pytest.raises(ValueError, match="disagree on D"):
        ka.fused_ragged_attention(blkptr, cb, mask, q, kv, torch.zeros(24, 16, device=dev))
    with pytest.raises(ValueError, match="mask tiles"):
        ka.fused_ragged_attention(blkptr, cb, torch.zeros(2, 8, 4, device=dev), q, kv, kv)
    with pytest.raises(ValueError, match="does not match"):
        ka.fused_csr_attention(torch.zeros(2, 3, dtype=torch.int32, device=dev),
                               torch.zeros(2, 4, 8, 8, device=dev), q, kv, kv)
    big = torch.zeros(16, ka.MAX_D + 1, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        ka.fused_ragged_attention(blkptr, cb, mask, big, torch.zeros(24, ka.MAX_D + 1,
                                  device=dev), torch.zeros(24, ka.MAX_D + 1, device=dev))


def test_every_candidate_matches_the_oracle_with_zero_weight_edges(monkeypatch):
    """Every attention candidate (four pipes, two fused plain versions)
    computes the CSR oracle's function, and an edge stored with value 0
    stays in the pattern: attention reads structure only."""
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    base = _graph("hub_skew")
    val = np.ones(base.nnz, np.float32)
    val[::3] = 0.0
    csr = CSR(base.rowptr, base.colind, val, base.n_rows, base.n_cols)
    q, k, v = _qkv(csr, 24, seed=6)
    want = jref.csr_attention_ref(jnp.asarray(csr.rowptr), jnp.asarray(csr.colind),
                                  *map(jnp.asarray, (q, k, v)))
    feat = InputFeatures.from_csr(csr, 24, "attention")
    # a tiny hub_skew graph passes the row-ELL gates: all six candidates
    pool = registry.candidates(feat, HardwareSpec.cpu(), torch.device("cpu"))
    assert len(pool) == 6
    for cand in pool:
        run = cand.build(cand.prepare(csr), torch.device("cpu"))
        _close(run(*_t(q, k, v)), want)


def _layout_tensors(csr):
    bell = csr_to_block_ell(csr)
    rag = bell.to_ragged()
    rmask = (rag.slot_vals != 0).astype(np.float32)
    return bell, rag, _t(rag.blkptr, rag.slot_colblk, rmask), _t(bell.colblk, _mask(bell))


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("cs", [1, 3, 8, 32])
def test_chunk_table_covers_each_slot_once_with_the_same_bounds(kind, cs):
    """The kernels' chunks (chunk c of row block i: its slots c*cs ..
    (c+1)*cs - 1 counted from its first slot) cover each ragged slot once
    and each dense-W slot once, in slot order; ragged chunk c and dense-W
    chunk c of a row block hold the same live slots, and dense-W's extra
    chunks hold none. The workspace table gives each chunk of a split row
    block its own entry, within the wrapper's bound."""
    csr = _graph(kind)
    bell, rag, (blkptr, _, _), _ = _layout_tensors(csr)
    nrb, w = bell.n_row_blocks, bell.width
    rb_r, s0_r, s1_r = ka.chunk_bounds(blkptr, 0, nrb, cs)
    assert torch.equal(torch.cat([torch.arange(a, e) for a, e in
                                  zip(s0_r.tolist(), s1_r.tolist())]),
                       torch.arange(rag.n_slots))
    rb_d, s0_d, s1_d = ka.chunk_bounds(None, w, nrb, cs)
    assert torch.equal(torch.cat([torch.arange(a, e) for a, e in
                                  zip(s0_d.tolist(), s1_d.tolist())]),
                       torch.arange(nrb * w))
    nslots = np.maximum(bell.nslots, 1)
    for i in range(nrb):
        ragged = [(a - rag.blkptr[i], e - rag.blkptr[i])
                  for a, e in zip(s0_r[rb_r == i].tolist(), s1_r[rb_r == i].tolist())]
        # dense-W's slots past nslots (the dummy slot's place: past 1) are padding
        dense = [(a - i * w, min(e - i * w, int(nslots[i])))
                 for a, e in zip(s0_d[rb_d == i].tolist(), s1_d[rb_d == i].tolist())]
        assert ragged == dense[: len(ragged)]
        assert all(a >= e for a, e in dense[len(ragged):])
    chunk_ptr, ws_ptr = ka.ragged_chunk_table(blkptr, cs)
    n_ch = torch.diff(chunk_ptr.long())
    assert torch.equal(n_ch, torch.bincount(rb_r, minlength=nrb))
    n_ws = torch.diff(ws_ptr.long())
    assert torch.equal(n_ws, torch.where(n_ch > 1, n_ch, 0))
    assert int(chunk_ptr[-1]) <= nrb + rag.n_slots // cs
    assert int(ws_ptr[-1]) <= 2 * (rag.n_slots // cs)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("cs", [1, 3, 32])
def test_chunked_then_combined_matches_pallas(kind, cs):
    """The kernels' chunked computation in plain torch (per-chunk partial
    states folded in chunk order) matches the fused Pallas kernels in
    interpret mode, and its dense-W and ragged results are equal bit for
    bit."""
    csr = _graph(kind)
    bell, rag, rargs, dargs = _layout_tensors(csr)
    q, k, v = _qkv(csr, 16, seed=cs)
    tq, tk, tv = _t(q, k, v)
    ragged = ka.attention_chunks_plain(rargs[0], 0, *rargs[1:], tq, tk, tv,
                                       n_rows=csr.n_rows, cs=cs)
    dense = ka.attention_chunks_plain(None, bell.width, *dargs, tq, tk, tv,
                                      n_rows=csr.n_rows, cs=cs)
    assert torch.equal(ragged, dense)
    j_ragged = jk.fused_ragged_attention(
        *map(jnp.asarray, (rag.blkptr, rag.slot_rowblk, rag.slot_colblk,
                           rargs[2].numpy())),
        *(jnp.asarray(_pad(x, n)) for x, n in ((q, bell.padded_rows),
                                                (k, bell.n_col_blocks * 8),
                                                (v, bell.n_col_blocks * 8))),
        interpret=True)
    _close(ragged, np.asarray(j_ragged)[: csr.n_rows])
    assert not ragged[torch.from_numpy(csr.degrees == 0)].any()


def test_inf_and_nan_in_v_rows_paired_only_with_masked_cells_give_nan():
    """v holding +inf, -inf and NaN in rows that no edge reads but that
    share column blocks with rows edges do read (column j moved to 2j):
    the Pallas kernel in interpret mode and the plain version multiply
    whole tiles and agree on NaN (0 * inf in p.v); the CSR oracle stays
    finite. The CUDA kernels never read those rows and give the oracle's
    value (tests/test_torch_cuda.py, chip_smoke.py phase 5a)."""
    base = _graph("hub_skew")
    csr = CSR(base.rowptr, base.colind * 2, None, base.n_rows, 2 * base.n_cols)
    bell, rag, rargs, _ = _layout_tensors(csr)
    q, k, v = _qkv(csr, 16, seed=9)
    v[1::2] = np.array([np.inf, -np.inf, np.nan], np.float32)[
        np.arange(csr.n_cols // 2) % 3, None]
    plain = ka.fused_ragged_attention(*rargs, *_t(q, k, v), n_rows=csr.n_rows).numpy()
    j_ragged = np.asarray(jk.fused_ragged_attention(
        *map(jnp.asarray, (rag.blkptr, rag.slot_rowblk, rag.slot_colblk,
                           rargs[2].numpy())),
        *(jnp.asarray(_pad(x, n)) for x, n in ((q, bell.padded_rows),
                                                (k, bell.n_col_blocks * 8),
                                                (v, bell.n_col_blocks * 8))),
        interpret=True))[: csr.n_rows]
    assert np.isnan(plain).any()
    np.testing.assert_array_equal(np.isnan(plain), np.isnan(j_ragged))
    want = jref.csr_attention_ref(jnp.asarray(csr.rowptr), jnp.asarray(csr.colind),
                                  *map(jnp.asarray, (q, k, v)))
    assert np.isfinite(np.asarray(want)).all()
