"""The port's SDDMM slice on CPU tensors against the JAX package on the
same numpy inputs: the ragged and merge-path SDDMM oracles and the
backward oracles against repro.kernels.ref, the three SDDMM plain
versions against the Pallas kernels in interpret mode, and the
registry's SDDMM and runtime-valued SpMM runners against the JAX
registry's runners, variant for variant.

Tolerance rtol 1e-5, atol 1e-6 * max|ref|: both sides sum the same fp32
products in another order. The Pallas kernels multiply by the mask and
may leave -0.0 on masked cells where the port writes +0.0; the
comparisons treat the two zeros as equal. The cases cover row blocks
with only the dummy slot, explicit-zero edges (the mask comes from
structure), duplicate edges, a hub over many merge tiles, partial last
merge tiles, fully live clique tiles, F = 16, 41 (padded to 64 for the
Pallas kernels), 256 and 602, X and Y holding -0.0 in whole rows, and
+-inf and NaN in Y rows that only masked cells pair with (there the
Pallas kernels leave NaN on the masked cells and the port +0.0; live
cells agree)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as jx_registry
from repro.core.features import HardwareSpec as JxHw
from repro.core.features import InputFeatures as JxFeat
from repro.kernels import ref as jref
from repro.kernels import sddmm_pallas as jk
from repro.sparse import CSR as JxCSR
from repro.sparse import csr_to_block_ell as jx_csr_to_block_ell
from repro_torch.core import HardwareSpec, InputFeatures, registry
from repro_torch.kernels import ref as pref
from repro_torch.kernels import sddmm as ksd
from repro_torch.sparse import CSR, build_merge_path, csr_to_block_ell, hub_skew, single_hub

torch.set_num_threads(1)  # see test_torch_spmm.py

CPU = torch.device("cpu")
GRAPHS = ["empty_rows", "single_hub", "hub_skew"]


def _graph(kind):
    if kind == "hub_skew":  # duplicate edges: their mask cell is 1 once
        return hub_skew(150, 3, 0.1, 40, seed=1)
    if kind == "cliques":  # two block-diagonal 16-cliques: fully live tiles
        rows = np.repeat(np.arange(32), 16)
        cols = rows // 16 * 16 + np.tile(np.arange(16), 32)
        return CSR((np.arange(33) * 16).astype(np.int32), cols.astype(np.int32),
                   np.ones(512, np.float32), 32, 32)
    if kind == "single_hub":  # one hub row over many merge tiles
        return single_hub(128, nnz_frac=0.9, seed=1)
    # rows 8..31 empty (dummy slots), a quarter of the edges valued 0
    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 20)]
    nnz = int(deg.sum())
    val = rng.standard_normal(nnz).astype(np.float32)
    val[::4] = 0.0
    return CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
               rng.integers(0, 70, nnz).astype(np.int32), val, deg.size, 70)


def _jx(csr):
    return JxCSR(csr.rowptr, csr.colind, csr.val, csr.n_rows, csr.n_cols)


def _xy(csr, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((csr.n_rows, f)).astype(np.float32),
            rng.standard_normal((csr.n_cols, f)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _mask(a):
    return (a != 0).astype(np.float32)


# ------------------------------------------------------------- oracles
@pytest.mark.parametrize("kind", GRAPHS)
def test_layout_oracles_match_jnp(kind):
    csr = _graph(kind).structural()
    x, y = _xy(csr, 24)
    rag = csr_to_block_ell(csr).to_ragged()
    mask = _mask(rag.slot_vals)
    want = jref.sddmm_ragged_ell_ref(
        jnp.asarray(rag.slot_rowblk), jnp.asarray(rag.slot_colblk), jnp.asarray(mask),
        jnp.asarray(_pad(x, rag.padded_rows, 24)),
        jnp.asarray(_pad(y, rag.n_col_blocks * 8, 24)), 8)
    got = pref.sddmm_ragged_ell_ref(*_t(rag.slot_rowblk, rag.slot_colblk, mask, x, y), 8)
    _close(got, want)
    for ts in (3, 8, 16):
        mp = build_merge_path(rag, tile_slots=ts)
        tmask = _mask(mp.tile_vals)
        want = jref.sddmm_merge_path_ref(
            jnp.asarray(mp.blkptr), jnp.asarray(mp.slot_colblk), jnp.asarray(tmask),
            jnp.asarray(_pad(x, mp.padded_rows, 24)),
            jnp.asarray(_pad(y, mp.n_col_blocks * 8, 24)), mp.n_slots, 8)
        got = pref.sddmm_merge_path_ref(*_t(mp.blkptr, mp.slot_colblk, tmask, x, y),
                                        mp.n_slots, 8)
        _close(got, want)


@pytest.mark.parametrize("kind", GRAPHS)
def test_backward_oracles_match_jnp(kind):
    """The explicit VJP oracles, in small chunks (the chunked path the card
    takes at Reddit scale), against the JAX package's."""
    csr = _graph(kind)
    rng = np.random.default_rng(1)
    x, y = _xy(csr, 16)
    val = rng.standard_normal(csr.nnz).astype(np.float32)
    g_c = rng.standard_normal((csr.n_rows, 16)).astype(np.float32)
    g_e = rng.standard_normal(csr.nnz).astype(np.float32)
    rp, ci = jnp.asarray(csr.rowptr), jnp.asarray(csr.colind)
    trp, tci = _t(csr.rowptr, csr.colind)
    chunk = 512  # elements: many chunks even on these small graphs
    for got, want in zip(
        pref.spmm_bwd_ref(trp, tci, *_t(val, y, g_c), chunk_elems=chunk),
        jref.spmm_bwd_ref(rp, ci, jnp.asarray(val), jnp.asarray(y), jnp.asarray(g_c)),
    ):
        _close(got, want)
    for got, want in zip(
        pref.sddmm_bwd_ref(trp, tci, *_t(x, y, g_e), chunk_elems=chunk),
        jref.sddmm_bwd_ref(rp, ci, jnp.asarray(x), jnp.asarray(y), jnp.asarray(g_e)),
    ):
        _close(got, want)
    probs = np.asarray(jref.row_softmax_ref(rp, ci, jnp.asarray(val)))
    _close(pref.row_softmax_bwd_ref(trp, tci, *_t(probs, g_e)),
           jref.row_softmax_bwd_ref(rp, ci, jnp.asarray(probs), jnp.asarray(g_e)))
    if csr.n_rows == csr.n_cols:
        q, k = _xy(csr, 16, seed=2)
        v = rng.standard_normal((csr.n_cols, 16)).astype(np.float32)
        g_o = rng.standard_normal((csr.n_rows, 16)).astype(np.float32)
        for got, want in zip(
            pref.csr_attention_bwd_ref(trp, tci, *_t(q, k, v, g_o), chunk_elems=chunk),
            jref.csr_attention_bwd_ref(rp, ci, *map(jnp.asarray, (q, k, v, g_o))),
        ):
            _close(got, want)


# ------------------------------------------- plain versions vs Pallas
def _plain_and_pallas(csr, x, y):
    """(label, port output, Pallas output in interpret mode, mask) for
    dense-W and ragged at 8x8 and 16x8 and merge-path at tile_slots 3 and
    16, on the same numpy inputs. Checks on the way that the port's live
    tiles agree across layouts bit for bit and that its padded, dummy and
    tail tiles are +0.0."""
    f = x.shape[1]
    padded_f, chunk = jx_registry._sddmm_chunk(f)
    out = []
    for rb in (8, 16):
        jb = jx_csr_to_block_ell(_jx(csr), rb=rb, bc=8)
        bell = csr_to_block_ell(csr, rb=rb, bc=8)
        rag = bell.to_ragged()
        xp = jnp.asarray(_pad(x, bell.padded_rows, padded_f))
        yp = jnp.asarray(_pad(y, bell.n_col_blocks * 8, padded_f))
        dmask, rmask = _mask(bell.vals), _mask(rag.slot_vals)
        dense = ksd.sddmm_block_ell(*_t(bell.colblk, dmask, x, y))
        out.append((f"dense-W rb={rb}", dense, jk.sddmm_block_ell(
            jnp.asarray(jb.colblk), jnp.asarray(dmask), xp, yp, f_chunk=chunk,
            interpret=True), dmask))
        ragged = ksd.sddmm_ragged_ell(*_t(rag.slot_rowblk, rag.slot_colblk, rmask, x, y))
        out.append((f"ragged rb={rb}", ragged, jk.sddmm_ragged_ell(
            jnp.asarray(rag.slot_rowblk), jnp.asarray(rag.slot_colblk), jnp.asarray(rmask),
            xp, yp, f_chunk=chunk, interpret=True), rmask))
        live = np.arange(bell.width)[None, :] < np.maximum(bell.nslots, 1)[:, None]
        assert torch.equal(dense[torch.from_numpy(live)], ragged)
        assert not dense[torch.from_numpy(~live)].any()
        assert not torch.signbit(dense[dense == 0]).any()
        if rb == 16:
            continue
        for ts in (3, 16):
            mp = build_merge_path(rag, tile_slots=ts)
            tmask = _mask(mp.tile_vals)
            merged = ksd.sddmm_merge_path(*_t(mp.blkptr, mp.slot_colblk, mp.tile_rowblk,
                                              tmask, x, y))
            out.append((f"merge ts={ts}", merged, jk.sddmm_merge_path(
                jnp.asarray(mp.blkptr), jnp.asarray(mp.slot_colblk),
                jnp.asarray(mp.tile_rowblk), jnp.asarray(tmask), xp, yp,
                f_chunk=chunk, interpret=True), tmask))
            flat = merged.reshape(-1, 8, 8)
            assert torch.equal(flat[: mp.n_slots], ragged)
            assert not flat[mp.n_slots:].any()
    return out


@pytest.mark.parametrize("kind,f", [("empty_rows", 16), ("single_hub", 41),
                                    ("hub_skew", 256), ("empty_rows", 41),
                                    ("cliques", 602)])
def test_plain_versions_match_pallas(kind, f):
    """Dense-W and ragged at 8x8 and 16x8 and merge-path at tile_slots 3
    and 16 (a partial last tile in every case) against the Pallas kernels
    in interpret mode; the port's live tiles agree across layouts bit for
    bit, and its padded, dummy and tail tiles are +0.0. F = 16, 41, 256
    and 602, the F of chip_smoke's edge cases: Pallas f-chunks of 32 and
    64, two chunks of 128, and 19 of 32; on the cliques every stored tile
    is fully live."""
    csr = _graph(kind).structural()
    if kind == "cliques":
        assert (csr_to_block_ell(csr, rb=16, bc=8).to_ragged().slot_vals == 1).all()
    x, y = _xy(csr, f)
    for _, got, want, _ in _plain_and_pallas(csr, x, y):
        _close(got, want)


def test_negative_zero_rows_match_pallas():
    """X and Y holding -0.0 in whole rows: the plain versions agree with
    the Pallas kernels (both zeros compare equal), and the cells of the
    -0.0 X rows are zero."""
    csr = _graph("hub_skew").structural()
    x, y = _xy(csr, 24, seed=7)
    x[::3], y[1::4] = -0.0, -0.0
    for label, got, want, _ in _plain_and_pallas(csr, x, y):
        _close(got, want)
        if label == "ragged rb=8":
            rag = csr_to_block_ell(csr).to_ragged()
            rows = np.minimum(rag.slot_rowblk[:, None] * 8 + np.arange(8), csr.n_rows - 1)
            hit = torch.from_numpy(x[rows, 0] == 0)
            assert hit.any() and not got[hit].any()


def test_inf_and_nan_in_y_rows_only_masked_cells_pair_with():
    """Y holding +inf, -inf and NaN in rows that no edge reads (the
    graph's columns spread to even ones): the plain versions keep those
    masked cells +0.0 and agree with the Pallas kernels on every live
    cell; the Pallas kernels multiply by the mask and leave NaN there
    (ROADMAP.md Queue 3, SDDMM masked cells)."""
    s = _graph("hub_skew").structural()
    csr = CSR(s.rowptr, s.colind * 2, s.val, s.n_rows, 2 * s.n_cols)
    x, y = _xy(csr, 41, seed=8)
    y[1::6], y[3::6], y[5::6] = np.inf, -np.inf, np.nan
    for label, got, want, mask in _plain_and_pallas(csr, x, y):
        live = torch.from_numpy(mask > 0)
        assert torch.isfinite(got).all(), label
        assert not got[~live].any() and not torch.signbit(got[~live]).any(), label
        _close(got[live], np.asarray(want)[mask > 0])
        assert np.isnan(np.asarray(want)[..., 1::2]).any(), label


def test_wrappers_check_their_operands():
    csr = _graph("hub_skew").structural()
    rag = csr_to_block_ell(csr, rb=8, bc=16).to_ragged()
    x, y = _xy(csr, 16)
    # the kernels are built for 8x8 and 16x8; the plain version takes any
    assert ksd.sddmm_ragged_ell(*_t(rag.slot_rowblk, rag.slot_colblk,
                                    _mask(rag.slot_vals), x, y)).shape == (rag.n_slots, 8, 16)
    assert ksd.n_bisect(1) == 3 and ksd.n_bisect(7281) == 14
    with pytest.raises(ValueError, match="disagree on F"):
        ksd._check("sddmm_ragged_ell", torch.zeros(1, 8, 8), torch.zeros(2, 3),
                   torch.zeros(2, 4))
    with pytest.raises(ValueError, match="tiles"):
        ksd._check("sddmm_ragged_ell", torch.zeros(1, 8, 16), torch.zeros(2, 3),
                   torch.zeros(2, 3))


# ----------------------------------------------------- registry runners
def _jx_feat(feat):
    return JxFeat(**dataclasses.asdict(feat))


def _pairs(feat):
    """(port variant, its JAX twin) for every candidate of ``feat``."""
    pool = registry.candidates(feat, HardwareSpec.cpu(), CPU, include_kernels=True)
    twins = {
        (v.name, tuple(sorted((k, x) for k, x in v.knobs.items() if k != "f_tile"))): v
        for v in jx_registry.candidates(_jx_feat(feat), JxHw.cpu(), include_pallas=True)
        if v.knobs.get("f_tile", 128) == 128
    }
    return [(v, twins[(registry.PORTED_FROM[v.name], tuple(sorted(v.knobs.items())))])
            for v in pool]


@pytest.mark.parametrize("kind", GRAPHS)
def test_sddmm_runners_match_jax_registry(kind):
    """Every SDDMM candidate's runner (op "attention_bwd_e") against its
    JAX twin's on the same graph and operands: the per-edge CSR-ordered
    vector, explicit-zero edges included."""
    csr = _graph(kind)
    feat = InputFeatures.from_csr(csr.structural(), 16, "attention_bwd_e")
    x, y = _xy(csr, 16, seed=3)
    pairs = _pairs(feat)
    assert {v.name for v, _ in pairs} >= {"gather_dot", "block_ell_cuda", "ragged_ell_cuda",
                                          "merge_path_cuda"}
    for v, twin in pairs:
        got = v.build(v.prepare(csr.structural()), CPU)(*_t(x, y))
        want = twin.build(twin.prepare(_jx(csr).structural()))(jnp.asarray(x), jnp.asarray(y))
        _close(got, want)
        if kind == "empty_rows":
            zero = torch.from_numpy(csr.val == 0)
            assert bool((got[zero] != 0).all()), v.full_name()


@pytest.mark.parametrize("kind", GRAPHS)
def test_dynamic_values_runners_match_jax_registry(kind):
    """Every runtime-valued SpMM candidate (op "attention_bwd_q") against
    its JAX twin's; on hub_skew duplicate edges share a cell and their
    values add up. Two calls give the same bits."""
    csr = _graph(kind)
    feat = InputFeatures.from_csr(csr, 32, "attention_bwd_q")
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(csr.nnz).astype(np.float32)
    b = rng.standard_normal((csr.n_cols, 32)).astype(np.float32)
    pairs = _pairs(feat)
    assert {v.name for v, _ in pairs} >= {"gather_segsum", "ragged_ell_cuda", "merge_path_cuda"}
    for v, twin in pairs:
        run = v.build(v.prepare(csr), CPU)
        got = run(*_t(vals, b))
        want = twin.build(twin.prepare(_jx(csr)))(jnp.asarray(vals), jnp.asarray(b))
        _close(got, want)
        assert torch.equal(got, run(*_t(vals, b)))


def test_layout_memo_shares_one_conversion(monkeypatch):
    """Two ops on one structure convert it once; another blocking, other
    values or a full memo convert anew. Shared tables are never written:
    a multigraph's mask is a clipped copy."""
    calls = []
    real = registry.csr_to_ragged
    monkeypatch.setattr(registry, "csr_to_ragged",
                        lambda *a: calls.append(a[1:]) or real(*a))
    monkeypatch.setattr(registry, "LAYOUT_MEMO_MIN_NNZ", 0)
    registry.clear_layout_memo()
    s = _graph("hub_skew")
    csr = CSR(s.rowptr, s.colind, np.full(s.nnz, 0.5, np.float32), s.n_rows, s.n_cols)
    a = registry._prep_sddmm_ragged(s, 8, 8)
    b = registry._prep_ragged_dyn(s, 8, 8)
    assert calls == [(8, 8)]
    assert a["slot_colblk"] is b["slot_colblk"]
    rag = registry.ragged_layout(s, 8, 8)[0]
    assert rag.slot_vals.max() > 1 and a["mask"].max() == 1  # duplicates: a copy
    registry._prep_sddmm_ragged(s, 16, 8)
    registry._prep_block_ell(csr, 8, 8, ragged=True)  # values of their own
    assert calls == [(8, 8), (16, 8), (8, 8)]
    monkeypatch.setattr(registry, "LAYOUT_MEMO_CAP", 1)
    registry.clear_layout_memo()
    for rb in (8, 16, 8):  # each evicts the other
        registry._prep_sddmm_ragged(s, rb, 8)
    assert calls[3:] == [(8, 8), (16, 8), (8, 8)]
    monkeypatch.setattr(registry, "LAYOUT_MEMO_MIN_NNZ", s.nnz + 1)
    registry._prep_sddmm_ragged(s, 8, 8)  # below the threshold: not memoized
    assert len(calls) == 7
    registry.clear_layout_memo()
