"""The port's SpMM kernel wrappers on CPU tensors (their plain versions)
against the JAX package's Pallas kernels in interpret mode and its jnp
oracles, on the same numpy inputs.

Tolerance rtol 1e-5, atol 1e-6 * max|ref|-scaled: both sides sum the same
fp32 products, in another order. The cases cover every blocking,
tile_slots in {3, 8, 16} (a partial last merge tile whenever the slot
count is not a multiple), row blocks with only the all-zero dummy slot,
a single hub row spanning many merge tiles, and the sign of exact zeros
(the -0.0 guard on merge-path tail slots)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import spmm_pallas as jk
from repro.sparse import CSR, csr_to_block_ell, power_law, single_hub
from repro.sparse import build_merge_path
from repro_torch.kernels import ref as pref
from repro_torch.kernels import spmm as pk

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default pool (one thread per core in every worker)
# oversubscribes the cores; tests elsewhere that time kernels by wall
# clock (tests/test_drift.py) then misread their probes.
torch.set_num_threads(1)

F = 32


def _graph(kind):
    if kind == "power_law":
        return power_law(120, 1.4, avg_deg=4, n_cols=90, seed=3)
    if kind == "single_hub":
        return single_hub(256, nnz_frac=0.9, seed=1)
    # rows 8..31 empty: three row blocks own only their dummy slot
    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 20)]
    rowptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    colind = rng.integers(0, 70, int(deg.sum())).astype(np.int32)
    val = rng.standard_normal(int(deg.sum())).astype(np.float32)
    return CSR(rowptr, colind, val, deg.size, 70)


def _b(csr, bc):
    """B padded to whole column blocks (the Pallas kernels need it); the
    port's wrappers get the first n_cols rows only."""
    n_pad = -(-csr.n_cols // bc) * bc
    b = np.random.default_rng(7).standard_normal((n_pad, F)).astype(np.float32)
    b[csr.n_cols:] = 0.0
    return b


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def _csr_ref(csr, b):
    v = None if csr.val is None else jnp.asarray(csr.val)
    return jref.spmm_ref(jnp.asarray(csr.rowptr), jnp.asarray(csr.colind), v,
                         jnp.asarray(b[: csr.n_cols]))


@pytest.mark.parametrize("kind", ["power_law", "single_hub", "empty_blocks"])
@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_ragged_and_block_ell_plain_match_pallas(kind, rb, bc):
    csr = _graph(kind)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    rag = bell.to_ragged()
    b = _b(csr, bc)
    tb = torch.from_numpy(b[: csr.n_cols])
    ragged = pk.spmm_ragged_ell(
        torch.from_numpy(rag.blkptr), torch.from_numpy(rag.slot_colblk),
        torch.from_numpy(rag.slot_vals), tb, n_rows=csr.n_rows,
    )
    j_ragged = jk.spmm_ragged_ell(
        jnp.asarray(rag.blkptr), jnp.asarray(rag.slot_rowblk),
        jnp.asarray(rag.slot_colblk), jnp.asarray(rag.slot_vals),
        jnp.asarray(b), f_tile=F, interpret=True,
    )
    _close(ragged, np.asarray(j_ragged)[: csr.n_rows])
    _close(ragged, _csr_ref(csr, b))
    if bc == 8:  # dense-W runs the (8, 8) and (16, 8) blockings, as in repro
        dense = pk.spmm_block_ell(
            torch.from_numpy(bell.colblk), torch.from_numpy(bell.vals), tb,
            n_rows=csr.n_rows,
        )
        j_dense = jk.spmm_block_ell(
            jnp.asarray(bell.colblk), jnp.asarray(bell.vals), jnp.asarray(b),
            f_tile=F, interpret=True,
        )
        _close(dense, np.asarray(j_dense)[: csr.n_rows])
        # the padded-rows oracle form: the port's layout oracle == jnp's
        _close(
            pref.spmm_block_ell_ref(
                torch.from_numpy(bell.colblk), torch.from_numpy(bell.vals), tb, bc
            ),
            jref.spmm_block_ell_ref(
                jnp.asarray(bell.colblk), jnp.asarray(bell.vals), jnp.asarray(b), bc
            ),
        )


@pytest.mark.parametrize("kind", ["power_law", "single_hub", "empty_blocks"])
@pytest.mark.parametrize("tile_slots", [3, 8, 16])
def test_merge_path_plain_matches_pallas(kind, tile_slots):
    csr = _graph(kind)
    rag = csr_to_block_ell(csr, rb=8, bc=8).to_ragged()
    mp = build_merge_path(rag, tile_slots=tile_slots)
    if kind == "single_hub":  # the hub's row block spans many merge tiles
        assert (mp.tile_rowblk == 0).sum() >= 2
    b = _b(csr, 8)
    b[: csr.n_cols] *= -1.0  # negative B: zero tiles give -0.0 products
    out = pk.spmm_merge_path(
        torch.from_numpy(mp.blkptr), torch.from_numpy(mp.slot_colblk),
        torch.from_numpy(mp.tile_rowblk), torch.from_numpy(mp.tile_offset),
        torch.from_numpy(mp.tile_vals), torch.from_numpy(b[: csr.n_cols]),
        mp.n_slots, n_rows=csr.n_rows,
    ).numpy()
    j_out = np.asarray(jk.spmm_merge_path(
        jnp.asarray(mp.blkptr), jnp.asarray(mp.slot_colblk),
        jnp.asarray(mp.tile_rowblk), jnp.asarray(mp.tile_nslots),
        jnp.asarray(mp.tile_vals), jnp.asarray(b), f_tile=F, interpret=True,
    ))[: csr.n_rows]
    _close(out, j_out)
    _close(out, _csr_ref(csr, b))
    _close(
        pref.spmm_merge_path_ref(
            torch.from_numpy(mp.blkptr), torch.from_numpy(mp.slot_colblk),
            torch.from_numpy(mp.tile_vals), torch.from_numpy(b), mp.n_slots, 8,
        ),
        jref.spmm_merge_path_ref(
            jnp.asarray(mp.blkptr), jnp.asarray(mp.slot_colblk),
            jnp.asarray(mp.tile_vals), jnp.asarray(b), mp.n_slots, 8,
        ),
    )
    zeros = j_out == 0.0
    assert np.array_equal(np.signbit(out[zeros]), np.signbit(j_out[zeros]))


@pytest.mark.parametrize("kind", ["power_law", "empty_blocks"])
def test_csr_ref_matches_jnp(kind):
    """The chunked, segment_reduce-based CSR oracle (also the gather_segsum
    baseline) == jnp's, for every chunk size down to one row per chunk."""
    csr = _graph(kind)
    b = _b(csr, 8)[: csr.n_cols]
    want = _csr_ref(csr, b)
    val = None if csr.val is None else torch.from_numpy(csr.val)
    for chunk in (pref.CHUNK_ELEMS, F * 7, 1):
        got = pref.spmm_ref(torch.from_numpy(csr.rowptr), torch.from_numpy(csr.colind),
                            val, torch.from_numpy(b), chunk_elems=chunk)
        _close(got, want)


def test_wrappers_reject_bad_operands():
    """On a CUDA tensor the wrapper launches or raises; the operand checks
    run before any launch, so they are testable wherever the tensors live
    on one device (here: the meta device stands in for a card)."""
    dev = torch.device("meta")
    blkptr = torch.zeros(3, dtype=torch.int32, device=dev)
    colblk = torch.zeros(2, dtype=torch.int32, device=dev)
    vals = torch.zeros(2, 8, 8, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        pk.spmm_ragged_ell(blkptr, colblk, vals, torch.zeros(8, 4, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        pk.spmm_ragged_ell(blkptr, colblk, vals, torch.zeros(4, 8, device=dev).t())
    with pytest.raises(ValueError, match="n_rows"):
        pk.spmm_ragged_ell(blkptr, colblk, vals, torch.zeros(8, 4, device=dev), n_rows=17)
