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


# ------------------------------------------- launch geometry (host side)
def _runs(n_tiles):
    per_run, n_runs = pk.merge_runs(n_tiles)
    return per_run, n_runs, [range(r * per_run, min((r + 1) * per_run, n_tiles))
                             for r in range(n_runs)]


@pytest.mark.parametrize("n_tiles", [1, 2, 8191, 8192, 8193, 3 * 8192 + 1, 2**20, "hub"])
def test_merge_runs_cover_every_tile_once(n_tiles):
    """Every merge tile lies in exactly one run, runs are consecutive and
    non-empty, and there are at most MERGE_MAX_RUNS of them: the carry
    buffer (one panel per run) always holds every run. A single hub row
    block that spans many tiles spans several runs when the tiles
    outnumber the runs."""
    if n_tiles == "hub":
        rag = csr_to_block_ell(single_hub(4096, nnz_frac=0.9, seed=1), rb=8, bc=8).to_ragged()
        mp = build_merge_path(rag, tile_slots=3)
        n_tiles = mp.n_tiles
        assert n_tiles > 8
    per_run, n_runs, runs = _runs(n_tiles)
    assert 1 <= n_runs <= pk.MERGE_MAX_RUNS
    assert all(len(r) >= 1 for r in runs)
    assert [t for r in runs for t in r] == list(range(n_tiles))
    assert max(len(r) for r in runs) == per_run
    assert (n_runs - 1) * per_run < n_tiles <= n_runs * per_run


@pytest.mark.parametrize("f", [1, 3, 4, 41, 128, 129, 256, 602, 1000])
def test_feature_chunks_cover_every_column_once(f):
    """The kernels' lane -> column map (4 columns per lane, F_CHUNK per
    warp) covers each of the f columns once, in both the float4 and the
    scalar mapping; only the last chunk's warp has idle lanes, at most a
    warp-tail of them; f_tile is the columns one warp covers."""
    n_chunks = pk.n_chunks(f)
    assert n_chunks == -(-f // pk.f_tile(f))
    assert pk.f_tile(f) == min(pk.F_CHUNK, -(-f // 32) * 32)
    for vec in ([True, False] if f % 4 == 0 else [False]):
        cols = []
        for chunk in range(n_chunks):
            owned = [pk.lane_columns(f, chunk, lane, vec) for lane in range(pk.WARP)]
            idle = sum(not c for c in owned)
            assert idle == 0 or chunk == n_chunks - 1
            assert idle < pk.WARP
            cols += [c for lane_cols in owned for c in lane_cols]
        assert sorted(cols) == list(range(f))


@pytest.mark.parametrize("kind", ["power_law", "single_hub", "empty_blocks"])
def test_rowblock_order_is_a_longest_first_permutation(kind):
    """The ragged kernel's warps take every row block once, longest slot
    chain first, ties in row-block order."""
    rag = csr_to_block_ell(_graph(kind), rb=8, bc=8).to_ragged()
    blkptr = torch.from_numpy(rag.blkptr)
    order = pk.rowblock_order(blkptr)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(blkptr.shape[0] - 1))
    lengths = torch.diff(blkptr)[order.long()]
    assert bool((lengths[:-1] >= lengths[1:]).all())
    ties = [(int(n), int(i)) for n, i in zip(lengths, order)]
    assert ties == sorted(ties, key=lambda t: (-t[0], t[1]))


def _merge_model(mp, b, per_run, n_runs):
    """The merge kernel's decomposition on the CPU: one run of per_run
    tiles at a time, a row block that starts inside the run written to
    the output, the run's first row block to its carry panel when the run
    starts mid-row-block; then the fixup adds each chain of carries to
    its row block in run order. Products per slot as in the oracle."""
    ts = mp.tile_slots
    slot_vals = torch.from_numpy(mp.tile_vals.reshape(-1, 8, 8))
    n_cb = -(-b.shape[0] // 8)
    bb = torch.cat([b, b.new_zeros(n_cb * 8 - b.shape[0], b.shape[1])]).reshape(n_cb, 8, -1)
    nrb = mp.blkptr.shape[0] - 1
    out = torch.zeros(nrb, 8, b.shape[1])
    carry = torch.zeros(n_runs, 8, b.shape[1])
    rowblk, offset = mp.tile_rowblk, mp.tile_offset
    for run in range(n_runs):
        t0 = run * per_run
        s_end = min((t0 + per_run) * ts, mp.n_slots)
        i, to_carry = int(rowblk[t0]), bool(offset[t0] > 0)
        acc = torch.zeros(8, b.shape[1])
        for s in range(t0 * ts, s_end):
            while s >= mp.blkptr[i + 1]:
                (carry[run] if to_carry else out[i]).copy_(acc)
                to_carry, i, acc = False, i + 1, torch.zeros_like(acc)
            acc += slot_vals[s] @ bb[mp.slot_colblk[s]]
        (carry[run] if to_carry else out[i]).copy_(acc)
    for run in range(n_runs):
        t0 = run * per_run
        if offset[t0] == 0:
            continue
        row = rowblk[t0]
        if run > 0 and offset[t0 - per_run] > 0 and rowblk[t0 - per_run] == row:
            continue
        for c in range(run, n_runs):
            tc = c * per_run
            if c > run and (offset[tc] == 0 or rowblk[tc] != row):
                break
            out[row] += carry[c]
    return out.reshape(nrb * 8, -1)


@pytest.mark.parametrize("kind", ["single_hub", "empty_blocks"])
@pytest.mark.parametrize("tile_slots", [3, 8])
@pytest.mark.parametrize("max_runs", [2, 5, 64, 8192])
def test_merge_run_partition_and_fixup_reproduce_the_oracle(monkeypatch, kind, tile_slots,
                                                            max_runs):
    """The run partition plus carry fixup that the merge kernel uses sums
    every slot of every row block once: runs of one tile up to runs of
    many, rows that straddle runs, a hub whose chain spans several runs."""
    monkeypatch.setattr(pk, "MERGE_MAX_RUNS", max_runs)
    csr = _graph(kind)
    mp = build_merge_path(csr_to_block_ell(csr, rb=8, bc=8).to_ragged(), tile_slots=tile_slots)
    per_run, n_runs = pk.merge_runs(mp.n_tiles)
    b = torch.from_numpy(_b(csr, 8)[: csr.n_cols])
    got = _merge_model(mp, b, per_run, n_runs)[: csr.n_rows]
    want = pk.spmm_merge_path_plain(
        torch.from_numpy(mp.blkptr), torch.from_numpy(mp.slot_colblk),
        torch.from_numpy(mp.tile_vals), b, mp.n_slots, n_rows=csr.n_rows)
    _close(got, want)


@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_inf_and_nan_in_b_rows_paired_only_with_zeros_give_nan_in_whole_tile_products(rb, bc):
    """The premise of the CUDA kernels' one departure (ROADMAP Queue 3):
    B holds +inf, -inf and NaN in rows that no edge reads but that share a
    column block with rows that edges do read. The Pallas kernel (interpret
    mode) and the port's plain versions multiply whole tiles and give NaN
    there (0 * inf); the CSR product (ref.spmm_ref) is finite. The card
    test pins the kernels to the CSR product."""
    g = _graph("power_law")  # column j -> 2j: no edge reads an odd column
    csr = CSR(g.rowptr, g.colind * 2, g.val, g.n_rows, 2 * g.n_cols)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    rag = bell.to_ragged()
    b = _b(csr, bc)
    # odd columns of the last whole column block (dense-W's padded slots
    # point at block 0, so a trap there would poison every row block)
    first = (csr.n_cols // bc - 1) * bc
    b[[first + 1, first + 3, first + 5]] = np.array([np.inf, -np.inf, np.nan], np.float32)[:, None]
    tb = torch.from_numpy(b[: csr.n_cols])
    val = torch.from_numpy(csr.val) if csr.val is not None else None
    want = pref.spmm_ref(torch.from_numpy(csr.rowptr), torch.from_numpy(csr.colind), val, tb)
    assert torch.isfinite(want).all()
    ragged = pk.spmm_ragged_ell(torch.from_numpy(rag.blkptr), torch.from_numpy(rag.slot_colblk),
                                torch.from_numpy(rag.slot_vals), tb, n_rows=csr.n_rows)
    dense = pk.spmm_block_ell(torch.from_numpy(bell.colblk), torch.from_numpy(bell.vals), tb,
                              n_rows=csr.n_rows)
    j_ragged = np.asarray(jk.spmm_ragged_ell(
        jnp.asarray(rag.blkptr), jnp.asarray(rag.slot_rowblk), jnp.asarray(rag.slot_colblk),
        jnp.asarray(rag.slot_vals), jnp.asarray(b), f_tile=F, interpret=True))[: csr.n_rows]
    nan = np.isnan(j_ragged)
    assert nan.any() and (nan.any(axis=1) == nan.all(axis=1)).all()
    for out in (ragged.numpy(), dense.numpy()):
        assert np.array_equal(np.isnan(out), nan)
    finite = ~nan.any(axis=1)
    assert finite.any()
    _close(ragged.numpy()[finite], want.numpy()[finite])
