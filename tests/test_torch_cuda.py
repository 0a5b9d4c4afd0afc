"""repro_torch's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU with sm_90a and nvcc; without one they skip.
Run them on such a machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: |kernel - plain| <= 1e-4 * |plain| + 1e-4 * max|plain| (the
same fp32 products summed in another order; for attention, an online
softmax against the plain version's two-pass one). Dense-W equals ragged
bit for bit, and merge-path and the attention kernels are bit-equal from
launch to launch. The three SDDMM kernels give equal live tiles bit for
bit, and all-zero (+0.0) padded, dummy and tail tiles."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import probe as probe_mod
from repro_torch.kernels import attention as ka
from repro_torch.kernels import sddmm as ksd
from repro_torch.kernels import spmm as ks
from repro_torch.models.gnn import norm_csr
from repro_torch.sparse import (
    CSR,
    build_merge_path,
    csr_to_block_ell,
    hub_skew,
    single_hub,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _graph(kind):
    if kind == "single_hub":
        return norm_csr(single_hub(4096, nnz_frac=0.9, seed=1))
    if kind == "empty_zeros":
        # rows 8..31 empty (three row blocks own only their dummy slot),
        # and every third edge carries an explicit 0.0 value
        rng = np.random.default_rng(5)
        deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
        val = rng.standard_normal(int(deg.sum())).astype(np.float32)
        val[::3] = 0.0
        return CSR(np.r_[0, np.cumsum(deg)].astype(np.int32),
                   rng.integers(0, 70, int(deg.sum())).astype(np.int32), val, deg.size, 70)
    return norm_csr(hub_skew(3000, 4, 0.05, 300, seed=2))


def _spread(csr):
    """csr with column j moved to 2j: every odd column (half of each column
    block) is read by no edge."""
    return CSR(csr.rowptr, csr.colind * 2, csr.val, csr.n_rows, 2 * csr.n_cols)


def _close(got, want):
    tol = 1e-4 * want.abs() + 1e-4 * want.abs().max()
    assert ((got - want).abs() <= tol).all()


def _b(csr, f, device):
    g = torch.Generator().manual_seed(f)
    return torch.randn(csr.n_cols, f, generator=g).to(device)


def _ragged_args(csr, rb, bc, device):
    rag = csr_to_block_ell(csr, rb=rb, bc=bc).to_ragged()
    return [torch.from_numpy(a).to(device) for a in (rag.blkptr, rag.slot_colblk, rag.slot_vals)]


def _merge_args(csr, tile_slots, device):
    mp = build_merge_path(csr_to_block_ell(csr).to_ragged(), tile_slots=tile_slots)
    t = [torch.from_numpy(a).to(device) for a in
         (mp.blkptr, mp.slot_colblk, mp.tile_rowblk, mp.tile_offset, mp.tile_vals)]
    return t, mp


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub", "empty_zeros"])
@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
@pytest.mark.parametrize("f", [1, 3, 41, 128, 256, 602])
def test_ragged_and_dense_w_kernels(cuda, kind, rb, bc, f):
    """Every blocking at widths that are and are not multiples of 4 (the
    float4 and the scalar column mappings), on tiles with explicit-zero
    edges and row blocks that hold only the dummy slot."""
    csr = _graph(kind)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    b = _b(csr, f, cuda)
    args = _ragged_args(csr, rb, bc, cuda)
    before = ks.LAUNCHES["spmm_ragged_ell"]
    ragged = ks.spmm_ragged_ell(*args, b, n_rows=csr.n_rows)
    assert ks.LAUNCHES["spmm_ragged_ell"] == before + 1
    _close(ragged, ks.spmm_ragged_ell_plain(*args, b, n_rows=csr.n_rows))
    dense = ks.spmm_block_ell(
        torch.from_numpy(bell.colblk).to(cuda), torch.from_numpy(bell.vals).to(cuda),
        b, n_rows=csr.n_rows,
    )
    assert torch.equal(dense, ragged)
    if kind == "empty_zeros":
        empty = torch.from_numpy(csr.degrees == 0).to(cuda)
        assert not ragged[empty].any()


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub", "empty_zeros"])
@pytest.mark.parametrize("tile_slots", [3, 8, 16])
@pytest.mark.parametrize("f", [3, 256, 602])
@pytest.mark.parametrize("max_runs", [None, 5])
def test_merge_path_kernel(cuda, monkeypatch, kind, tile_slots, f, max_runs):
    """Merge-path against its plain version and within tolerance of
    ragged; two launches bit-equal. max_runs = 5 forces long runs of many
    tiles, so rows straddle runs mid-run and carry chains are long."""
    if max_runs is not None:
        monkeypatch.setattr(ks, "MERGE_MAX_RUNS", max_runs)
    csr = _graph(kind)
    t, mp = _merge_args(csr, tile_slots, cuda)
    b = _b(csr, f, cuda)
    out = ks.spmm_merge_path(*t, b, mp.n_slots, n_rows=csr.n_rows)
    _close(out, ks.spmm_merge_path_plain(t[0], t[1], t[4], b, mp.n_slots, n_rows=csr.n_rows))
    _close(out, ks.spmm_ragged_ell(*_ragged_args(csr, 8, 8, cuda), b, n_rows=csr.n_rows))
    assert torch.equal(out, ks.spmm_merge_path(*t, b, mp.n_slots, n_rows=csr.n_rows))


@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_inf_and_nan_in_b_rows_paired_only_with_zeros(cuda, rb, bc):
    """B holds +inf, -inf and NaN in rows that no edge reads but that share
    a column block with rows that edges do read. The plain versions (like
    the Pallas kernels) multiply whole tiles and give NaN there; the
    kernels skip the zeros and agree with the CSR product (ref.spmm_ref)."""
    from repro_torch.kernels import ref

    csr = _spread(_graph("hub_skew"))
    b = _b(csr, 64, cuda)
    b[1::2] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                           device=cuda).repeat(csr.n_cols)[: csr.n_cols // 2, None]
    want = ref.spmm_ref(*(torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind, csr.val)), b)
    assert torch.isfinite(want).all()
    args = _ragged_args(csr, rb, bc, cuda)
    ragged = ks.spmm_ragged_ell(*args, b, n_rows=csr.n_rows)
    assert torch.isnan(ks.spmm_ragged_ell_plain(*args, b, n_rows=csr.n_rows)).any()
    _close(ragged, want)
    bell = csr_to_block_ell(csr, rb=rb, bc=bc)
    dense = ks.spmm_block_ell(torch.from_numpy(bell.colblk).to(cuda),
                              torch.from_numpy(bell.vals).to(cuda), b, n_rows=csr.n_rows)
    assert torch.equal(dense, ragged)
    if (rb, bc) == (8, 8):
        t, mp = _merge_args(csr, 8, cuda)
        _close(ks.spmm_merge_path(*t, b, mp.n_slots, n_rows=csr.n_rows), want)


def test_unaligned_b_takes_the_scalar_column_path(cuda):
    """B at a 4-byte offset (F % 4 == 0, but not 16-byte aligned) goes
    through the scalar column mapping and gives the float4 path's bits."""
    csr = _graph("hub_skew")
    b = _b(csr, 256, cuda)
    storage = torch.empty(b.numel() + 1, device=cuda)
    shifted = storage[1:].view_as(b)
    shifted.copy_(b)
    assert not ks.vec4(shifted, shifted) and ks.vec4(b, b)
    for args in (_ragged_args(csr, 8, 8, cuda), _ragged_args(csr, 16, 8, cuda)):
        assert torch.equal(ks.spmm_ragged_ell(*args, shifted, n_rows=csr.n_rows),
                           ks.spmm_ragged_ell(*args, b, n_rows=csr.n_rows))


def test_wrapper_raises_instead_of_falling_back(cuda):
    csr = _graph("hub_skew")
    rag = csr_to_block_ell(csr).to_ragged()
    with pytest.raises(TypeError):
        ks.spmm_ragged_ell(
            torch.from_numpy(rag.blkptr).to(cuda).long(),
            torch.from_numpy(rag.slot_colblk).to(cuda),
            torch.from_numpy(rag.slot_vals).to(cuda), _b(csr, 64, cuda),
        )


def _cliques(n_cliques, size):
    """Block-diagonal cliques of ``size`` nodes: at size 16 every 8x8 and
    16x8 tile of the diagonal has all its cells live."""
    n = n_cliques * size
    rows = np.repeat(np.arange(n), size)
    cols = rows // size * size + np.tile(np.arange(size), n)
    return CSR((np.arange(n + 1) * size).astype(np.int32), cols.astype(np.int32),
               np.ones(n * size, np.float32), n, n)


def _attn_graph(kind):
    """Deduplicated graphs: a skewed one, one hub over 512 slots, one with
    empty row blocks and rows without edges in non-empty blocks, and
    block-diagonal cliques (fully live tiles)."""
    if kind == "hub_skew":
        return hub_skew(3000, 4, 0.05, 300, seed=2).dedup_edges()
    if kind == "single_hub":
        return single_hub(4096, nnz_frac=0.9, seed=1).dedup_edges()
    if kind == "cliques":
        return _cliques(25, 16).structural()
    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(1, 6, 8), np.zeros(24, np.int64), rng.integers(1, 6, 21)]
    deg[2] = deg[45] = 0
    colind = rng.integers(0, 70, int(deg.sum())).astype(np.int32)
    return CSR(np.r_[0, np.cumsum(deg)].astype(np.int32), colind, None, deg.size,
               70).dedup_edges()


def _attn_args(csr, device):
    bell = csr_to_block_ell(csr)
    rag = bell.to_ragged()
    rargs = [torch.from_numpy(a).to(device) for a in
             (rag.blkptr, rag.slot_colblk, (rag.slot_vals != 0).astype(np.float32))]
    dargs = [torch.from_numpy(a).to(device) for a in
             (bell.colblk, (bell.vals != 0).astype(np.float32))]
    return rargs, dargs


def _check_attention(csr, q, k, v, device, want=None, cs=None):
    """Both attention kernels once each (counted), in chunks of ``cs``
    slots (default: the wrappers'), against their plain versions (or
    ``want``); dense-W == ragged bit for bit, a second launch bit-equal,
    rows without edges 0. Returns the ragged output."""
    rargs, dargs = _attn_args(csr, device)
    before = dict(ka.LAUNCHES)
    ragged = ka.fused_ragged_attention(*rargs, q, k, v, n_rows=csr.n_rows, cs=cs)
    dense = ka.fused_csr_attention(*dargs, q, k, v, n_rows=csr.n_rows, cs=cs)
    torch.cuda.synchronize()
    assert ka.LAUNCHES["fused_ragged_attention"] == before["fused_ragged_attention"] + 1
    assert ka.LAUNCHES["fused_csr_attention"] == before["fused_csr_attention"] + 1
    _close(ragged, ka.fused_ragged_attention_plain(*rargs, q, k, v, n_rows=csr.n_rows)
           if want is None else want)
    _close(dense, ka.fused_csr_attention_plain(*dargs, q, k, v, n_rows=csr.n_rows)
           if want is None else want)
    assert torch.equal(dense, ragged)
    assert torch.equal(ragged, ka.fused_ragged_attention(*rargs, q, k, v, n_rows=csr.n_rows,
                                                         cs=cs))
    empty = torch.from_numpy(csr.degrees == 0).to(device)
    assert not ragged[empty].any()
    return ragged


def _most_chunks(csr, cs):
    """The most chunks of ``cs`` slots any row block of csr's ragged 8x8
    layout is split into (1: no row block is split, no combine runs)."""
    blkptr = torch.from_numpy(csr_to_block_ell(csr).to_ragged().blkptr)
    return int(torch.diff(ka.ragged_chunk_table(blkptr, cs)[0]).max())


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub", "empty_rows", "cliques"])
@pytest.mark.parametrize("d", [41, 64, 256, 602, 1000])
@pytest.mark.parametrize("chunk", [32, None, 1 << 30])
def test_fused_attention_kernels(cuda, kind, d, chunk):
    """Both attention kernels against their plain versions, with row
    blocks split into chunks of 32 slots (the single hub's 512 slots into
    16, every D), in the wrappers' default chunks (chunk_slots(D): 256
    slots up to D = 256, so the hub splits in 2 there and not at D = 602
    or 1000) and unsplit; D = 41 and 602 take the scalar column path,
    D = 1000 the launch path above 48 KB of dynamic shared memory."""
    csr = _attn_graph(kind)
    if kind == "single_hub":
        cs = ka.chunk_slots(d) if chunk is None else chunk
        assert _most_chunks(csr, cs) == -(-512 // cs)
    g = torch.Generator().manual_seed(d)
    q = torch.randn(csr.n_rows, d, generator=g).to(cuda)
    k = torch.randn(csr.n_cols, d, generator=g).to(cuda)
    v = torch.randn(csr.n_cols, d, generator=g).to(cuda)
    _check_attention(csr, q, k, v, cuda, cs=chunk)


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub"])
@pytest.mark.parametrize("chunk", [32, 1 << 30])
def test_fused_attention_rescales_when_a_later_slot_raises_the_max(cuda, kind, chunk):
    """Logits rising by ~40 along each row's columns: every later slot
    raises the row's max, so the online rescale (and, split into chunks
    of 32 slots, the combine's) carries the result."""
    csr = _attn_graph(kind)
    assert (_most_chunks(csr, chunk) > 1) == (chunk == 32)
    d = 64
    g = torch.Generator().manual_seed(3)
    u = torch.ones(d) / d ** 0.5
    ramp = torch.arange(csr.n_cols, dtype=torch.float32) / csr.n_cols
    q = 0.1 * torch.randn(csr.n_rows, d, generator=g) + u
    k = 0.1 * torch.randn(csr.n_cols, d, generator=g) + (40.0 * d ** 0.5) * ramp[:, None] * u
    v = torch.randn(csr.n_cols, d, generator=g)
    _check_attention(csr, q.to(cuda), k.to(cuda), v.to(cuda), cuda, cs=chunk)


@pytest.mark.parametrize("d", [41, 256])
def test_fused_attention_inf_and_nan_in_v_rows_only_masked_cells_pair_with(cuda, d):
    """v holding +inf, -inf and NaN in rows no edge reads (every odd
    column): the kernels never read them and match the CSR oracle; the
    plain versions, like the Pallas kernels, give NaN there."""
    from repro_torch.kernels import ref

    csr = _spread(_attn_graph("hub_skew"))
    g = torch.Generator().manual_seed(d)
    q = torch.randn(csr.n_rows, d, generator=g).to(cuda)
    k = torch.randn(csr.n_cols, d, generator=g).to(cuda)
    v = torch.randn(csr.n_cols, d, generator=g)
    v[1::6], v[3::6], v[5::6] = float("inf"), float("-inf"), float("nan")
    v = v.to(cuda)
    rp, ci = (torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind))
    want = ref.csr_attention_ref(rp, ci, q, k, v)
    assert torch.isfinite(want).all()
    _check_attention(csr, q, k, v, cuda, want=want)
    rargs, _ = _attn_args(csr, cuda)
    assert torch.isnan(ka.fused_ragged_attention_plain(*rargs, q, k, v,
                                                       n_rows=csr.n_rows)).any()


def _sddmm_graph(kind):
    """Structural graphs for the SDDMM kernels: a skewed multigraph (mask
    cells of duplicate edges), one hub over many merge tiles, one with
    empty row blocks (dummy slots), and block-diagonal cliques (fully
    live tiles)."""
    if kind == "hub_skew":
        return hub_skew(3000, 4, 0.05, 300, seed=2)
    if kind == "single_hub":
        return single_hub(4096, nnz_frac=0.9, seed=1)
    if kind == "cliques":
        return _cliques(25, 16)
    return _attn_graph("empty_rows")


def _up(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sddmm_all(csr, rb, x, y, device):
    """The ragged and dense-W SDDMM kernels on csr's rb x 8 layouts
    against their plain versions, and their live tiles bit-equal; padded
    tiles +0.0. Returns (ragged output, its operands, the layouts)."""
    bell = csr_to_block_ell(csr, rb=rb, bc=8)
    rag = bell.to_ragged()
    rargs = (_up(rag.slot_rowblk, device), _up(rag.slot_colblk, device),
             _up(np.minimum(rag.slot_vals, 1.0), device))
    dargs = (_up(bell.colblk, device), _up(np.minimum(bell.vals, 1.0), device))
    ragged = ksd.sddmm_ragged_ell(*rargs, x, y)
    dense = ksd.sddmm_block_ell(*dargs, x, y)
    _close(ragged, ksd.sddmm_ragged_ell_plain(*rargs, x, y))
    _close(dense, ksd.sddmm_block_ell_plain(*dargs, x, y))
    live = _up(np.arange(bell.width)[None, :] < np.maximum(bell.nslots, 1)[:, None], device)
    assert torch.equal(dense[live], ragged)
    assert not dense[~live].any() and not torch.signbit(dense[~live]).any()
    return ragged, rargs, bell, rag


@pytest.mark.parametrize("kind", ["hub_skew", "single_hub", "empty_rows", "cliques"])
@pytest.mark.parametrize("rb", [8, 16])
@pytest.mark.parametrize("f", [16, 41, 256, 602])
def test_sddmm_kernels(cuda, kind, rb, f):
    """Each SDDMM kernel against its plain version; the live tiles of the
    three layouts are bit-equal; padded, dummy and tail tiles are +0.0;
    no -0.0 anywhere; a second launch gives the same bits. On the
    cliques every stored tile is fully live."""
    csr = _sddmm_graph(kind).structural()
    g = torch.Generator().manual_seed(f)
    x = torch.randn(csr.n_rows, f, generator=g).to(cuda)
    y = torch.randn(csr.n_cols, f, generator=g).to(cuda)

    before = dict(ksd.LAUNCHES)
    ragged, rargs, bell, rag = _sddmm_all(csr, rb, x, y, cuda)
    assert ksd.LAUNCHES["sddmm_ragged_ell"] == before["sddmm_ragged_ell"] + 1
    assert ksd.LAUNCHES["sddmm_block_ell"] == before["sddmm_block_ell"] + 1
    if kind == "cliques":
        assert (rag.slot_vals == 1).all()
    assert torch.equal(ragged, ksd.sddmm_ragged_ell(*rargs, x, y))
    assert not torch.signbit(ragged[ragged == 0]).any()
    dummy_slots = rag.blkptr[:-1][bell.nslots == 0]
    assert not ragged[_up(dummy_slots, cuda).long()].any()
    if rb == 8:
        for ts in (3, 8, 16):
            mp = build_merge_path(rag, tile_slots=ts)
            margs = [_up(a, cuda) for a in (mp.blkptr, mp.slot_colblk, mp.tile_rowblk,
                                            np.minimum(mp.tile_vals, 1.0))]
            merged = ksd.sddmm_merge_path(*margs, x, y)
            _close(merged, ksd.sddmm_merge_path_plain(*margs, x, y))
            flat = merged.reshape(-1, 8, 8)
            assert torch.equal(flat[: mp.n_slots], ragged)
            assert not flat[mp.n_slots:].any()
            assert torch.equal(merged, ksd.sddmm_merge_path(*margs, x, y))


@pytest.mark.parametrize("rb", [8, 16])
def test_sddmm_negative_zero_rows_give_plus_zero(cuda, rb):
    """X and Y holding -0.0 in whole rows: the live cells that pair such a
    row read +0.0, and no cell of any layout is -0.0."""
    csr = _sddmm_graph("hub_skew").structural()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(csr.n_rows, 64, generator=g)
    y = torch.randn(csr.n_cols, 64, generator=g)
    x[::3] = -0.0
    y[1::4] = -0.0
    x, y = x.to(cuda), y.to(cuda)
    ragged, _, _, rag = _sddmm_all(csr, rb, x, y, cuda)
    assert not torch.signbit(ragged[ragged == 0]).any()
    rows = torch.arange(rb, device=cuda)
    x_zero = torch.signbit(x[:, 0]) & (x[:, 0] == 0)
    rowblk = _up(rag.slot_rowblk, cuda).long()
    hit = x_zero[(rowblk[:, None] * rb + rows).clamp(max=csr.n_rows - 1)]
    assert hit.any() and not ragged[hit].any()


@pytest.mark.parametrize("rb", [8, 16])
def test_sddmm_inf_and_nan_in_y_rows_only_masked_cells_pair_with(cuda, rb):
    """Y holding +inf, -inf and NaN in rows that no edge reads (every odd
    column): the masked cells of those rows stay +0.0 and the live cells
    match the plain version, so the whole output is finite."""
    csr = _spread(_sddmm_graph("hub_skew")).structural()
    g = torch.Generator().manual_seed(8)
    x = torch.randn(csr.n_rows, 41, generator=g).to(cuda)
    y = torch.randn(csr.n_cols, 41, generator=g)
    y[1::6], y[3::6], y[5::6] = float("inf"), float("-inf"), float("nan")
    ragged, _, _, _ = _sddmm_all(csr, rb, x, y.to(cuda), cuda)
    assert torch.isfinite(ragged).all()
    assert not ragged[..., 1::2].any() and not torch.signbit(ragged[..., 1::2]).any()


def test_sddmm_explicit_zero_edges_keep_their_dot(cuda):
    """The mask comes from structure: an edge whose value is 0 still gets
    <X_i, Y_j> through the registry's ragged SDDMM runner on the card."""
    from repro_torch.core import registry
    from repro_torch.kernels import ref

    csr = hub_skew(500, 4, 0.05, 60, seed=3).dedup_edges()
    val = np.ones(csr.nnz, np.float32)
    val[::5] = 0.0
    weighted = CSR(csr.rowptr, csr.colind, val, csr.n_rows, csr.n_cols)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(csr.n_rows, 41, generator=g).to(cuda)
    y = torch.randn(csr.n_cols, 41, generator=g).to(cuda)
    rp, ci = (torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind))
    build = registry._build_sddmm(ksd.sddmm_ragged_ell, ("slot_rowblk", "slot_colblk", "mask"))
    run = build(registry._prep_sddmm_ragged(weighted, 8, 8), cuda)
    _close(run(x, y), ref.sddmm_ref(rp, ci, x, y))


@pytest.mark.parametrize("op", ["attention_bwd_q", "spmm_dyn"])
def test_dynamic_values_runners_on_the_card(cuda, op):
    """The runtime-valued ragged and merge runners (per-call scatter into
    the layout) against the segment-sum oracle, on a multigraph whose
    duplicate edges share a cell; two calls give the same bits."""
    from repro_torch.core import HardwareSpec, InputFeatures, registry
    from repro_torch.kernels import ref

    csr = hub_skew(3000, 4, 0.05, 300, seed=2)
    assert csr.has_duplicate_edges()
    feat = InputFeatures.from_csr(csr, 64, op)
    g = torch.Generator().manual_seed(3)
    vals = torch.randn(csr.nnz, generator=g).to(cuda)
    b = torch.randn(csr.n_cols, 64, generator=g).to(cuda)
    rp, ci = (torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind))
    want = ref.spmm_ref(rp, ci, vals, b)
    kernels = [v for v in registry.candidates(feat, HardwareSpec.h100(), cuda)
               if v.name in ("ragged_ell_cuda", "merge_path_cuda")]
    assert len(kernels) == 3
    for v in kernels:
        run = v.build(v.prepare(csr), cuda)
        out = run(vals, b)
        _close(out, want)
        assert torch.equal(out, run(vals, b))


# ------------------------------------------------------ row softmax
def _softmax_case(case, rb, bc):
    """(logits, mask) on the softmax's traps: row blocks and rows fully
    masked, NaN and +-inf logits on masked cells, logits x5 and +-80, mask
    values -1, 0.5 and 2, a row of finfo.min logits; W = 3, 1 or 2048."""
    w = {"traps": 3, "w1": 1, "w2048": 2048}[case]
    rng = np.random.default_rng(w + rb)
    shape = (6 if w < 2048 else 3, w, rb, bc)
    vals = (rng.standard_normal(shape) * 5).astype(np.float32)
    vals[1] = rng.choice([-80.0, 80.0], size=shape[1:])
    mask = rng.choice([-1.0, 0.0, 0.5, 1.0, 2.0], size=shape,
                      p=[0.1, 0.35, 0.15, 0.3, 0.1]).astype(np.float32)
    mask[0] = 0.0
    mask[2, :, 1, :] = 0.0
    vals[2, :, 3, :] = np.finfo(np.float32).min  # the Pallas kernel zeroes this row
    mask[2, :, 3, :2] = 1.0
    dead = mask <= 0
    vals[dead & (rng.random(shape) < 0.3)] = np.nan
    vals[dead & (rng.random(shape) < 0.3)] = np.inf
    vals[dead & (rng.random(shape) < 0.3)] = -np.inf
    return vals, mask


@pytest.mark.parametrize("case", ["traps", "w1", "w2048"])
@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_row_softmax_kernel(cuda, case, rb, bc):
    from repro_torch.kernels import softmax as ksm

    vals, mask = (torch.from_numpy(a).to(cuda) for a in _softmax_case(case, rb, bc))
    before = ksm.LAUNCHES["row_softmax_block_ell"]
    out = ksm.row_softmax_block_ell(vals, mask)
    assert ksm.LAUNCHES["row_softmax_block_ell"] == before + 1
    torch.cuda.synchronize()
    want = ksm.row_softmax_block_ell_plain(vals, mask)
    assert torch.isfinite(out).all()
    _close(out, want)
    dead = mask <= 0
    assert not out[dead].any() and not torch.signbit(out[dead]).any()
    assert not out[2, :, 3].any()  # the finfo.min row
    assert torch.equal(out, ksm.row_softmax_block_ell(vals, mask))


def test_row_softmax_kernel_refuses_other_blockings(cuda):
    from repro_torch.kernels import softmax as ksm

    vals = torch.zeros((2, 2, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="tiles"):
        ksm.row_softmax_block_ell(vals, vals)


def test_ops_entry_point_on_the_card(cuda):
    """kernels.ops with impl="auto" on CUDA tensors runs the kernels: the
    SDDMM -> row softmax -> dense-W SpMM chain equals the fused kernel."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.kernels import softmax as ksm

    csr = _attn_graph("hub_skew")
    q, k, v = (torch.randn(n, 64, generator=torch.Generator().manual_seed(s)).to(cuda)
               for s, n in ((1, csr.n_rows), (2, csr.n_cols), (3, csr.n_cols)))
    bell = csr_to_block_ell(csr)
    colblk = torch.from_numpy(bell.colblk).to(cuda)
    mask = torch.from_numpy((bell.vals != 0).astype(np.float32)).to(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        logits = ops.sddmm(csr, q, k) * 64 ** -0.5
        before = ksm.LAUNCHES["row_softmax_block_ell"]
        probs = ops.row_softmax(logits, mask)
        assert ksm.LAUNCHES["row_softmax_block_ell"] == before + 1
        fused = ops.csr_attention(csr, q, k, v)
        want = ops.csr_attention(csr, q, k, v, impl="ref")
    composed = ks.spmm_block_ell(colblk, probs, v, n_rows=csr.n_rows)
    _close(composed, fused)
    _close(fused, want)


# ------------------------------------------- drift with real kernels
def _hidden_hubs(n, n_cols, hub_frac, hub_deg, seed):
    """n x n_cols graph of degree 18 with ``hub_frac`` rows of degree
    ``hub_deg``; n_cols = 1024 keeps every row block's slot count at the
    128 column blocks, so hubs leave the padding-waste bin alone."""
    from repro_torch.sparse import csr_from_coo

    rng = np.random.default_rng(seed)
    deg = np.full(n, 18)
    deg[rng.choice(n, int(n * hub_frac), replace=False)] = hub_deg
    rows = np.repeat(np.arange(n), deg)
    return csr_from_coo(rows, rng.integers(0, n_cols, rows.size), n, n_cols)


def test_drift_reprobe_flips_decision_real_kernels(cuda):
    """Twin of tests/test_drift.py's real-kernel test, on the card with
    wall-clock observations: a bucket pinned to row_ell (padded ELL) sees
    uniform degree-18 graphs, then graphs of the same bucket with hidden
    hubs (deg_max 500: the bins cannot see them, row-ELL's padded work
    grows 28x); the drift detector flags the bucket and the re-probe on
    the newest graph flips the decision away from row_ell."""
    import time

    from repro_torch.core import AutoSage, BatchScheduler, ScheduleCache

    f, n, n_cols = 32, 32768, 1024
    stream = [_hidden_hubs(n, n_cols, 0.0, 18, seed=i) for i in range(8)] + [
        _hidden_hubs(n, n_cols, 0.004, 500, seed=100 + i) for i in range(10)]
    cache = ScheduleCache(path=None)
    bs = BatchScheduler(AutoSage(cache=cache, device=cuda, probe_iters=2, probe_cap_ms=50,
                                 probe_frac=0.5), probe_budget_ms=60_000)
    first = bs.bucket_of(stream[0], f, "spmm")
    assert all(bs.bucket_of(g, f, "spmm") == first for g in stream)  # one bucket
    key = ScheduleCache.bucket_key(first.device, first.sig(), f, "spmm", bs.sage.alpha)
    cache.put(key, {"choice": "row_ell", "probe_ms": {}, "estimates_ms": {}})
    rng = np.random.default_rng(0)
    choices = []
    for g in stream:
        b = torch.from_numpy(rng.standard_normal((g.n_cols, f)).astype(np.float32)).to(cuda)
        d = bs.decide(g, f, "spmm")
        run = bs.build_runner(g, d)
        run(b)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        bs.observe(bs.last_bucket, sorted(times)[1])
        choices.append(d.choice)
    s = bs.stats()
    assert s["buckets"] == 1 and choices[0] == "row_ell", (s, choices)
    assert s["drift_reprobes"] >= 1 and s["drift_flips"] >= 1, (s, choices)
    assert choices[-1] != "row_ell", choices


# ------------------------------------------- fleet and cross-device tier
def _ref_spmm(csr, b):
    from repro_torch.kernels import ref

    dev = b.device
    val = None if csr.val is None else torch.from_numpy(np.asarray(csr.val, np.float32)).to(dev)
    return ref.spmm_ref(torch.from_numpy(csr.rowptr).to(dev),
                        torch.from_numpy(csr.colind).to(dev), val, b)


def test_run_faults_fall_back_quarantine_and_recover_on_the_card(cuda, tmp_path, monkeypatch):
    """Chip-smoke phase 12a at a small size: run faults injected on a
    pinned ragged_ell_cuda serve the baseline without launching the
    kernel, count one fault and one fallback each, quarantine the
    candidate (a replay-only scheduler then raises ReplayMiss), and
    after the TTL the half-open call launches the kernel again."""
    import time

    from repro_torch.core import (
        AutoSage,
        InputFeatures,
        ReplayMiss,
        ScheduleCache,
        device_sig,
        faultinject,
        obs,
        registry,
    )

    csr = _graph("hub_skew")
    b = _b(csr, 256, cuda)
    want = _ref_spmm(csr, b)
    path = str(tmp_path / "c.json")
    sage = AutoSage(device=cuda, cache=ScheduleCache(path=path))
    feat = InputFeatures.from_csr(csr, 256, "spmm")
    choice = next(v.full_name() for v in registry.candidates(feat, sage.hw, cuda)
                  if v.name == "ragged_ell_cuda" and v.knobs["rb"] == 8 and v.knobs["bc"] == 8)
    sage.cache.put(ScheduleCache.key(device_sig(cuda), feat.graph_sig, 256, "spmm", sage.alpha),
                   {"choice": choice, "probe_ms": {}, "estimates_ms": {}})
    monkeypatch.setenv("AUTOSAGE_FAULT_RETRIES", "0")
    monkeypatch.setenv("AUTOSAGE_BREAKER_N", "3")
    monkeypatch.setenv("AUTOSAGE_QUARANTINE_TTL_S", "1")
    runner = sage.build_runner(csr, sage.decide(csr, 256, "spmm"))
    _close(runner(b), want)
    faults0 = obs.REGISTRY.total("autosage_faults_total")
    fallbacks0 = obs.REGISTRY.total("autosage_fallback_total")
    launches0 = ks.LAUNCHES["spmm_ragged_ell"]
    monkeypatch.setenv("AUTOSAGE_FAULT", "run:ragged_ell_cuda:raise:3")
    faultinject.reset()
    for _ in range(3):
        _close(runner(b), want)
    monkeypatch.delenv("AUTOSAGE_FAULT")
    faultinject.reset()
    assert ks.LAUNCHES["spmm_ragged_ell"] == launches0
    assert obs.REGISTRY.total("autosage_faults_total") == faults0 + 3
    assert obs.REGISTRY.total("autosage_fallback_total") == fallbacks0 + 3
    assert sage.breaker.is_quarantined(choice)
    with pytest.raises(ReplayMiss, match="quarantined"):
        AutoSage(device=cuda, cache=ScheduleCache(path=path, replay_only=True)).decide(
            csr, 256, "spmm")
    time.sleep(1.2)
    _close(runner(b), want)
    assert ks.LAUNCHES["spmm_ragged_ell"] == launches0 + 1
    assert not sage.breaker.is_quarantined(choice)


def test_legacy_csr_attention_on_the_card(cuda, tmp_path):
    """Chip-smoke phase 12b at a small size: the legacy op decides the
    baseline; a legacy entry pinned to the ragged fused kernel replays
    it (one launch) within the tolerance."""
    from repro_torch.core import AutoSage, InputFeatures, ScheduleCache, device_sig, registry
    from repro_torch.kernels import ref

    csr = hub_skew(3000, 4, 0.05, 300, seed=2).dedup_edges()
    q, k, v = (_b(csr, 64 + i, cuda)[:, :64].contiguous() for i in range(3))
    rp, ci = (torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind))
    want = ref.csr_attention_ref(rp, ci, q, k, v)
    sage = AutoSage(device=cuda, cache=ScheduleCache(path=None))
    d = sage.decide(csr, 64, "csr_attention")
    assert d.choice == "baseline" and d.estimates_ms == {}
    _close(sage.build_runner(csr, d)(q, k, v), want)
    feat = InputFeatures.from_csr(csr, 64, "csr_attention")
    name = next(v_.full_name() for v_ in registry.candidates(feat, sage.hw, cuda)
                if v_.name == "ragged_attention_cuda")
    path = str(tmp_path / "legacy.json")
    ScheduleCache(path=path).put(
        ScheduleCache.key(device_sig(cuda), feat.graph_sig, 64, "csr_attention", sage.alpha),
        {"choice": name, "probe_ms": {}, "estimates_ms": {}})
    replay = AutoSage(device=cuda, cache=ScheduleCache(path=path, replay_only=True))
    d = replay.decide(csr, 64, "csr_attention")
    before = ka.LAUNCHES["fused_ragged_attention"]
    _close(replay.build_runner(csr, d)(q, k, v), want)
    assert d.from_cache and ka.LAUNCHES["fused_ragged_attention"] == before + 1


def test_transfer_from_a_cpu_donor_to_the_card(cuda, tmp_path, monkeypatch):
    """Chip-smoke phase 12c at a small size: the port on the CPU (kernel
    families' plain versions probed) donates its ranking; the card's
    decide carries the CPU provenance, a confident transfer runs no
    probe, and the output matches the reference either way."""
    from repro_torch.core import AutoSage, ScheduleCache, obs

    csr = _graph("hub_skew")
    path = str(tmp_path / "t.json")
    monkeypatch.setenv("AUTOSAGE_PROBE_PALLAS", "1")
    donor = AutoSage(device="cpu", cache=ScheduleCache(path=path), probe_iters=1)
    assert donor.decide(csr, 64, "spmm").probe_ms
    monkeypatch.delenv("AUTOSAGE_PROBE_PALLAS")
    sage = AutoSage(device=cuda, cache=ScheduleCache(path=path), probe_iters=1)
    passes0 = obs.REGISTRY.total("autosage_probe_passes_total", op="spmm")
    d = sage.decide(csr, 64, "spmm")
    assert d.transfer is not None and d.transfer["source_device"].startswith("cpu:")
    if not d.probe_ms:
        assert d.transfer["verdict"] == "confirmed"
        assert obs.REGISTRY.total("autosage_probe_passes_total", op="spmm") == passes0
    b = _b(csr, 64, cuda)
    _close(sage.build_runner(csr, d)(b), _ref_spmm(csr, b))


def test_probe_times_the_device_not_the_hosts_launching(cuda):
    """A call that keeps the host busy for 0.5 ms before one small launch
    reads about the launch alone: the probe queues it behind a spin of
    the device, so the events do not wait on the host."""
    x = torch.zeros(1024, device=cuda)

    def call():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 5e-4:
            pass
        return x.add_(1.0)

    assert probe_mod.time_callable(call, cuda, iters=5).median_ms < 0.25


# ------------------------------------------- grouped (GQA) attention
def _band(n=512, window=64):
    from repro_torch.models.attention import band_csr

    return band_csr(n, window, 1)


def _gqa_graph(kind):
    return _band() if kind == "band" else _attn_graph(kind)


def _gqa_inputs(csr, h, hkv, d, device, seed=0, pad=0):
    """q (n_rows, h, d) and k, v (n_cols, hkv, d), each a view of a buffer
    whose heads are ``d + pad`` floats apart (pad 0: contiguous)."""
    g = torch.Generator().manual_seed(seed)

    def make(n, heads):
        return torch.randn(n, heads, d + pad, generator=g).to(device)[:, :, :d]

    return make(csr.n_rows, h), make(csr.n_cols, hkv), make(csr.n_cols, hkv)


def _check_gqa(csr, q, k, v, device, cs=None):
    """The grouped kernel on both layouts (one launch each, counted)
    against the per-head kernel on every head and the CSR oracle (within
    2.29e-5 of max |ref|, the kernels' recorded error); dense-W == ragged
    bit for bit, a second launch bit-equal, rows without edges 0. Returns
    the ragged output."""
    from repro_torch.kernels import ref

    rargs, dargs = _attn_args(csr, device)
    before = dict(ka.LAUNCHES)
    ragged = ka.fused_ragged_attention_gqa(*rargs, q, k, v, n_rows=csr.n_rows, cs=cs)
    dense = ka.fused_csr_attention_gqa(*dargs, q, k, v, n_rows=csr.n_rows, cs=cs)
    torch.cuda.synchronize()
    assert ka.LAUNCHES["fused_ragged_attention_gqa"] == before["fused_ragged_attention_gqa"] + 1
    assert ka.LAUNCHES["fused_csr_attention_gqa"] == before["fused_csr_attention_gqa"] + 1
    assert ragged.shape == (csr.n_rows, q.shape[1], q.shape[2])
    assert torch.equal(dense, ragged)
    assert torch.equal(ragged, ka.fused_ragged_attention_gqa(*rargs, q, k, v,
                                                             n_rows=csr.n_rows, cs=cs))
    per_head = ka.by_head(lambda qh, kh, vh: ka.fused_ragged_attention(
        *rargs, qh, kh, vh, n_rows=csr.n_rows, cs=cs), q, k, v)
    _close(ragged, per_head)
    rp, ci = (torch.from_numpy(a).to(device) for a in (csr.rowptr, csr.colind))
    want = ka.by_head(lambda qh, kh, vh: ref.csr_attention_ref(rp, ci, qh, kh, vh), q, k, v)
    assert (ragged - want).abs().max() <= 2.29e-5 * want.abs().max()
    empty = torch.from_numpy(csr.degrees == 0).to(device)
    assert not ragged[empty].any()
    return ragged


@pytest.mark.parametrize("kind", ["band", "hub_skew", "empty_rows", "cliques"])
@pytest.mark.parametrize("d", [64, 100, 128, 256])
@pytest.mark.parametrize("g,hkv", [(1, 1), (4, 1), (8, 1), (1, 4), (4, 4), (8, 4)])
def test_grouped_attention_kernel(cuda, kind, d, g, hkv):
    """The grouped kernel at every width it takes, G = H / Hkv in {1, 4,
    8} over 1 or 4 KV heads, on the causal band, a skewed graph, empty
    row blocks and rows past the ends of q, k and v (53 rows, 70 columns),
    and fully live tiles."""
    csr = _gqa_graph(kind)
    q, k, v = _gqa_inputs(csr, g * hkv, hkv, d, cuda, seed=d + g)
    _check_gqa(csr, q, k, v, cuda)


@pytest.mark.parametrize("chunk", [32, None, 1 << 30])
@pytest.mark.parametrize("d", [64, 128])
def test_grouped_attention_split_row_blocks(cuda, chunk, d):
    """One hub over 512 slots, split into chunks of 32 slots (16 chunks
    folded by the grouped combine), in the default chunks (2) and unsplit."""
    csr = _attn_graph("single_hub")
    cs = ka.chunk_slots(d) if chunk is None else chunk
    assert _most_chunks(csr, cs) == -(-512 // cs)
    q, k, v = _gqa_inputs(csr, 8, 2, d, cuda, seed=7)
    _check_gqa(csr, q, k, v, cuda, cs=chunk)


@pytest.mark.parametrize("pad", [4, 1])
def test_grouped_attention_takes_strided_heads(cuda, pad):
    """q, k and v as views whose heads lie d + pad floats apart: pad 4
    keeps the 16-byte pieces (the vector path), pad 1 takes the float path;
    both equal the contiguous inputs' output bit for bit."""
    csr = _band()
    q, k, v = _gqa_inputs(csr, 8, 2, 64, cuda, seed=11, pad=pad)
    assert not q.is_contiguous()
    got = _check_gqa(csr, q, k, v, cuda)
    rargs, _ = _attn_args(csr, cuda)
    dense_in = ka.fused_ragged_attention_gqa(*rargs, q.contiguous(), k.contiguous(),
                                             v.contiguous(), n_rows=csr.n_rows)
    if pad % 4 == 0:
        assert torch.equal(got, dense_in)
    else:
        _close(got, dense_in)


def test_grouped_attention_rescales_when_a_later_slot_raises_the_max(cuda):
    """Logits rising by ~40 along each row's columns (every later batch
    raises the max), split into chunks of 32 slots and unsplit."""
    csr = _attn_graph("single_hub")
    d, h, hkv = 64, 8, 2
    g = torch.Generator().manual_seed(3)
    u = torch.ones(d) / d ** 0.5
    ramp = torch.arange(csr.n_cols, dtype=torch.float32) / csr.n_cols
    q = 0.1 * torch.randn(csr.n_rows, h, d, generator=g) + u
    k = 0.1 * torch.randn(csr.n_cols, hkv, d, generator=g) + (
        40.0 * d ** 0.5) * ramp[:, None, None] * u
    v = torch.randn(csr.n_cols, hkv, d, generator=g)
    for cs in (32, 1 << 30):
        _check_gqa(csr, q.to(cuda), k.to(cuda), v.to(cuda), cuda, cs=cs)


def test_grouped_attention_inf_and_nan_in_v_rows_no_edge_reads(cuda):
    """v holding +inf, -inf and NaN in rows no edge reads (every odd
    column): the grouped kernel stages no k or v row of a column without a
    live cell in its row block, so the output stays finite."""
    csr = _spread(_attn_graph("hub_skew"))
    q, k, v = _gqa_inputs(csr, 4, 1, 64, cuda, seed=13)
    v = v.clone()
    v[1::6], v[3::6], v[5::6] = float("inf"), float("-inf"), float("nan")
    out = _check_gqa(csr, q, k, v, cuda)
    assert torch.isfinite(out).all()


def test_grouped_attention_non_finite_v_live_for_some_rows_of_a_block(cuda):
    """v holding +inf, -inf and NaN at band columns that a row block's
    diagonal tile (and a later block's window-edge tile) leaves live for
    some of its rows and masked for the others: the grouped kernel stages
    those rows for the block, and a row that has the cell masked must not
    read them. Rows that read no such column come out finite, equal to
    the per-head kernel and the oracle; ragged == dense-W, NaNs included."""
    from repro_torch.kernels import ref

    csr = _band()  # 512 rows, window 64
    q, k, v = _gqa_inputs(csr, 8, 2, 64, cuda, seed=19)
    v = v.clone()
    bad = (8 * 5 + 3, 8 * 20 + 5, 8 * 40 + 1)
    for c, val in zip(bad, (float("inf"), float("-inf"), float("nan"))):
        v[c] = val
    rargs, dargs = _attn_args(csr, cuda)
    ragged = ka.fused_ragged_attention_gqa(*rargs, q, k, v, n_rows=csr.n_rows)
    dense = ka.fused_csr_attention_gqa(*dargs, q, k, v, n_rows=csr.n_rows)
    torch.testing.assert_close(dense, ragged, rtol=0, atol=0, equal_nan=True)
    reads = torch.zeros(csr.n_rows, dtype=torch.bool)
    for c in bad:
        reads[c:c + 64] = True  # row r reads columns r - 63 .. r
    clean = ~reads.to(cuda)
    mixed = [c - 1 for c in bad] + [c + 64 for c in bad]  # a block-mate of a reading row
    assert not bool(reads[mixed].any())
    assert torch.isfinite(ragged[clean]).all()
    per_head = ka.by_head(lambda qh, kh, vh: ka.fused_ragged_attention(
        *rargs, qh, kh, vh, n_rows=csr.n_rows), q, k, v)
    _close(ragged[clean], per_head[clean])
    rp, ci = (torch.from_numpy(a).to(cuda) for a in (csr.rowptr, csr.colind))
    want = ka.by_head(lambda qh, kh, vh: ref.csr_attention_ref(rp, ci, qh, kh, vh), q, k, v)
    assert (ragged[clean] - want[clean]).abs().max() <= 2.29e-5 * want[clean].abs().max()


def test_grouped_attention_runner_counts_heads_on_the_card(cuda):
    """Both fused variants' runners take a grouped call in one launch of
    the grouped kernel (counted as grouped heads), and a 2-D call in one
    launch of the per-head kernel, as before."""
    from repro_torch.core import obs, registry
    from repro_torch.core.features import HardwareSpec, InputFeatures

    csr = _band()
    feat = InputFeatures.from_csr(csr, 128, "attention")
    hw = HardwareSpec.current(cuda)
    vs = {v.name: v for v in registry.candidates(feat, hw, cuda)}
    q, k, v = _gqa_inputs(csr, 32, 4, 128, cuda, seed=17)
    for name, key in (("fused_attention_cuda", "fused_csr_attention"),
                      ("ragged_attention_cuda", "fused_ragged_attention")):
        var = vs[name]
        run = var.build(var.prepare(csr), cuda)
        before = dict(ka.LAUNCHES)
        grouped0 = obs.REGISTRY.get(obs.ATTENTION_HEADS_TOTAL, path="grouped") or 0
        out = run(q, k, v)
        assert ka.LAUNCHES[key + "_gqa"] == before[key + "_gqa"] + 1
        assert ka.LAUNCHES[key] == before[key]
        assert obs.REGISTRY.get(obs.ATTENTION_HEADS_TOTAL, path="grouped") == grouped0 + 32
        one = run(q[:, 5].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous())
        assert ka.LAUNCHES[key] == before[key] + 1
        _close(out[:, 5], one)
