"""repro_torch.kernels.ops and the block-ELL row softmax on the CPU,
against the JAX package: the plain row softmax against the Pallas
kernel in interpret mode on its traps, the finfo.min row on which the
Pallas kernel and the oracle disagree, each ops function and impl
against its JAX twin on the same seeded numpy inputs, and twins of
tests/test_kernels.py::test_ops_layer_dispatch and tests/test_api.py's
deprecation tests.

Tolerances: the plain softmax against the Pallas kernel rtol 1e-5,
atol 1e-6 * max|ref| (the same fp32 exp and sums, reduced in another
order); ops against JAX ops rtol 1e-5, atol 1e-5 * max|ref| (fp32 sums
in another order; attention adds an online softmax against a two-pass
one, 1e-4); ragged against dense-W bit for bit (the same slots in the
same order, the padded ones adding exact zeros)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jx_ops
from repro.kernels import ref as jx_ref
from repro.kernels.softmax_pallas import row_softmax_block_ell as jx_row_softmax
from repro.sparse import csr_from_dense as jx_csr_from_dense
from repro_torch.kernels import ops, ref, softmax
from repro_torch.sparse import csr_from_dense, csr_to_block_ell, power_law

torch.set_num_threads(1)  # see test_torch_spmm.py

NEG = np.finfo(np.float32).min


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _trap_slab(rb, bc, w=3, seed=0):
    """(nrb=5, w, rb, bc) logits and mask holding the softmax's traps:
    row block 0 fully masked; row 1 of block 1 fully masked inside a live
    block; NaN and +-inf logits on masked cells; logits x5 and +-80 (exp
    overflows without the max shift); mask values -1, 0.5 and 2 (the test
    is > 0, not != 0)."""
    rng = np.random.default_rng(seed)
    shape = (5, w, rb, bc)
    vals = (rng.standard_normal(shape) * 5).astype(np.float32)
    vals[2] = rng.choice([-80.0, 80.0], size=shape[1:]).astype(np.float32)
    mask = rng.choice([-1.0, 0.0, 0.5, 1.0, 2.0], size=shape,
                      p=[0.1, 0.35, 0.15, 0.3, 0.1]).astype(np.float32)
    mask[0] = 0.0
    mask[1, :, 1, :] = 0.0
    dead = mask <= 0
    vals[dead & (rng.random(shape) < 0.2)] = np.nan
    vals[dead & (rng.random(shape) < 0.2)] = np.inf
    vals[dead & (rng.random(shape) < 0.2)] = -np.inf
    return vals, mask


def _softmax_pair(vals, mask):
    got = softmax.row_softmax_block_ell_plain(torch.from_numpy(vals), torch.from_numpy(mask))
    want = jx_row_softmax(jnp.asarray(vals), jnp.asarray(mask), interpret=True)
    return got.numpy(), np.asarray(want)


def _check_zeros(out, mask):
    dead = mask <= 0
    assert (out[dead] == 0).all() and not np.signbit(out[dead]).any()


@pytest.mark.parametrize("rb,bc", [(8, 8), (16, 8), (8, 16)])
def test_plain_row_softmax_matches_pallas_on_traps(rb, bc):
    vals, mask = _trap_slab(rb, bc)
    got, want = _softmax_pair(vals, mask)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _close(got, want)
    _check_zeros(got, mask)
    assert (got[0] == 0).all() and (got[1, :, 1, :] == 0).all()
    # every row with a live cell sums to 1
    live = (mask > 0).any(axis=(1, 3))
    np.testing.assert_allclose(got.sum(axis=(1, 3))[live], 1.0, rtol=1e-5)


@pytest.mark.parametrize("w", [1, 2048])
def test_plain_row_softmax_matches_pallas_at_widths(w):
    vals, mask = _trap_slab(8, 8, w=w, seed=w)
    got, want = _softmax_pair(vals[:2], mask[:2])
    _close(got, want)
    _check_zeros(got, mask[:2])


def test_finfo_min_row_pallas_and_oracle_disagree():
    """A live row whose logits are all finfo.min: the Pallas kernel sets
    its max to 0 (softmax_pallas.py:24) and the row comes out all zeros;
    the oracle keeps the finite max (ref.py:203) and gives 1/deg. The
    port's plain version (what ops.row_softmax runs) follows the Pallas
    kernel, its ref.row_softmax_block_ell_ref the oracle."""
    vals = np.zeros((1, 2, 8, 8), np.float32)
    mask = np.zeros_like(vals)
    mask[0, :, 3, :3] = 1.0  # row 3: six live cells
    vals[0, :, 3, :] = NEG
    mask[0, 0, 5, 0] = 1.0  # row 5: one ordinary live cell
    pallas = np.asarray(jx_row_softmax(jnp.asarray(vals), jnp.asarray(mask), interpret=True))
    oracle = np.asarray(jx_ref.row_softmax_block_ell_ref(jnp.asarray(vals), jnp.asarray(mask)))
    plain = softmax.row_softmax_block_ell_plain(torch.from_numpy(vals), torch.from_numpy(mask))
    port_oracle = ref.row_softmax_block_ell_ref(torch.from_numpy(vals), torch.from_numpy(mask))
    assert (pallas[0, :, 3] == 0).all()
    np.testing.assert_allclose(oracle[0, :, 3, :3], 1 / 6, rtol=1e-6)
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(port_oracle.numpy(), oracle)
    assert pallas[0, 0, 5, 0] == oracle[0, 0, 5, 0] == 1.0


def test_plain_row_softmax_chunks_like_one_pass():
    vals, mask = _trap_slab(8, 8, w=4)
    t_vals, t_mask = torch.from_numpy(vals), torch.from_numpy(mask)
    whole = softmax.row_softmax_block_ell_plain(t_vals, t_mask)
    chunked = softmax.row_softmax_block_ell_plain(t_vals, t_mask, chunk_elems=300)
    assert torch.equal(whole, chunked)


# ------------------------------------------------------------ ops twins
def _problem(seed=11, n=30, m=40):
    rng = np.random.default_rng(seed)
    a = ((rng.random((n, m)) < 0.25) * rng.standard_normal((n, m))).astype(np.float32)
    a[:, 0] = 1.0
    return a, rng


def _both(a):
    return csr_from_dense(a), jx_csr_from_dense(a)


IMPL_PAIRS = [("cuda", "pallas"), ("ragged", "ragged"), ("ref", "xla")]


@pytest.mark.parametrize("impl,jx_impl", IMPL_PAIRS)
@pytest.mark.parametrize("op", ["spmm", "sddmm", "csr_attention"])
def test_ops_match_jax_ops(op, impl, jx_impl):
    a, rng = _problem()
    csr, jcsr = _both(a)
    f = 128 if op == "sddmm" else 48  # the Pallas SDDMM takes F in chunks of 128
    x = rng.standard_normal((csr.n_rows, f)).astype(np.float32)
    y = rng.standard_normal((csr.n_cols, f)).astype(np.float32)
    z = rng.standard_normal((csr.n_cols, f)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (x, y, z)]
    j = [jnp.asarray(v) for v in (x, y, z)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if op == "spmm":
            got, want = ops.spmm(csr, t[1], impl=impl), jx_ops.spmm(jcsr, j[1], impl=jx_impl)
        elif op == "sddmm":
            got, want = ops.sddmm(csr, t[0], t[1], impl=impl), jx_ops.sddmm(
                jcsr, j[0], j[1], impl=jx_impl)
        else:
            got = ops.csr_attention(csr, *t, impl=impl)
            want = jx_ops.csr_attention(jcsr, *j, impl=jx_impl)
    want = np.asarray(want)
    if op == "sddmm" and impl != "ref":
        nrb = -(-csr.n_rows // 8)
        want = want[:nrb]  # the Pallas grid runs the padded row blocks too
    assert got.shape == want.shape
    _close(got.numpy(), want, atol_rel=1e-4 if op == "csr_attention" else 1e-5)


def test_row_softmax_matches_jax_ops():
    a, rng = _problem(seed=3)
    bell = csr_to_block_ell(csr_from_dense(a))
    mask = (bell.vals != 0).astype(np.float32)
    logits = (rng.standard_normal(bell.vals.shape) * 5).astype(np.float32)
    got = ops.row_softmax(torch.from_numpy(logits), torch.from_numpy(mask))
    want = jx_ops.row_softmax(jnp.asarray(logits), jnp.asarray(mask))
    _close(got.numpy(), np.asarray(want))


def test_ops_layer_dispatch():
    """Twin of tests/test_kernels.py::test_ops_layer_dispatch: cuda and ref
    agree; ragged equals cuda (dense-W) bit for bit."""
    a, rng = _problem()
    csr = csr_from_dense(a)
    b = torch.from_numpy(rng.standard_normal((40, 128)).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _close(ops.spmm(csr, b, impl="cuda").numpy(), ops.spmm(csr, b, impl="ref").numpy())
        assert torch.equal(ops.spmm(csr, b, impl="ragged"), ops.spmm(csr, b, impl="cuda"))
        assert torch.equal(ops.spmm(csr, b, impl="auto"), ops.spmm(csr, b, impl="ref"))
        q, k, v = (torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
                   for n in (30, 40, 40))
        want = ops.csr_attention(csr, q, k, v, impl="ref").numpy()
        for impl in ("cuda", "ragged"):
            _close(ops.csr_attention(csr, q, k, v, impl=impl).numpy(), want, atol_rel=1e-4)
        with pytest.raises(ValueError, match="impl"):
            ops.spmm(csr, b, impl="pallas")  # the JAX name is not the port's
        with pytest.raises(ValueError, match="8x8"):
            ops.csr_attention(csr, q, k, v, impl="cuda", rb=16)


def test_ops_layer_deprecated():
    g = power_law(100, 1.6, avg_deg=4.0, seed=3)
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((g.n_cols, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((g.n_rows, 8)).astype(np.float32))
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        ops.spmm(g, b, impl="ref")
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        ops.sddmm(g, x, b, impl="ref")
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        ops.csr_attention(g, x, b, b, impl="ref")


def test_deprecation_is_one_time_per_site():
    """Python's default filter dedups DeprecationWarning per call site:
    a training loop hitting a shim gets one warning, not one per step."""
    g = power_law(60, 1.5, avg_deg=3.0, seed=4)
    b = torch.zeros((g.n_cols, 4))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")  # dedup-by-location semantics
        for _ in range(3):
            ops.spmm(g, b, impl="ref")
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1
