"""K10's packed CSR view and its plain version against the tile product and JAX.

K10 reads a CSR view of the BSR operator's tiles (``fused_bsr.BsrPacker``).
On the CPU its wrapper runs the plain packed product
(``bsr_spmv_packed_plain``); these tests hold it to the tile product
(``bsr_spmv_plain``, the JAX semantics) and to the JAX package's
``bsr_matvec_fn``, on tiles with and without values off the CSR
structure, and check when the operator's cache packs again.
"""

import gc
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.ops import pallas_bsr as jpallas_bsr  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_bsr, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.trace import slq  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# The JAX BSR tests' SpMV tolerance.
_TOL = 1e-4


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _matrices(case):
    if case == "fem":
        return fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4)
    rng = np.random.default_rng(0)
    dense = (rng.random((300, 270)) < 0.03) * rng.standard_normal((300, 270))
    dense = dense.astype(np.float32)
    return sparse.csr_from_dense(dense), jsparse.csr_from_dense(dense)


def _operator(mat):
    bsr = sparse.bsr_pack(mat, device="cpu")
    return bsr, sparse.bsr_values(bsr, mat.data, device="cpu")


def _vector(n, seed=1):
    return torch.tensor(np.random.default_rng(seed).standard_normal(n), dtype=torch.float32)


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= _TOL * max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("case", ["fem", "random"])
def test_packed_product_matches_the_tile_product_and_jax(case):
    mat_t, mat_j = _matrices(case)
    bsr, tiles = _operator(mat_t)
    pack = fused_bsr.BsrPacker(bsr)(tiles)
    assert pack.structural and pack.nnz == mat_t.nnz
    np.testing.assert_array_equal(pack.row_ptr.numpy(), mat_t.indptr)
    np.testing.assert_array_equal(pack.cols.numpy(), mat_t.indices)
    v = _vector(mat_t.shape[1])
    got = fused_bsr.bsr_spmv_packed(pack, v)
    bsr_j = jsparse.bsr_pack(mat_j)
    want_j = np.asarray(jsparse.bsr_matvec_fn(bsr_j)(
        jnp.asarray(v.numpy()), jsparse.bsr_values(bsr_j, mat_j.data)))
    _assert_close(got, fused_bsr.bsr_spmv_plain(bsr, v, tiles))
    _assert_close(got, want_j)
    _assert_close(got, mat_t.todense() @ v.numpy())


@pytest.mark.parametrize("case", ["fem", "random"])
def test_values_off_the_structure_are_kept(case):
    """A dense update of the tiles (as a ``dtiles`` step gives) puts values
    in slots off the CSR structure; the pack then follows the values."""
    mat_t, _ = _matrices(case)
    bsr, tiles = _operator(mat_t)
    rng = np.random.default_rng(2)
    update = torch.tensor(rng.standard_normal(tiles.shape) * (rng.random(tiles.shape) < 0.01),
                          dtype=torch.float32)
    updated = tiles + update
    pack = fused_bsr.BsrPacker(bsr)(updated)
    assert not pack.structural and pack.nnz > mat_t.nnz
    v = _vector(mat_t.shape[1], seed=3)
    _assert_close(fused_bsr.bsr_spmv_packed(pack, v), fused_bsr.bsr_spmv_plain(bsr, v, updated))
    # Values in padded rows and past the last column carry no weight.
    rows = fused_bsr.bsr_spmv_packed_plain(pack, v)
    assert rows.shape == (mat_t.shape[0],)


def test_cache_packs_again_after_an_in_place_update_and_for_a_new_tensor():
    mat, _ = _matrices("fem")
    bsr, tiles = _operator(mat)
    matvec = fused_bsr.bsr_matvec_fused(bsr, symmetric=True)
    v = _vector(mat.shape[1], seed=4)
    start = fused_bsr.PACKS
    first = matvec(v, tiles)
    matvec(v, tiles.detach())  # another object over the same storage and version
    assert fused_bsr.PACKS - start == 1

    tiles.mul_(2.0)  # in place: a new version
    _assert_close(matvec(v, tiles), 2.0 * first)
    assert fused_bsr.PACKS - start == 2

    # A tensor freed by its caller stays alive in the cache, so no new
    # tensor can take its memory under the same key.
    alive = weakref.ref(tiles)
    del tiles
    gc.collect()
    assert alive() is not None
    fresh = sparse.bsr_values(bsr, -mat.data, device="cpu")
    _assert_close(matvec(v, fresh), -first)
    assert fused_bsr.PACKS - start == 3


def test_lanczos_vjp_through_the_bsr_operator_packs_once(monkeypatch):
    """The operator that ``sparse_operator`` builds on the card: one pack
    serves the forward matvecs and the adjoint's; per-probe SLQ's value and
    gradient, one pack for all its probes."""
    monkeypatch.setattr(native, "on_card", lambda device: True)
    mat, _ = _matrices("fem")
    matvec, tiles = sparse.sparse_operator(mat, format="bsr", device="cpu")
    assert hasattr(matvec, "packer")
    n, depth = mat.shape[0], 10
    args = [torch.ones(n, requires_grad=True), tiles.clone().requires_grad_()]
    start = fused_bsr.PACKS
    out = lanczos.tridiag(matvec, depth, reortho="none")(*args)
    leaves = [o for o in jax.tree_util.tree_leaves(out) if isinstance(o, torch.Tensor)]
    grads = torch.autograd.grad(leaves, args, [torch.ones_like(o) for o in leaves])
    assert fused_bsr.PACKS - start == 1
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    probes = torch.tensor(np.random.default_rng(5).choice([-1.0, 1.0], size=(3, n)),
                          dtype=torch.float32)
    logdet = slq.krylov_logdet_slq(depth, sample=lambda _key: probes, num_batches=1,
                                   checkpoint=False)
    p = tiles.clone().requires_grad_()
    start = fused_bsr.PACKS
    value, _info = logdet(matvec, None, p)
    (grad,) = torch.autograd.grad(value, [p])
    assert fused_bsr.PACKS - start == 1
    assert bool(torch.isfinite(grad).all())


def test_lanes_per_row_follow_the_mean_row_length():
    assert fused_bsr.lanes_per_row(3_087_000, 41_472) == 4  # the FEM test matrix, grid 24
    assert fused_bsr.lanes_per_row(8 * 65_536, 65_536) == 4
    assert fused_bsr.lanes_per_row(150 * 1000, 1000) == 8
    assert fused_bsr.lanes_per_row(300 * 1000, 1000) == 16
    assert fused_bsr.lanes_per_row(10**6, 100) == 32


def test_packed_wrapper_rejects_what_the_kernel_does_not_take():
    mat, _ = _matrices("fem")
    bsr, tiles = _operator(mat)
    pack = fused_bsr.BsrPacker(bsr)(tiles)
    v = torch.zeros(mat.shape[1])
    with pytest.raises(TypeError, match="float32"):
        fused_bsr.bsr_spmv_packed(pack, v.double())
    with pytest.raises(ValueError, match="shape"):
        fused_bsr.bsr_spmv_packed(pack, v[:-1])
    with pytest.raises(ValueError, match="device"):
        fused_bsr.bsr_spmv_packed(pack, v.to("meta"))
