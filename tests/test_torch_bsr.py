"""The port's BSR layout and K10 against the JAX package's.

Same numpy inputs on both sides. The assembly (the FEM test matrix, the
BSR packing, RCM) must agree bit for bit; on the CPU the port's K10
wrapper runs its plain version, held to the JAX package's Pallas kernel
(interpret mode) with the JAX BSR tests' tolerances.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import arnoldi as jarnoldi  # noqa: E402
from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_bsr as jpallas_bsr  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_bsr, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _jax_done(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_csr(n_rows, n_cols, density, seed, symmetric):
    """The JAX BSR tests' random matrix (symmetric, diagonally shifted), or a
    rectangular one with ragged row and column blocks."""
    rng = np.random.default_rng(seed)
    m = (rng.random((n_rows, n_cols)) < density) * rng.standard_normal((n_rows, n_cols))
    if symmetric:
        m = np.triu(m) + np.triu(m, 1).T + np.eye(n_rows) * n_rows
    m = m.astype(np.float32)
    return sparse.csr_from_dense(m), jsparse.csr_from_dense(m)


def _both_bsr(mat_t, mat_j):
    bsr_t = sparse.bsr_pack(mat_t, device="cpu")
    bsr_j = jsparse.bsr_pack(mat_j)
    return bsr_t, sparse.bsr_values(bsr_t, mat_t.data, device="cpu"), bsr_j, jsparse.bsr_values(
        bsr_j, mat_j.data)


def _assert_csr_equal(got, want):
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.shape == want.shape


def test_fem_test_matrix_is_bitwise_the_jax_packages():
    _assert_csr_equal(fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4))
    _assert_csr_equal(fused_bsr.fem_test_matrix(3, dofs=2, seed=1),
                      jpallas_bsr.fem_test_matrix(3, dofs=2, seed=1))


@pytest.mark.parametrize("case", ["fem", "fem_rcm", "rectangular"])
def test_bsr_pack_and_values_are_bitwise_the_jax_packages(case):
    if case == "rectangular":
        mat_t, mat_j = _random_csr(300, 270, 0.03, 0, symmetric=False)
    else:
        mat_t, mat_j = fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4)
        if case == "fem_rcm":
            perm_t, perm_j = sparse.reverse_cuthill_mckee(mat_t), jsparse.reverse_cuthill_mckee(mat_j)
            np.testing.assert_array_equal(perm_t, perm_j)
            mat_t, mat_j = sparse.permute_symmetric(mat_t, perm_t), jsparse.permute_symmetric(mat_j, perm_j)
            _assert_csr_equal(mat_t, mat_j)
    bsr_t, tiles_t, bsr_j, tiles_j = _both_bsr(mat_t, mat_j)
    np.testing.assert_array_equal(bsr_t.block_cols.numpy(), np.asarray(bsr_j.block_cols))
    np.testing.assert_array_equal(bsr_t.scatter_idx, bsr_j.scatter_idx)
    for field in ("width", "shape", "padded_n", "padded_cols", "nnz", "tile_rows", "num_slots"):
        assert getattr(bsr_t, field) == getattr(bsr_j, field), field
    np.testing.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    port, tiles = sparse.bsr_from_jax(jax.tree_util.tree_map(np.asarray, bsr_j), tiles_j, device="cpu")
    np.testing.assert_array_equal(port.block_cols.numpy(), bsr_t.block_cols.numpy())
    assert torch.equal(tiles, tiles_t)


@pytest.mark.parametrize("case", ["fem", "symmetric", "rectangular"])
def test_plain_k10_matches_the_pallas_kernel(case):
    if case == "fem":
        mat_t, mat_j = fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4)
    else:
        mat_t, mat_j = _random_csr(300, 300 if case == "symmetric" else 270, 0.03, 1,
                                   symmetric=case == "symmetric")
    bsr_t, tiles_t, bsr_j, tiles_j = _both_bsr(mat_t, mat_j)
    v = np.random.default_rng(2).standard_normal(mat_t.shape[1]).astype(np.float32)
    want = np.asarray(jpallas_bsr.bsr_spmv_pallas(bsr_j, interpret=True)(jnp.asarray(v), tiles_j))
    got = fused_bsr.bsr_spmv_fused(bsr_t)(torch.tensor(v), tiles_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), mat_t.todense() @ v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("symmetric", [True, False])
def test_vjp_matches_the_pallas_matvec(symmetric):
    """The JAX BSR gradient test's loss and tolerance (1e-5 relative)."""
    mat_t, mat_j = _random_csr(260, 260, 0.04, 2, symmetric=True)
    bsr_t, tiles_t, bsr_j, tiles_j = _both_bsr(mat_t, mat_j)
    rng = np.random.default_rng(3)
    v, w = (rng.standard_normal(260).astype(np.float32) for _ in range(2))

    def loss_j(v_, t_):
        out = jpallas_bsr.bsr_matvec_pallas(bsr_j, symmetric=symmetric, interpret=True)(v_, t_)
        return jnp.sum(w * out) + jnp.sum(out**2)

    grads_j = _jax_done(jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(v), tiles_j))
    args = [torch.tensor(v, requires_grad=True), tiles_t.clone().requires_grad_()]
    out = fused_bsr.bsr_matvec_fused(bsr_t, symmetric=symmetric)(*args)
    grads_t = torch.autograd.grad(torch.sum(torch.tensor(w) * out) + torch.sum(out**2), args)
    for a, b in zip(grads_t, grads_j):
        rel = np.linalg.norm(a.numpy() - b) / (np.linalg.norm(b) + 1e-9)
        assert rel < 1e-5, rel


def test_transpose_matvec_of_a_rectangular_operator():
    mat_t, _mat_j = _random_csr(300, 270, 0.03, 4, symmetric=False)
    bsr = sparse.bsr_pack(mat_t, device="cpu")
    tiles = sparse.bsr_values(bsr, mat_t.data, device="cpu")
    u = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    got = fused_bsr.bsr_transpose_matvec(bsr, torch.tensor(u), tiles)
    np.testing.assert_allclose(got.numpy(), mat_t.todense().T @ u, rtol=1e-4, atol=1e-4)


def _cotangent(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("entry", ["tridiag", "hessenberg"])
def test_krylov_vjp_over_bsr_matches_the_jax_generic_route(entry):
    """``tridiag``/``hessenberg`` over the BSR operator: float64 through the
    plain matvec against the JAX package's generic route, and float32
    through the K10 Function against the JAX Pallas matvec (the JAX
    adjoint test's 1e-4 (1 + depth))."""
    mat_t, mat_j = fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4)
    bsr_t, tiles_t, bsr_j, tiles_j = _both_bsr(mat_t, mat_j)
    n, depth = mat_t.shape[0], 8
    v = np.random.default_rng(6).standard_normal(n)
    if entry == "tridiag":
        shapes = [(depth, n), (depth,), (depth - 1,), (n,), ()]
        build_j = lambda mv: jlanczos.tridiag(mv, depth, reortho="none")  # noqa: E731
        build_t = lambda mv: lanczos.tridiag(mv, depth, reortho="none")  # noqa: E731
    else:
        shapes = [(n, depth), (depth, depth), (n,), ()]
        build_j = lambda mv: jarnoldi.hessenberg(mv, depth, reortho="full")  # noqa: E731
        build_t = lambda mv: arnoldi.hessenberg(mv, depth, reortho="full")  # noqa: E731
    cot = _cotangent(shapes, 7)

    def run_j(mv, dtype):
        leaves, tree = jax.tree_util.tree_flatten(
            build_j(mv)(jnp.asarray(v, dtype), jnp.asarray(tiles_j, dtype)))
        _out, vjp = jax.vjp(lambda a, b: jax.tree_util.tree_leaves(build_j(mv)(a, b)),
                            jnp.asarray(v, dtype), jnp.asarray(tiles_j, dtype))
        return _jax_done((leaves, vjp([jnp.asarray(c, dtype) for c in cot])))

    def run_t(mv, dtype):
        args = [torch.tensor(v, dtype=dtype, requires_grad=True),
                tiles_t.to(dtype).clone().requires_grad_()]
        leaves = jax.tree_util.tree_leaves(build_t(mv)(*args))
        grads = torch.autograd.grad(leaves, args, [torch.tensor(c, dtype=dtype) for c in cot])
        return [x.detach().numpy() for x in leaves], [g.numpy() for g in grads]

    with jax.enable_x64(True):
        want64 = run_j(jsparse.bsr_matvec_fn(bsr_j), jnp.float64)
    want32 = run_j(jpallas_bsr.bsr_matvec_pallas(bsr_j, symmetric=True, interpret=True), jnp.float32)
    got64 = run_t(sparse.bsr_matvec_fn(bsr_t), torch.float64)
    got32 = run_t(fused_bsr.bsr_matvec_fused(bsr_t, symmetric=True), torch.float32)
    for (got, want), tol in (((got64, want64), 1e-10), ((got32, want32), 1e-4 * (1 + depth))):
        for g, w in zip([*got[0], *got[1]], [*want[0], *want[1]]):
            assert g.shape == w.shape
            scale = max(np.max(np.abs(w)), 1e-30)
            assert np.max(np.abs(g - w)) <= tol * scale


def test_sparse_operator_builds_the_k10_matvec_on_the_card(monkeypatch):
    """With the card forced on the CPU, ``sparse_operator`` builds the K10
    Function for ``"bsr"``, explicit or chosen by ``"auto"``, with the
    matrix's symmetry, and never the einsum matvec; float64 raises there."""
    monkeypatch.setattr(native, "on_card", lambda device: True)
    built, einsum = [], []
    real_fused, real_fn = fused_bsr.bsr_matvec_fused, sparse.bsr_matvec_fn
    monkeypatch.setattr(fused_bsr, "bsr_matvec_fused",
                        lambda bsr, *, symmetric: built.append(symmetric) or real_fused(bsr, symmetric=symmetric))
    monkeypatch.setattr(sparse, "bsr_matvec_fn", lambda bsr: einsum.append(1) or real_fn(bsr))
    fem = fused_bsr.fem_test_matrix(4)
    rect, _ = _random_csr(300, 270, 0.03, 0, symmetric=False)
    for mat, fmt in ((fem, "auto"), (fem, "bsr"), (rect, "bsr")):
        mv, tiles, info = sparse.sparse_operator(mat, format=fmt, with_info=True, device="cpu")
        assert info.format == "bsr"
        assert einsum == []
        v = torch.tensor(np.random.default_rng(8).standard_normal(mat.shape[1]), dtype=torch.float32)
        np.testing.assert_allclose(mv(v, tiles).numpy(), mat.todense() @ v.numpy(), rtol=1e-4, atol=1e-4)
        einsum.clear()  # the plain K10 behind the wrapper on a CPU tensor
    assert built == [True, True, False]
    with pytest.raises(TypeError, match="float32"):
        sparse.sparse_operator(fem, dtype=torch.float64, device="cpu")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mat = fused_bsr.fem_test_matrix(2)
    bsr = sparse.bsr_pack(mat, device="cpu")
    tiles = sparse.bsr_values(bsr, mat.data, device="cpu")
    v = torch.zeros(mat.shape[0])
    with pytest.raises(TypeError, match="float32"):
        fused_bsr.bsr_spmv_rows(bsr, v.double(), tiles)
    with pytest.raises(ValueError, match="shape"):
        fused_bsr.bsr_spmv_rows(bsr, v[:-1], tiles)
    with pytest.raises(ValueError, match="device"):
        fused_bsr.bsr_spmv_rows(bsr, v.to("meta"), tiles.to("meta"))
