"""The port's ELL and HYB layouts, format selection and .mtx reading against the JAX package's.

Same numpy inputs on both sides: packing bit for bit, matvecs and their
VJPs to the JAX sparse tests' tolerance (1e-5).
"""

import gzip
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bench import _laplacian_2d as jax_laplacian_2d  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_bsr as jpallas_bsr  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu.utils import exp_util as jexp_util  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_bsr, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import exp_util, test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _random_csr(pkg, n, nnz_per_row, seed=0, heavy=()):
    """``experiments/benchmarks/spmv_formats/benchmark.py``'s random matrix,
    optionally with some rows made dense (HYB's heavy rows)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, n, len(rows))
    vals = rng.normal(size=len(rows))
    for r in heavy:
        rows = np.concatenate([rows, np.full(n, r)])
        cols = np.concatenate([cols, np.arange(n)])
        vals = np.concatenate([vals, rng.normal(size=n)])
    return pkg.csr_from_coo(rows, cols, vals.astype(np.float32), shape=(n, n))


def _vjp_t(mv, v, params, cot):
    args = [torch.tensor(v, requires_grad=True)] + [p.clone().requires_grad_() for p in params]
    out = mv(*args)
    grads = torch.autograd.grad(out, args, torch.tensor(cot), allow_unused=True)
    # An empty heavy block (k = 0) takes no part: its gradient is empty too.
    return out.detach().numpy(), [
        (torch.zeros_like(a) if g is None else g).numpy() for a, g in zip(args, grads)
    ]


def _vjp_j(mv, v, values, cot):
    out, vjp = jax.vjp(mv, jnp.asarray(v), values)
    grads = jax.tree_util.tree_leaves(vjp(jnp.asarray(cot)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_close(got, want, tol=1e-5):
    assert got.shape == want.shape
    if want.size == 0:
        return
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale


@pytest.mark.parametrize("heavy", [(), (3, 17)])
def test_ell_pack_matvec_and_vjp_match_jax(heavy):
    n = 200
    mat_t, mat_j = _random_csr(sparse, n, 8, heavy=heavy), _random_csr(jsparse, n, 8, heavy=heavy)
    ell_t, ell_j = sparse.ell_pack(mat_t, device="cpu"), jsparse.ell_pack(mat_j)
    np.testing.assert_array_equal(ell_t.cols.numpy(), np.asarray(ell_j.cols))
    np.testing.assert_array_equal(ell_t.perm, ell_j.perm)
    assert (ell_t.width, ell_t.num_slots) == (ell_j.width, ell_j.num_slots)
    vals_t = sparse.ell_values(ell_t, mat_t.data, device="cpu")
    vals_j = jsparse.ell_values(ell_j, mat_j.data)
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    port, vals = sparse.ell_from_jax(jax.tree_util.tree_map(np.asarray, ell_j), vals_j, device="cpu")
    np.testing.assert_array_equal(port.cols.numpy(), ell_t.cols.numpy())
    assert torch.equal(vals, vals_t)

    rng = np.random.default_rng(1)
    v, cot = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    out_t, grads_t = _vjp_t(sparse.ell_matvec_fn(ell_t), v, [vals_t], cot)
    for mv_j in (jsparse.ell_matvec_fn(ell_j), jsparse.ell_matvec_fn_gather(ell_j)):
        out_j, grads_j = _vjp_j(mv_j, v, vals_j, cot)
        _assert_close(out_t, out_j)
        for g_t, g_j in zip(grads_t, grads_j):
            _assert_close(g_t, g_j)
    assert sparse.ell_matvec_fn_gather is sparse.ell_matvec_fn


@pytest.mark.parametrize("heavy", [(), (3, 17, 150)])
def test_hyb_pack_matvec_and_vjp_match_jax(heavy):
    n = 200
    mat_t, mat_j = _random_csr(sparse, n, 8, heavy=heavy), _random_csr(jsparse, n, 8, heavy=heavy)
    hyb_t, hyb_j = sparse.hyb_pack(mat_t, device="cpu"), jsparse.hyb_pack(mat_j)
    np.testing.assert_array_equal(hyb_t.heavy_rows.numpy(), np.asarray(hyb_j.heavy_rows))
    assert list(hyb_t.heavy_rows.numpy()) == list(heavy)
    np.testing.assert_array_equal(hyb_t.heavy_scatter, hyb_j.heavy_scatter)
    np.testing.assert_array_equal(hyb_t.light_mask, hyb_j.light_mask)
    np.testing.assert_array_equal(hyb_t.ell.cols.numpy(), np.asarray(hyb_j.ell.cols))
    assert hyb_t.num_slots == hyb_j.num_slots
    vals_t = sparse.hyb_values(hyb_t, mat_t.data, device="cpu")
    vals_j = jsparse.hyb_values(hyb_j, mat_j.data)
    for a, b in zip(vals_t, vals_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    port, vals = sparse.hyb_from_jax(jax.tree_util.tree_map(np.asarray, hyb_j), vals_j, device="cpu")
    np.testing.assert_array_equal(port.heavy_rows.numpy(), hyb_t.heavy_rows.numpy())
    assert all(torch.equal(a, b) for a, b in zip(vals, vals_t))

    rng = np.random.default_rng(2)
    v, cot = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    out_t, grads_t = _vjp_t(sparse.hyb_matvec_fn(hyb_t), v, list(vals_t), cot)
    out_j, grads_j = _vjp_j(jsparse.hyb_matvec_fn(hyb_j), v, vals_j, cot)
    _assert_close(out_t, out_j)
    np.testing.assert_allclose(out_t, mat_t.todense() @ v, rtol=1e-4, atol=1e-4)
    for g_t, g_j in zip(grads_t, grads_j):
        _assert_close(g_t, g_j)


def test_hyb_values_reach_the_lanczos_adjoint_as_two_parameters():
    """Both HYB value tensors get their gradient through ``tridiag``'s
    closed-form adjoint, as the JAX package's pytree of values does
    (float64, the generic route on both sides)."""
    from lanczos_adjoints_tpu.krylov import lanczos as jlanczos

    n, depth = 200, 6
    heavy = (3, 17, 150)
    dense = _random_csr(sparse, n, 8, heavy=heavy).todense().astype(np.float64)
    sym = dense + dense.T + 40 * np.eye(n)
    mat_t, mat_j = sparse.csr_from_dense(sym), jsparse.csr_from_dense(sym)
    mv_t, values_t = sparse.sparse_operator(mat_t, format="hyb", dtype=torch.float64, device="cpu")
    v0 = np.random.default_rng(3).standard_normal(n)

    with jax.enable_x64(True):
        mv_j, values_j = jsparse.sparse_operator(mat_j, format="hyb", dtype=jnp.float64)

        def loss_j(vals):
            (_xs, (alphas, betas)), _ = jlanczos.tridiag(mv_j, depth, reortho="none")(
                jnp.asarray(v0), vals)
            return jnp.sum(alphas) + jnp.sum(betas**2)

        grads_j = [np.asarray(g) for g in jax.grad(loss_j)(values_j)]
    params = [p.clone().requires_grad_() for p in values_t]
    (_xs, (alphas, betas)), _ = lanczos.tridiag(mv_t, depth, reortho="none")(
        torch.tensor(v0), *params)
    grads_t = torch.autograd.grad(torch.sum(alphas) + torch.sum(betas**2), params)
    assert len(grads_t) == len(grads_j) == 2
    for got, want in zip(grads_t, grads_j):
        assert np.max(np.abs(want)) > 0
        _assert_close(got.numpy(), want, 1e-10)


@pytest.mark.parametrize("case", ["dia", "bsr", "hyb", "dia_capped", "rectangular"])
def test_auto_picks_the_jax_packages_format(case):
    kwargs = {}
    if case == "dia":
        mat_t = mat_j = test_util.laplacian_2d(16)
        np.testing.assert_array_equal(mat_t.indices, jax_laplacian_2d(16).indices)
    elif case == "bsr":
        mat_t, mat_j = fused_bsr.fem_test_matrix(4), jpallas_bsr.fem_test_matrix(4)
    elif case == "hyb":
        mat_t, mat_j = _random_csr(sparse, 2048, 8), _random_csr(jsparse, 2048, 8)
    elif case == "dia_capped":  # the Laplacian with too few diagonals allowed
        mat_t = mat_j = test_util.laplacian_2d(16)
        kwargs = {"dia_max_diags": 3}
    else:
        m = np.random.default_rng(4).standard_normal((40, 30)).astype(np.float32)
        mat_t, mat_j = sparse.csr_from_dense(m), jsparse.csr_from_dense(m)
    mv_t, vals_t, info_t = sparse.sparse_operator(mat_t, with_info=True, device="cpu", **kwargs)
    mv_j, vals_j, info_j = jsparse.sparse_operator(mat_j, with_info=True, **kwargs)
    assert info_t == info_j
    assert info_t.format == {"dia": "dia", "bsr": "bsr", "hyb": "hyb"}.get(case, info_t.format)
    v = np.random.default_rng(5).standard_normal(mat_t.shape[1]).astype(np.float32)
    vals_t = vals_t if isinstance(vals_t, tuple) else (vals_t,)
    np.testing.assert_allclose(
        mv_t(torch.tensor(v), *vals_t).numpy(), np.asarray(mv_j(jnp.asarray(v), vals_j)),
        rtol=1e-4, atol=1e-4,
    )


def _write_mtx(path, header, size, entries, *, compress=False):
    body = "\n".join([header, "% a comment", size, *entries]) + "\n"
    if compress:
        with gzip.open(path, "wt") as fp:
            fp.write(body)
    else:
        path.write_text(body)
    return str(path)


_FILES = {
    "general": ("%%MatrixMarket matrix coordinate real general", "4 3 5",
                ["1 1 2.5", "2 3 -1.0", "4 1 0.5", "3 2 7.0", "4 3 1e-3"]),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric", "4 4 5",
                  ["1 1 4.0", "2 1 -1.0", "3 2 -1.5", "4 4 2.0", "4 1 0.25"]),
    "pattern": ("%%MatrixMarket matrix coordinate pattern symmetric", "3 3 3",
                ["1 1", "2 1", "3 3"]),
}


@pytest.mark.parametrize("scipy_present", [True, False])
@pytest.mark.parametrize("kind", sorted(_FILES))
def test_mtx_read_matches_jax(kind, scipy_present, tmp_path, monkeypatch):
    header, size, entries = _FILES[kind]
    path = _write_mtx(tmp_path / f"{kind}.mtx", header, size, entries)
    gz = _write_mtx(tmp_path / f"{kind}.mtx.gz", header, size, entries, compress=True)
    want = jexp_util.mtx_read(path)  # scipy.io.mmread in the JAX package
    if not scipy_present:  # the port's numpy parser
        monkeypatch.setitem(sys.modules, "scipy.io", None)
    for p in (path, gz):
        got = exp_util.mtx_read(p)
        assert tuple(got[3]) == tuple(want[3])
        order_g = np.lexsort((got[1], got[0]))
        order_w = np.lexsort((want[1], want[0]))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(np.asarray(a)[order_g], np.asarray(b)[order_w])


def test_suite_sparse_load_reads_a_given_path_and_raises_when_absent(tmp_path):
    header, size, entries = _FILES["symmetric"]
    (tmp_path / "tiny").mkdir()
    _write_mtx(tmp_path / "tiny" / "tiny.mtx", header, size, entries)
    got = exp_util.suite_sparse_load("tiny", path=str(tmp_path))
    want = jexp_util.suite_sparse_load("tiny", path=str(tmp_path))
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.is_symmetric()
    with pytest.raises(FileNotFoundError, match="bcsstk18"):
        exp_util.suite_sparse_load("bcsstk18", path=str(tmp_path))
