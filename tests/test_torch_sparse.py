"""The port's CSR/DIA assembly and DIA operators against the JAX package's.

Same numpy inputs on both sides. The assembly (CSR, DIA packing, the
benchmark Laplacian) must agree bit for bit; the matvecs to the JAX
DIA test's tolerance (atol 1e-5).
"""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bench import _laplacian_2d as jax_laplacian_2d  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_dia as jpallas_dia  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_dia, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402

OFFSET_SETS = [(-1, 0, 1), (-130, -7, 0, 7, 130), (-128, -1, 0, 1, 128)]


def _banded(n, offsets, seed=0):
    """Random values on the given diagonals, as COO triplets."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    for d in offsets:
        ok = (idx + d >= 0) & (idx + d < n)
        rows.append(idx[ok])
        cols.append((idx + d)[ok])
        vals.append(rng.normal(size=ok.sum()))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _assert_csr_equal(got, want):
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.shape == want.shape


@pytest.mark.parametrize("scipy_present", [True, False])
def test_csr_from_coo_is_bitwise_the_jax_packages(scipy_present, monkeypatch):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, 400)
    cols = rng.integers(0, 40, 400)  # duplicates included: they are summed
    vals = rng.normal(size=400)
    if not scipy_present:  # both packages take their numpy branch
        monkeypatch.setitem(sys.modules, "scipy.sparse", None)
    got = sparse.csr_from_coo(rows, cols, vals, shape=(50, 40))
    want = jsparse.csr_from_coo(rows, cols, vals, shape=(50, 40))
    _assert_csr_equal(got, want)
    np.testing.assert_allclose(got.todense(), want.todense(), rtol=0, atol=0)


def test_csr_from_dense_and_symmetry_match_jax():
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(30, 30)) * (rng.uniform(size=(30, 30)) < 0.2)
    _assert_csr_equal(sparse.csr_from_dense(dense), jsparse.csr_from_dense(dense))
    sym = dense + dense.T
    for mat in (dense, sym):
        assert sparse.csr_from_dense(mat).is_symmetric() == jsparse.csr_from_dense(mat).is_symmetric()
    assert sparse.csr_from_dense(sym).is_symmetric()


@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_dia_pack_and_values_are_bitwise_the_jax_packages(offsets):
    n = 2048
    rows, cols, vals = _banded(n, offsets)
    mat_t = sparse.csr_from_coo(rows, cols, vals, shape=(n, n))
    mat_j = jsparse.csr_from_coo(rows, cols, vals, shape=(n, n))
    dia_t, dia_j = sparse.dia_pack(mat_t), jsparse.dia_pack(mat_j)
    assert dia_t.offsets == dia_j.offsets == tuple(offsets)
    assert dia_t.shape == dia_j.shape and dia_t.nnz == dia_j.nnz
    assert dia_t.num_slots == dia_j.num_slots
    np.testing.assert_array_equal(dia_t.diag_of_entry, dia_j.diag_of_entry)
    np.testing.assert_array_equal(dia_t.pos_of_entry, dia_j.pos_of_entry)
    np.testing.assert_array_equal(sparse.dia_analyze(mat_t), jsparse.dia_analyze(mat_j))
    want = np.asarray(jsparse.dia_values(dia_j, mat_j.data).astype(jnp.float32))
    got = sparse.dia_values(dia_t, mat_t.data, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [4, 16, 128])
def test_laplacian_2d_is_bitwise_the_benchmarks(m):
    got, want = test_util.laplacian_2d(m), jax_laplacian_2d(m)
    _assert_csr_equal(got, want)
    if m == 128:  # bench.py's operator
        assert got.shape == (16_384, 16_384) and got.nnz == 81_408
        assert sparse.dia_pack(got).offsets == (-128, -1, 0, 1, 128)


def test_dia_from_jax_round_trips():
    mat = jsparse.csr_from_coo(*_banded(1024, (-3, 0, 3)), shape=(1024, 1024))
    dia_j = jsparse.dia_pack(mat)
    vals_j = np.asarray(jsparse.dia_values(dia_j, mat.data).astype(jnp.float32))
    dia_t, vals_t = sparse.dia_from_jax(dia_j, vals_j, device="cpu")
    assert isinstance(dia_t, sparse.DIAData)
    assert tuple(dia_t)[:3] == tuple(dia_j)[:3]
    np.testing.assert_array_equal(dia_t.diag_of_entry, dia_j.diag_of_entry)
    np.testing.assert_array_equal(dia_t.pos_of_entry, dia_j.pos_of_entry)
    assert vals_t.dtype == torch.float32
    np.testing.assert_array_equal(vals_t.numpy(), vals_j)
    # And back: the port's fields build the JAX package's container.
    back = jsparse.DIAData(*dia_t)
    np.testing.assert_array_equal(
        np.asarray(jsparse.dia_values(back, mat.data).astype(jnp.float32)), vals_t.numpy()
    )


def _random_slots(dia, seed):
    """Values in every slot, the wrapped ones included."""
    return np.random.default_rng(seed).normal(size=(len(dia.offsets), dia.shape[0])).astype(np.float32)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "every-slot"])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_dia_matvec_fn_matches_the_jax_kernel(offsets, packed):
    n = 2048
    mat = jsparse.csr_from_coo(*_banded(n, offsets), shape=(n, n))
    dia_j = jsparse.dia_pack(mat)
    vals = (
        np.asarray(jsparse.dia_values(dia_j, mat.data).astype(jnp.float32))
        if packed else _random_slots(dia_j, 2)
    )
    v = np.random.default_rng(1).normal(size=n).astype(np.float32)
    want = np.asarray(jpallas_dia.dia_matvec_pallas(dia_j, interpret=True)(jnp.asarray(v), jnp.asarray(vals)))
    want_xla = np.asarray(jsparse.dia_matvec_fn(dia_j)(jnp.asarray(v), jnp.asarray(vals)))
    dia_t, vals_t = sparse.dia_from_jax(dia_j, vals, device="cpu")
    got = sparse.dia_matvec_fn(dia_t)(torch.tensor(v), vals_t)
    assert sparse.dia_matvec_fn(dia_t).dia_data is dia_t
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=1e-5)


def test_coo_matvec_matches_jax():
    n = 500
    mat_j = jsparse.csr_from_coo(*_banded(n, (-7, -1, 0, 2, 40)), shape=(n, n))
    mv_j, vals_j = jsparse.coo_matvec_fn(mat_j)
    v = np.random.default_rng(3).normal(size=n).astype(np.float32)
    want = np.asarray(mv_j(jnp.asarray(v), vals_j))
    mv_t, vals_t = sparse.coo_matvec_fn(sparse.csr_from_coo(*_banded(n, (-7, -1, 0, 2, 40)), shape=(n, n)), device="cpu")
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    np.testing.assert_allclose(mv_t(torch.tensor(v), vals_t).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [16, 32])
def test_sparse_operator_info_and_values_match_jax(m):
    mat = test_util.laplacian_2d(m)
    mv_j, vals_j, info_j = jsparse.sparse_operator(jax_laplacian_2d(m), with_info=True)
    mv_t, vals_t, info_t = sparse.sparse_operator(mat, with_info=True, device="cpu")
    assert info_t == info_j
    assert info_t.fill_efficiency == info_j.fill_efficiency
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    v = np.random.default_rng(4).normal(size=m * m).astype(np.float32)
    np.testing.assert_allclose(
        mv_t(torch.tensor(v), vals_t).numpy(), np.asarray(mv_j(jnp.asarray(v), vals_j)), atol=1e-5
    )
    assert mv_t.dia_data.offsets == mv_j.dia_data.offsets


def test_sparse_operator_picks_the_kernel_matvec_under_the_jax_predicate(monkeypatch):
    """With the card forced on the CPU, the port takes its kernel matvec
    wherever the JAX package (backend forced to TPU) takes its Pallas
    matvec, and also where only the TPU's limits (n % 1024) send the JAX
    package to its roll form: K4 takes any n. A dtype the kernels do not
    take raises on the card instead of running the roll form."""
    monkeypatch.setattr(native, "on_card", lambda device: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    picked_j = []
    monkeypatch.setattr(
        jpallas_dia, "dia_matvec_pallas",
        lambda dia, **kw: picked_j.append(dia.shape[0]) or jsparse.dia_matvec_fn(dia),
    )
    picked_t = []
    orig = fused_dia.dia_matvec_fused
    monkeypatch.setattr(
        fused_dia, "dia_matvec_fused",
        lambda dia, **kw: picked_t.append(dia.shape[0]) or orig(dia, **kw),
    )
    rng = np.random.default_rng(5)
    for m in (16, 32, 30):  # n = 256, 1024, 900: the JAX package takes only 1024
        mat = test_util.laplacian_2d(m)
        jsparse.sparse_operator(mat, dtype=jnp.float32)
        jsparse.sparse_operator(mat, dtype=jnp.float16)
        mv, vals = sparse.sparse_operator(mat, device="cpu")
        assert mv.dia_data.shape == mat.shape
        # The kernel matvec's plain path gives the roll form's values.
        v = torch.tensor(rng.normal(size=m * m), dtype=torch.float32)
        torch.testing.assert_close(
            mv(v, vals), sparse.dia_matvec_fn(mv.dia_data)(v, vals), rtol=0, atol=1e-6
        )
        with pytest.raises(TypeError, match="float32"):
            sparse.sparse_operator(mat, dtype=torch.float64, device="cpu")
    assert picked_j == [1024]
    assert picked_t == [256, 1024, 900]


def test_sparse_operator_stays_on_the_roll_form_off_the_card():
    mat = test_util.laplacian_2d(32)  # n = 1024 would take the kernel on the card
    mv, _vals = sparse.sparse_operator(mat, device="cpu")
    assert mv.__qualname__ == sparse.dia_matvec_fn(mv.dia_data).__qualname__


@pytest.mark.parametrize("fmt", ["bsr", "ell", "hyb"])
def test_sparse_operator_refuses_the_formats_not_ported(fmt):
    """Every layout is ported now: an explicit ``format`` builds the JAX
    package's operator (same info, same product), and only the layouts
    with a kernel on the card (BSR, like DIA) refuse a dtype it does not
    take there."""
    mat = test_util.laplacian_2d(4)
    mv_t, vals_t, info_t = sparse.sparse_operator(mat, format=fmt, with_info=True, device="cpu")
    mv_j, vals_j, info_j = jsparse.sparse_operator(jax_laplacian_2d(4), format=fmt, with_info=True)
    assert info_t == info_j
    v = np.random.default_rng(6).normal(size=16).astype(np.float32)
    vals_t = vals_t if isinstance(vals_t, tuple) else (vals_t,)
    np.testing.assert_allclose(
        mv_t(torch.tensor(v), *vals_t).numpy(), np.asarray(mv_j(jnp.asarray(v), vals_j)), atol=1e-5
    )
    sparse.sparse_operator(mat, format=fmt, dtype=torch.float64, device="cpu")  # off the card: any dtype


def test_sparse_operator_auto_beyond_dia_raises_and_bad_format_is_a_value_error():
    """Beyond DIA, ``"auto"`` picks BSR or HYB as the JAX package does (it
    raised while they were not ported); an unknown format is the JAX
    package's ValueError."""
    mat = test_util.laplacian_2d(4)
    _mv, _vals, info_t = sparse.sparse_operator(mat, dia_max_diags=3, with_info=True, device="cpu")
    _mv, _vals, info_j = jsparse.sparse_operator(mat, dia_max_diags=3, with_info=True)
    assert info_t == info_j and info_t.format in ("bsr", "hyb")
    with pytest.raises(ValueError, match="not in") as got:
        sparse.sparse_operator(mat, format="csr", device="cpu")
    with pytest.raises(ValueError, match="not in") as want:
        jsparse.sparse_operator(mat, format="csr")
    assert str(got.value) == str(want.value)
