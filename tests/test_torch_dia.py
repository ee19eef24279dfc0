"""The port's DIA kernel matvec (K4, K5 through their plain versions on the
CPU) against the JAX package's Pallas DIA matvec in interpret mode.

Same numpy inputs on both sides; atol 1e-5, the JAX DIA test's tolerance.
Every case runs once with packed values and once with values in every
slot, the wrapped ones included, which the circular semantics must
reproduce.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.ops import pallas_dia as jpallas_dia  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_dia, native, sparse  # noqa: E402

N = 2048
OFFSET_SETS = [(-1, 0, 1), (-130, -7, 0, 7, 130), (-128, -1, 0, 1, 128)]


def _operator(offsets, packed, n=N, seed=0):
    """(JAX DIAData, float32 numpy values) of a banded matrix."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    for d in offsets:
        ok = (idx + d >= 0) & (idx + d < n)
        rows.append(idx[ok])
        cols.append((idx + d)[ok])
        vals.append(rng.normal(size=ok.sum()))
    mat = jsparse.csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), shape=(n, n)
    )
    dia = jsparse.dia_pack(mat)
    if packed:
        return dia, np.asarray(jsparse.dia_values(dia, mat.data).astype(jnp.float32))
    return dia, rng.normal(size=(len(offsets), n)).astype(np.float32)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "every-slot"])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_fused_matvec_and_vjp_match_the_jax_kernel(offsets, packed):
    dia_j, vals = _operator(offsets, packed)
    rng = np.random.default_rng(1)
    v = rng.normal(size=N).astype(np.float32)
    u = rng.normal(size=N).astype(np.float32)

    mv_j = jpallas_dia.dia_matvec_pallas(dia_j, interpret=True)
    out_j = np.asarray(mv_j(jnp.asarray(v), jnp.asarray(vals)))
    grads_j = jax.grad(
        lambda vv, vl: jnp.sum(jnp.asarray(u) * mv_j(vv, vl)), argnums=(0, 1)
    )(jnp.asarray(v), jnp.asarray(vals))
    dv_j, dvals_j = (np.asarray(g) for g in grads_j)

    dia_t, vals_t = sparse.dia_from_jax(dia_j, vals, device="cpu")
    mv_t = fused_dia.dia_matvec_fused(dia_t)
    assert mv_t.dia_data is dia_t
    v_t = torch.tensor(v, requires_grad=True)
    p_t = vals_t.clone().requires_grad_()
    out_t = mv_t(v_t, p_t)
    dv_t, dvals_t = torch.autograd.grad(out_t, [v_t, p_t], torch.tensor(u))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dv_t.numpy(), dv_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dvals_t.numpy(), dvals_j, rtol=0, atol=1e-5)


def test_backward_runs_only_the_products_that_are_needed(monkeypatch):
    """The transposed K4 runs only for v's gradient, K5 only for the values'."""
    calls = []
    matvec_rows, dvals_rows = fused_dia.dia_matvec_rows, fused_dia.dia_dvals_rows

    def spy_matvec(*a, kernel=fused_dia.DIA_MATVEC):
        calls.append(kernel.name)
        return matvec_rows(*a, kernel=kernel)

    def spy_dvals(*a):
        calls.append("dia_dvals")
        return dvals_rows(*a)

    monkeypatch.setattr(fused_dia, "dia_matvec_rows", spy_matvec)
    monkeypatch.setattr(fused_dia, "dia_dvals_rows", spy_dvals)
    dia_j, vals = _operator((-1, 0, 1), True)
    dia_t, vals_t = sparse.dia_from_jax(dia_j, vals, device="cpu")
    mv = fused_dia.dia_matvec_fused(dia_t)
    x, u = torch.randn(N), torch.randn(N)
    for v_grad, p_grad, want in (
        (False, True, ["dia_matvec", "dia_dvals"]),
        (True, False, ["dia_matvec", "dia_matvec_transposed"]),
        (True, True, ["dia_matvec", "dia_matvec_transposed", "dia_dvals"]),
    ):
        calls.clear()
        v, p = x.clone().requires_grad_(v_grad), vals_t.clone().requires_grad_(p_grad)
        wanted = [t for t in (v, p) if t.requires_grad]
        torch.autograd.grad(mv(v, p), wanted, u)
        assert calls == want
    # On CPU tensors nothing launches.
    assert fused_dia.DIA_MATVEC.launches == fused_dia.DIA_DVALS.launches == 0


def test_plain_versions_are_the_circular_operator_and_its_transpose():
    """In float64 against a dense matrix with the wrapped entries placed."""
    n, offsets = 64, (-70, -5, 0, 3, 64)  # |d| >= n wraps more than once
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(len(offsets), n))
    dense = np.zeros((n, n))
    for k, d in enumerate(offsets):
        dense[np.arange(n), (np.arange(n) + d) % n] += vals[k]
    x, u = rng.normal(size=n), rng.normal(size=n)
    vals_t, x_t, u_t = (torch.tensor(a) for a in (vals, x, u))
    np.testing.assert_allclose(fused_dia.dia_matvec_plain(offsets, x_t, vals_t).numpy(), dense @ x, atol=1e-12)
    neg, rolled = fused_dia.transposed(offsets, vals_t)
    np.testing.assert_allclose(fused_dia.dia_matvec_plain(neg, u_t, rolled).numpy(), dense.T @ u, atol=1e-12)
    # d/dvals[k, i] of u^T A x is u[i] x[(i + d_k) mod n].
    dvals = fused_dia.dia_dvals_plain(offsets, x_t, u_t).numpy()
    for k, d in enumerate(offsets):
        np.testing.assert_array_equal(dvals[k], u * x[(np.arange(n) + d) % n])


def test_rejects_n_not_a_multiple_of_1024_like_the_jax_kernel():
    dia_j, _vals = _operator((-1, 0, 1), True, n=100)
    with pytest.raises(ValueError, match="multiple") as want:
        jpallas_dia.dia_matvec_pallas(dia_j)
    dia_t, _ = sparse.dia_from_jax(dia_j, _vals, device="cpu")
    with pytest.raises(ValueError, match="multiple") as got:
        fused_dia.dia_matvec_fused(dia_t)
    assert str(got.value) == str(want.value)


def test_wrappers_check_dtype_shape_and_device():
    offsets = (-1, 0, 1)
    x, vals = torch.randn(1024), torch.randn(3, 1024)
    with pytest.raises(TypeError, match="float32"):
        fused_dia.dia_matvec_rows(offsets, x.double(), vals.double())
    with pytest.raises(ValueError, match="shape"):
        fused_dia.dia_matvec_rows(offsets, x, vals[:2])
    with pytest.raises(ValueError, match="contiguous"):
        fused_dia.dia_matvec_rows(offsets, x, vals.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        fused_dia.dia_dvals_rows(offsets, x, x[:10])
    with pytest.raises(ValueError, match="no DIA kernel"):
        fused_dia.dia_matvec_rows(offsets, x.to("meta"), vals.to("meta"))


def test_offsets_reach_the_kernels_reduced_modulo_n():
    got = native.offsets_arg((-1024, -1, 0, 1, 1024, 2049), 1024)
    assert got.dtype == torch.int32 and got.tolist() == [0, 1023, 0, 1, 0, 1]
    # One tensor per operator and device, built once; signed where n is None.
    assert native.offsets_arg((-1024, -1, 0, 1, 1024, 2049), 1024, "cpu") is got
    assert native.offsets_arg((-3, 0, 3), None).tolist() == [-3, 0, 3]
    with pytest.raises(ValueError, match="at least one diagonal"):
        native.offsets_arg((), 1024)


def test_one_registry_holds_every_kernel_and_counts_only_launches():
    from lanczos_adjoints_tpu_torch.ops import (  # noqa: F401
        fused_arnoldi,
        fused_bsr,
        fused_gram,
        fused_lanczos,
    )
    from lanczos_adjoints_tpu_torch.parallel import fused_halo

    assert sorted(native.KERNELS) == [
        "arnoldi_dia_forward", "bsr_spmv", "dia_dvals", "dia_matvec", "dia_matvec_transposed",
        "gram_dgrads", "gram_grads", "gram_matvec", "halo_dia_matvec", "halo_dia_matvec_transposed",
        "lanczos_dia_adjoint", "lanczos_dia_forward",
    ]
    assert native.KERNELS["lanczos_dia_forward"] is fused_lanczos.LANCZOS_FORWARD
    assert native.KERNELS["arnoldi_dia_forward"] is fused_arnoldi.ARNOLDI_FORWARD
    assert native.KERNELS["halo_dia_matvec"] is fused_halo.HALO_DIA
    # Every source holds a registered kernel, but the card's limits query.
    assert set(native.SOURCES) == {k.source for k in native.KERNELS.values()} | {"device"}
    assert "lat_device_limits" in native._SIGNATURES["device"]
    with pytest.raises(ValueError, match="twice"):
        native.Kernel("dia_matvec", "dia", "lat_dia_matvec")
    native.KERNELS["dia_dvals"].launches = 3
    native.reset_launches()
    assert set(native.launch_counts().values()) == {0}
