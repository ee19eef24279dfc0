"""The PyTorch port's blocked Lanczos, PCG, preconditioner and blocked SLQ
against the JAX package, on the same numpy inputs.

Algorithmic parity is checked in float64 (``jax.enable_x64(True)``,
scoped) with a dense matvec; the preconditioner, which the JAX package
builds in float32, is compared in float32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.trace import slq as jslq  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp  # noqa: E402
from lanczos_adjoints_tpu_torch.precond import low_rank  # noqa: E402
from lanczos_adjoints_tpu_torch.solvers import cg  # noqa: E402
from lanczos_adjoints_tpu_torch.trace import slq  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# float64 parity: the two packages run the same recursions in another
# summation order, so they agree to round-off amplified by the Krylov depth.
_TOL64 = 1e-8


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _spd(n, seed, low=1.0, high=4.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.linspace(low, high, n)) @ q.T


def _jax_done(tree):
    """JAX results as numpy arrays, so no JAX work is in flight while the
    PyTorch side runs (the two have been seen to interfere in one process
    when they overlap, on the first PyTorch call)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _dense_jax(v, a):
    return a @ v


def _dense_torch(v, a):
    return a @ v


def _tridiag_loss(out):
    (xs, (al, be)), (r, rb) = out
    return (al**2).sum() + (be**2).sum() + (xs[-1] ** 2).sum() + rb.sum() + (r**3).sum()


@pytest.mark.parametrize("reortho", ["none", "full"])
def test_tridiag_block_forward_matches_jax(reortho):
    n, m, depth = 30, 4, 8
    A = _spd(n, 0)
    V = np.random.default_rng(1).standard_normal((n, m))
    with jax.enable_x64(True):
        (xs_j, (al_j, be_j)), (r_j, rb_j) = _jax_done(jlanczos.tridiag_block(
            _dense_jax, depth, reortho=reortho
        )(jnp.asarray(V), jnp.asarray(A)))
    (xs_t, (al_t, be_t)), (r_t, rb_t) = lanczos.tridiag_block(
        _dense_torch, depth, reortho=reortho
    )(torch.tensor(V), torch.tensor(A))
    for got, want in ((xs_t, xs_j), (al_t, al_j), (be_t, be_j), (r_t, r_j), (rb_t, rb_j)):
        assert got.shape == want.shape
        _close(got, want, _TOL64)


@pytest.mark.parametrize("reortho", ["none", "full"])
def test_tridiag_block_adjoint_matches_jax(reortho):
    n, m, depth = 24, 3, 6
    A = _spd(n, 2)
    V = np.random.default_rng(3).standard_normal((n, m))
    with jax.enable_x64(True):
        fn_j = jlanczos.tridiag_block(_dense_jax, depth, reortho=reortho)
        dv_j, da_j = _jax_done(jax.jit(jax.grad(lambda v, a: _tridiag_loss(fn_j(v, a)), argnums=(0, 1)))(
            jnp.asarray(V), jnp.asarray(A)
        ))
    v_t = torch.tensor(V, requires_grad=True)
    a_t = torch.tensor(A, requires_grad=True)
    fn_t = lanczos.tridiag_block(_dense_torch, depth, reortho=reortho)
    dv_t, da_t = torch.autograd.grad(_tridiag_loss(fn_t(v_t, a_t)), [v_t, a_t])
    _close(dv_t, dv_j, _TOL64)
    _close(da_t, da_j, _TOL64)


@pytest.mark.parametrize("reortho", ["none", "full"])
def test_tridiag_block_adjoint_matches_backprop(reortho):
    """The closed-form adjoint against autograd through the loop
    (dV exactly, dA in its symmetric part, as in the JAX package's tests)."""
    n, m, depth = 20, 3, 6
    A = torch.tensor(_spd(n, 4))
    V = torch.tensor(np.random.default_rng(5).standard_normal((n, m)))
    grads = []
    for custom_vjp in (True, False):
        v_t, a_t = V.clone().requires_grad_(), A.clone().requires_grad_()
        fn = lanczos.tridiag_block(_dense_torch, depth, reortho=reortho, custom_vjp=custom_vjp)
        grads.append(torch.autograd.grad(_tridiag_loss(fn(v_t, a_t)), [v_t, a_t]))
    (dv_a, da_a), (dv_b, da_b) = grads
    _close(dv_a, dv_b, 1e-7)
    _close(0.5 * (da_a + da_a.T), 0.5 * (da_b + da_b.T), 1e-7)


def test_tridiag_block_rejects_bad_arguments():
    with pytest.raises(ValueError, match="reortho"):
        lanczos.tridiag_block(_dense_torch, 3, reortho="junk")
    with pytest.raises(ValueError, match="outside the expected range"):
        lanczos.tridiag_block(_dense_torch, 9)(torch.ones((4, 2)), torch.eye(4))


def test_pcg_adaptive_value_and_gradient_match_jax():
    n = 40
    A = _spd(n, 6, 0.5, 20.0)
    rng = np.random.default_rng(7)
    b, w = rng.standard_normal(n), rng.standard_normal(n)
    pdiag = 1.0 / np.diag(A)
    kw = {"atol": 1e-10, "rtol": 1e-10, "maxiter": 200, "miniter": 2}
    with jax.enable_x64(True):
        solve_j = jsolvers.pcg_adaptive(**kw)
        P_j = jnp.asarray(pdiag)

        def loss_j(bb, a):
            x, info = solve_j(lambda v: a @ v, bb, lambda r: P_j * r)
            return jnp.dot(x, jnp.asarray(w)), (x, info["num_steps"])

        (val_j, (x_j, steps_j)), (db_j, da_j) = _jax_done(jax.jit(jax.value_and_grad(
            loss_j, argnums=(0, 1), has_aux=True
        ))(jnp.asarray(b), jnp.asarray(A)))
    b_t = torch.tensor(b, requires_grad=True)
    a_t = torch.tensor(A, requires_grad=True)
    P_t = torch.tensor(pdiag)
    x_t, info = cg.pcg_adaptive(**kw)(_dense_torch, b_t, a_t, P=lambda r: P_t * r)
    db_t, da_t = torch.autograd.grad(torch.dot(x_t, torch.tensor(w)), [b_t, a_t])
    assert float(info["num_steps"]) == float(steps_j)
    _close(x_t, x_j, 1e-9)
    _close(db_t, db_j, 1e-9)
    _close(da_t, da_j, 1e-9)
    np.testing.assert_allclose(x_t.detach().numpy(), np.linalg.solve(A, b), rtol=1e-8)


def test_cg_adaptive_stops_at_tolerance_and_miniter():
    A = torch.tensor(_spd(30, 8))
    b = torch.tensor(np.random.default_rng(9).standard_normal(30))
    _x, info = cg.cg_adaptive(atol=1e3, rtol=0.0, maxiter=50, miniter=3)(_dense_torch, b, A)
    assert float(info["num_steps"]) == 3.0
    x, info = cg.cg_adaptive(atol=1e-9, rtol=0.0, maxiter=50, miniter=0)(_dense_torch, b, A)
    assert 3 < float(info["num_steps"]) < 50
    torch.testing.assert_close(A @ x, b, rtol=1e-7, atol=1e-7)


def _lazy_kernel_inputs(n=96, d=3, seed=10):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), np.float32(0.3), np.float32(0.1)


def test_blocked_cholesky_and_woodbury_match_jax():
    X, raw_ell, raw_out = _lazy_kernel_inputs()
    n, rank, block, s = len(X), 32, 8, 0.05
    kernel_j = jgp.kernel_scaled_matern_32(shape_in=(3,), shape_out=())[0](
        raw_lengthscale=jnp.full((3,), raw_ell), raw_outputscale=jnp.asarray(raw_out)
    )
    Xj = jnp.asarray(X)
    L_j, info_j = _jax_done(jax.jit(
        lambda: jprecond.cholesky_partial_pivot_blocked(rank=rank, block=block)(
            lambda i, j: kernel_j(Xj[i], Xj[j]), n
        )
    )())
    kernel_t = gp.kernel_scaled_matern_32(shape_in=(3,), shape_out=())[0](
        raw_lengthscale=torch.full((3,), float(raw_ell)), raw_outputscale=torch.tensor(raw_out)
    )
    Xt = torch.tensor(X)
    L_t, info_t = low_rank.cholesky_partial_pivot_blocked(rank=rank, block=block)(
        lambda i, j: kernel_t(Xt[i], Xt[j]), n
    )
    assert bool(info_t["success"]) == bool(info_j["success"])
    # eigh fixes each column's sign only up to the library: compare L L^T.
    L_j = np.asarray(L_j, np.float64)
    _close(L_t.double() @ L_t.double().T, L_j @ L_j.T, 1e-4)

    v = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    solve_j = jprecond.preconditioner(jprecond.cholesky_partial_pivot_blocked(rank=rank, block=block))
    pre_j = jax.jit(lambda vv: solve_j(lambda i, j: kernel_j(Xj[i], Xj[j]), n)[0](vv, s))
    pre_t, _ = low_rank.preconditioner(low_rank.cholesky_partial_pivot_blocked(rank=rank, block=block))(
        lambda i, j: kernel_t(Xt[i], Xt[j]), n
    )
    _close(pre_t(torch.tensor(v), s), _jax_done(pre_j(jnp.asarray(v))), 1e-4)
    dense = np.linalg.solve(s * np.eye(n) + L_j @ L_j.T, v)
    _close(low_rank.woodbury_solve(L_t, torch.tensor(v), s), dense, 1e-3)


def test_preconditioner_refuses_gradients():
    L = torch.ones((8, 2), requires_grad=True)
    with pytest.raises(RuntimeError, match="must not be differentiated"):
        low_rank.woodbury_solve(L, torch.ones(8), 0.5).sum().backward()

    X, _, _ = _lazy_kernel_inputs(n=16)
    raw_ell = torch.tensor(0.2, requires_grad=True)
    kernel = gp.kernel_scaled_rbf(shape_in=(3,), shape_out=())[0](
        raw_lengthscale=raw_ell, raw_outputscale=torch.tensor(0.0)
    )
    cov = gp._CovarianceOp(gp.gram_matvec(), kernel, torch.tensor(X))
    L, _ = low_rank.cholesky_partial_pivot_blocked(rank=8, block=4)(cov.elem, 16)
    with pytest.raises(RuntimeError, match="must not be differentiated"):
        L.sum().backward()


def test_blocked_cholesky_rejects_bad_rank():
    with pytest.raises(ValueError, match="multiple"):
        low_rank.cholesky_partial_pivot_blocked(rank=10, block=4)
    with pytest.raises(ValueError, match="Rank exceeds"):
        low_rank.cholesky_partial_pivot_blocked(rank=8, block=4)(None, 4)


@pytest.mark.parametrize("matfun", ["log", "log_clipped"])
def test_blocked_slq_value_and_gradient_match_jax(matfun):
    n, depth, num = 40, 12, 5
    A = _spd(n, 12, 0.1, 10.0)
    probes = np.random.default_rng(13).choice([-1.0, 1.0], size=(num, n))
    with jax.enable_x64(True):
        fun_j = jnp.log if matfun == "log" else jslq.log_clipped()
        logdet_j = jslq.krylov_logdet_slq(
            depth, sample=lambda _key: jnp.asarray(probes), num_batches=1,
            checkpoint=False, matfun=fun_j, blocked=True,
        )
        val_j, da_j = _jax_done(jax.jit(jax.value_and_grad(
            lambda a: logdet_j(lambda V: a @ V, jax.random.PRNGKey(0))[0]
        ))(jnp.asarray(A)))
    fun_t = torch.log if matfun == "log" else slq.log_clipped()
    logdet_t = slq.krylov_logdet_slq(
        depth, sample=lambda _key: torch.tensor(probes), num_batches=1,
        checkpoint=False, matfun=fun_t, blocked=True,
    )
    a_t = torch.tensor(A, requires_grad=True)
    val_t, info = logdet_t(_dense_torch, None, a_t)
    (da_t,) = torch.autograd.grad(val_t, [a_t])
    _close(val_t, val_j, _TOL64)
    _close(da_t, da_j, 1e-7)
    assert info == {"std_abs": 0.0, "std_rel": 0.0}
    # And close to the exact log-determinant (SLQ is unbiased; 5 probes).
    assert abs(val_t.item() - np.linalg.slogdet(A)[1]) < 0.2 * abs(np.linalg.slogdet(A)[1])


def test_slq_modes_of_a_later_slice_raise():
    with pytest.raises(NotImplementedError, match="arnoldi"):
        slq.krylov_logdet_slq(5, sample=None, num_batches=1, checkpoint=False)
    with pytest.raises(NotImplementedError, match="num_batches"):
        slq.krylov_logdet_slq(5, sample=None, num_batches=2, checkpoint=False, blocked=True)


def test_rademacher_sampler_draws_signs_from_generator():
    from lanczos_adjoints_tpu_torch.trace import hutchinson

    sample = hutchinson.sampler_rademacher(torch.ones(64, dtype=torch.float64), num=7)
    a = sample(torch.Generator().manual_seed(3))
    b = sample(torch.Generator().manual_seed(3))
    assert a.shape == (7, 64) and a.dtype == torch.float64
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    torch.testing.assert_close(a, b)
