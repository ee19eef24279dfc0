"""The port's generic Arnoldi (``krylov.arnoldi.hessenberg``) and its
closed-form adjoint, and ``tridiag(reortho="full")`` through it, against
the JAX package on the same numpy inputs.

Algorithmic parity runs in float64 (scoped ``jax.enable_x64``); the
adjoint-vs-backprop oracle also in float32 with the JAX adjoint test's
tolerance, 10 sqrt(eps).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import arnoldi as jarnoldi  # noqa: E402
from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# float64 parity: the same recursions in another summation order.
_TOL64 = 1e-9


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _jax_done(tree):
    """JAX results as numpy, so no JAX work is in flight while PyTorch runs."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _problem(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 2 * np.eye(n), rng.standard_normal(n)


def _dense(s, p):
    return p @ s


def _assert_close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _jax_vjp(fn, v, A, seed):
    out, vjp = jax.vjp(fn, jnp.asarray(v), jnp.asarray(A))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(out)
    cot = [rng.standard_normal(np.shape(o)).astype(np.asarray(o).dtype) for o in leaves]
    grads = vjp(jax.tree_util.tree_unflatten(tree, [jnp.asarray(c) for c in cot]))
    return _jax_done((out, grads)), cot


def _torch_vjp(fn, v, A, cot):
    vt = torch.tensor(v, requires_grad=True)
    At = torch.tensor(A, requires_grad=True)
    out = fn(vt, At)
    return out, torch.autograd.grad(out, [vt, At], [torch.tensor(c) for c in cot])


@pytest.mark.parametrize(
    ("reortho", "reortho_vjp", "depth"),
    [("none", "match", 2), ("none", "match", 6), ("full", "match", 2), ("full", "match", 5),
     ("full", "match", 9), ("full", "none", 5), ("none", "full", 5)],
)
def test_hessenberg_and_its_adjoint_match_jax_in_float64(reortho, reortho_vjp, depth):
    A, v = _problem()
    with jax.enable_x64(True):
        fn_j = jarnoldi.hessenberg(_dense, depth, reortho=reortho, reortho_vjp=reortho_vjp)
        (out_j, grads_j), cot = _jax_vjp(fn_j, v, A, seed=depth)
    fn_t = arnoldi.hessenberg(_dense, depth, reortho=reortho, reortho_vjp=reortho_vjp)
    out_t, grads_t = _torch_vjp(fn_t, v, A, cot)
    assert out_t[0].shape == (10, depth) and out_t[1].shape == (depth, depth)
    for got, want in zip(out_t, out_j):
        _assert_close(got, want, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _assert_close(got, want, _TOL64)


@pytest.mark.parametrize(("reortho", "depth"), [("none", 2), ("full", 2), ("full", 5), ("full", 9)])
def test_closed_form_adjoint_matches_backprop(reortho, depth):
    """The JAX adjoint test's cases: float32, tolerance 10 sqrt(eps)."""
    A, v = (a.astype(np.float32) for a in _problem(seed=1))
    rng = np.random.default_rng(2)
    results = []
    for custom_vjp in (True, False):
        fn = arnoldi.hessenberg(_dense, depth, reortho=reortho, custom_vjp=custom_vjp)
        shapes = [(10, depth), (depth, depth), (10,), ()]
        if not results:
            cot = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        results.append(_torch_vjp(fn, v, A, cot))
    (out_c, grads_c), (out_b, grads_b) = results
    for got, want in zip(out_c, out_b):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)
    tol = 10 * np.sqrt(np.finfo(np.float32).eps)
    for got, want in zip(grads_c, grads_b):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol)
        assert not torch.equal(got, want)  # genuinely different code paths


@pytest.mark.parametrize("reortho", ["none", "full"])
def test_complex_forward_matches_jax(reortho):
    n, k = 10, 6
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    v = (np.arange(1.0, n + 1.0) + 0.5j).astype(np.complex64)
    out_j = _jax_done(jarnoldi.hessenberg(_dense, k, reortho=reortho)(jnp.asarray(v), jnp.asarray(A)))
    Q, H, res, c = arnoldi.hessenberg(_dense, k, reortho=reortho)(torch.tensor(v), torch.tensor(A))
    for got, want in zip((Q, H, res, c), out_j):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # The decomposition identity of the JAX forward test.
    e_k = np.eye(k, dtype=np.complex64)[-1]
    np.testing.assert_allclose((torch.tensor(A) @ Q).numpy(),
                               (Q @ H).numpy() + np.outer(res.numpy(), e_k), atol=1e-4, rtol=1e-4)
    if reortho == "full":
        np.testing.assert_allclose((Q.conj().T @ Q).numpy(), np.eye(k), atol=1e-5)


def test_full_rank_basis_is_orthonormal_with_zero_residual():
    n = 8
    A = np.random.default_rng(4).standard_normal((n, n)).astype(np.float32)
    Q, H, res, _c = arnoldi.hessenberg(_dense, n, reortho="full")(
        torch.arange(1.0, n + 1.0), torch.tensor(A))
    np.testing.assert_allclose((Q @ Q.T).numpy(), np.eye(n), atol=1e-4)
    np.testing.assert_allclose(res.numpy(), 0.0, atol=1e-3)
    np.testing.assert_allclose((Q.T @ torch.tensor(A) @ Q).numpy(), H.numpy(), atol=1e-4, rtol=1e-4)


def test_exhausted_krylov_space_truncates_like_jax():
    """A = 1.5 I with a one-hot v0: exactly exhausted after one step, so
    every later column, H entry and the residual are exact zeros, and the
    adjoint stays finite, as in the JAX package."""
    n, k = 12, 5
    A = 1.5 * np.eye(n)
    v = np.zeros(n)
    v[3] = 1.0
    for reortho in ("none", "full"):
        with jax.enable_x64(True):
            (out_j, grads_j), cot = _jax_vjp(jarnoldi.hessenberg(_dense, k, reortho=reortho), v, A, 5)
        out_t, grads_t = _torch_vjp(arnoldi.hessenberg(_dense, k, reortho=reortho), v, A, cot)
        Q, H, res, _c = (t.detach() for t in out_t)
        assert float(H[0, 0]) == 1.5 and float(Q[:, 1:].abs().max()) == 0.0
        assert float(res.abs().max()) == 0.0
        for got, want in zip(out_t, out_j):
            _assert_close(got, want, _TOL64)
        for got, want in zip(grads_t, grads_j):
            assert np.all(np.isfinite(got.numpy()))
            _assert_close(got, want, _TOL64)


def test_error_cases_are_the_jax_packages():
    with pytest.raises(TypeError) as want:
        jarnoldi.hessenberg(_dense, 3, reortho="occasionally")
    with pytest.raises(TypeError) as got:
        arnoldi.hessenberg(_dense, 3, reortho="occasionally")
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        jarnoldi.hessenberg(_dense, 3, reortho="full", reortho_vjp="maybe")
    with pytest.raises(TypeError) as got:
        arnoldi.hessenberg(_dense, 3, reortho="full", reortho_vjp="maybe")
    assert str(got.value) == str(want.value)
    for depth in (0, 100):
        with pytest.raises(ValueError, match="depth") as want:
            jarnoldi.hessenberg(lambda s: s, depth, reortho="full")(jnp.ones((4,)))
        with pytest.raises(ValueError, match="depth") as got:
            arnoldi.hessenberg(lambda s: s, depth, reortho="full")(torch.ones(4))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("custom_vjp", [True, False])
def test_full_reortho_tridiag_matches_jax_in_float64(custom_vjp):
    n, depth = 14, 7
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * np.linspace(1.0, 3.0, n)) @ q.T
    A = np.triu(A) - np.diag(0.5 * np.diag(A))  # the symmetrised parametrisation

    def sym(s, p):
        return (p + p.T) @ s

    v = rng.standard_normal(n)
    log_j, log_t = [], []
    with jax.enable_x64(True):
        fn_j = jlanczos.tridiag(sym, depth, reortho="full", custom_vjp=custom_vjp, dispatch_log=log_j)
        (out_j, grads_j), cot = _jax_vjp(fn_j, v, A, 7)
    fn_t = lanczos.tridiag(sym, depth, reortho="full", custom_vjp=custom_vjp, dispatch_log=log_t)
    vt, At = torch.tensor(v, requires_grad=True), torch.tensor(A, requires_grad=True)
    out_t = fn_t(vt, At)
    leaves_t = jax.tree_util.tree_leaves(out_t)
    grads_t = torch.autograd.grad(leaves_t, [vt, At], [torch.tensor(c) for c in cot])
    for got, want in zip(leaves_t, jax.tree_util.tree_leaves(out_j)):
        _assert_close(got, want, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _assert_close(got, want, _TOL64)
    assert log_j == ["tridiag:arnoldi_full", "hessenberg:xla_loop"]
    assert log_t == ["tridiag:arnoldi_full", "hessenberg:generic"]


def test_dispatch_log_of_the_generic_path():
    log = []
    arnoldi.hessenberg(_dense, 3, reortho="full", dispatch_log=log)(torch.ones(5), torch.eye(5))
    arnoldi.hessenberg(_dense, 3, reortho="none", custom_vjp=False, dispatch_log=log)(
        torch.ones(5), torch.eye(5))
    assert log == ["hessenberg:generic", "hessenberg:generic"]


def test_entry_point_refuses_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="pin_float32"):
            arnoldi.hessenberg(_dense, 3, reortho="full")(torch.ones(5), torch.eye(5))
    finally:
        pin_float32()
