"""The port's per-probe SLQ path against the JAX package on the same numpy
probes: the Hutchinson estimators, ``integrand_spd`` with its
Daleckii-Krein quadratic form, the reuse integrand,
``krylov_logdet_slq(blocked=False)`` with one and several batches,
``krylov_logdet_slq_vjp_reuse`` and ``ops.dense``.

Probes are drawn once in numpy and handed to both packages through a
``sample`` callable. Algorithmic parity runs in float64 (scoped
``jax.enable_x64``); the DIA case runs the port's fused route (K9's and
the DIA kernels' plain versions) in float32 against JAX's generic loop.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu.ops import dense as jdense  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu.trace import slq as jslq  # noqa: E402
from lanczos_adjoints_tpu_torch import parallel  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import dense, fused_arnoldi, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.trace import hutchinson, slq  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# The JAX package's ``trace/__init__`` exports the function ``hutchinson``
# under the module's name.
jhutchinson = importlib.import_module("lanczos_adjoints_tpu.trace.hutchinson")
_TOL64 = 1e-9
N, DEPTH, NUM = 30, 10, 4


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _jax_done(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spd(n=N, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.linspace(0.5, 5.0, n)) @ q.T


def _probes(num=NUM, n=N, seed=1):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(num, n))


def _close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _matvec_t(v, a):
    return a @ v


@pytest.mark.parametrize("reortho", ["full", "none"])
def test_integrand_spd_value_and_gradient_match_jax(reortho):
    A, v = _spd(), np.random.default_rng(2).standard_normal(N)
    with jax.enable_x64(True):
        value_j, grads_j = _jax_done(jax.value_and_grad(
            lambda v0, a: jlanczos.integrand_spd(jnp.log, DEPTH, lambda s, p: p @ s, reortho=reortho)(v0, a),
            argnums=(0, 1))(jnp.asarray(v), jnp.asarray(A)))
    vt, at = torch.tensor(v, requires_grad=True), torch.tensor(A, requires_grad=True)
    value_t = lanczos.integrand_spd(torch.log, DEPTH, _matvec_t, reortho=reortho)(vt, at)
    grads_t = torch.autograd.grad(value_t, [vt, at])
    _close(value_t, value_j, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _close(got, want, 1e-7)


def test_integrand_spd_takes_probes_of_any_shape():
    A = _spd(12)
    v = np.random.default_rng(3).standard_normal((3, 4))
    with jax.enable_x64(True):
        want = _jax_done(jlanczos.integrand_spd(
            jnp.log, 6, lambda s, p: (p @ s.reshape(-1)).reshape(3, 4))(jnp.asarray(v), jnp.asarray(A)))
    got = lanczos.integrand_spd(torch.log, 6, lambda s, p: (p @ s.reshape(-1)).reshape(3, 4))(
        torch.tensor(v), torch.tensor(A))
    _close(got, want, _TOL64)


@pytest.mark.parametrize("degenerate", [False, True])
def test_quadform_daleckii_krein_derivative_matches_jax(degenerate):
    """On an exactly degenerate spectrum (a decoupled identity block, as an
    exhausted Krylov space leaves) the derivative is finite; on a
    separated one it equals autodiff through ``eigh``."""
    if degenerate:
        diags, offdiags = np.array([1.0, 1.0, 1.0, 2.0]), np.array([0.0, 0.0, 0.5])
    else:
        diags, offdiags = np.array([2.0, 3.0, 5.0, 7.0]), np.array([0.3, 0.4, 0.5])
    with jax.enable_x64(True):
        value_j, grads_j = _jax_done(jax.value_and_grad(
            lambda d, o: jlanczos._quadform_tridiag(jnp.log, d, o), argnums=(0, 1)
        )(jnp.asarray(diags), jnp.asarray(offdiags)))
    d, o = torch.tensor(diags, requires_grad=True), torch.tensor(offdiags, requires_grad=True)
    value_t = lanczos._QuadformTridiag.apply(torch.log, d, o)
    grads_t = torch.autograd.grad(value_t, [d, o])
    _close(value_t, value_j, _TOL64)
    for got, want in zip(grads_t, grads_j):
        assert np.all(np.isfinite(got.numpy()))
        _close(got, want, 1e-8)
    if not degenerate:
        d2, o2 = torch.tensor(diags, requires_grad=True), torch.tensor(offdiags, requires_grad=True)
        through_eigh = torch.autograd.grad(lanczos._quadform_value(torch.log, d2, o2)[0], [d2, o2])
        for got, want in zip(grads_t, through_eigh):
            _close(got, want, 1e-8)


def test_reuse_integrand_value_and_gradients_match_jax():
    A, v = _spd(seed=4), np.random.default_rng(5).standard_normal(N)
    with jax.enable_x64(True):
        value_j, grads_j = _jax_done(jax.value_and_grad(
            lambda v0, a: jlanczos.integrand_spd_custom_vjp_reuse(jnp.log, DEPTH, lambda s, p: p @ s)(v0, a),
            argnums=(0, 1))(jnp.asarray(v), jnp.asarray(A)))
    vt, at = torch.tensor(v, requires_grad=True), torch.tensor(A, requires_grad=True)
    value_t = lanczos.integrand_spd_custom_vjp_reuse(torch.log, DEPTH, _matvec_t)(vt, at)
    grads_t = torch.autograd.grad(value_t, [vt, at])
    _close(value_t, value_j, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _close(got, want, 1e-7)


@pytest.mark.parametrize("num_batches", [1, 3])
def test_per_probe_logdet_slq_matches_jax(num_batches):
    """``blocked=False``: value, info and gradient; every batch sees the same
    probes on both sides."""
    A, probes = _spd(seed=6), _probes(seed=7)
    with jax.enable_x64(True):
        logdet_j = jslq.krylov_logdet_slq(DEPTH, sample=lambda _k: jnp.asarray(probes),
                                          num_batches=num_batches, checkpoint=False)
        (value_j, info_j), grad_j = _jax_done(jax.value_and_grad(
            lambda a: logdet_j(lambda v: a @ v, jax.random.PRNGKey(0)), has_aux=True)(jnp.asarray(A)))
    logdet_t = slq.krylov_logdet_slq(DEPTH, sample=lambda _k: torch.tensor(probes),
                                     num_batches=num_batches, checkpoint=True)
    at = torch.tensor(A, requires_grad=True)
    value_t, info_t = logdet_t(_matvec_t, None, at)
    (grad_t,) = torch.autograd.grad(value_t, [at])
    _close(value_t, value_j, _TOL64)
    _close(grad_t, grad_j, 1e-7)
    # Identical batches: zero spread (JAX's lax.map leaves rounding).
    assert abs(float(info_t["std_abs"])) <= 1e-12 * abs(float(value_j))
    assert abs(float(info_j["std_abs"])) <= 1e-12 * abs(float(value_j))
    exact = np.linalg.slogdet(A)[1]
    assert abs(value_t.item() - exact) < 0.2 * abs(exact)


def test_several_batches_draw_new_probes_from_the_generator():
    """Each batch draws the next probes: the mean and population std over
    batches, as ``jnp.mean`` / ``jnp.std`` of the per-batch values."""
    A = _spd(seed=8)
    sets = [_probes(seed=s) for s in (9, 10)]
    draws = iter(sets)
    logdet = slq.krylov_logdet_slq(DEPTH, sample=lambda _k: torch.tensor(next(draws)),
                                   num_batches=2, checkpoint=False)
    value, info = logdet(_matvec_t, None, torch.tensor(A))
    with jax.enable_x64(True):
        per_batch = [float(jslq.krylov_logdet_slq(DEPTH, sample=lambda _k, p=p: jnp.asarray(p),
                                                  num_batches=1, checkpoint=False)(
            lambda v: jnp.asarray(A) @ v, jax.random.PRNGKey(0))[0]) for p in sets]
    _close(value, np.mean(per_batch), _TOL64)
    _close(info["std_abs"], np.std(per_batch), 1e-7)
    _close(info["std_rel"], np.std(per_batch) / abs(np.mean(per_batch)), 1e-7)


def test_logdet_slq_vjp_reuse_matches_jax():
    A, probes = _spd(seed=11), _probes(seed=12)
    with jax.enable_x64(True):
        logdet_j = jslq.krylov_logdet_slq_vjp_reuse(DEPTH, sample=lambda _k: jnp.asarray(probes),
                                                    num_batches=2, checkpoint=False)
        (value_j, info_j), grad_j = _jax_done(jax.value_and_grad(
            lambda a: logdet_j(lambda v: a @ v, jax.random.PRNGKey(0)), has_aux=True)(jnp.asarray(A)))
    logdet_t = slq.krylov_logdet_slq_vjp_reuse(DEPTH, sample=lambda _k: torch.tensor(probes),
                                               num_batches=2, checkpoint=False)
    at = torch.tensor(A, requires_grad=True)
    value_t, info_t = logdet_t(_matvec_t, None, at)
    (grad_t,) = torch.autograd.grad(value_t, [at])
    _close(value_t, value_j, _TOL64)
    _close(grad_t, grad_j, 1e-7)
    assert abs(float(info_t["std"])) <= 1e-12 * abs(float(value_j))
    assert abs(float(info_j["std"])) <= 1e-12 * abs(float(value_j))


def test_per_probe_slq_on_a_dia_operator_takes_k9_on_the_card(monkeypatch):
    """The slice on the CPU: ``sparse_operator`` -> per-probe SLQ, with the
    card's dispatch forced. Every probe runs the fused forward (K9's
    plain version) and the adjoint over the DIA kernels' plain versions;
    float32 against JAX's generic loop over its roll matvec."""
    monkeypatch.setattr(native, "on_card", lambda device: True)
    calls = []
    orig = fused_arnoldi.hessenberg_dia_fused
    monkeypatch.setattr(fused_arnoldi, "hessenberg_dia_fused", lambda *a, **k: calls.append(a) or orig(*a, **k))
    mat = test_util.laplacian_2d(8)
    probes = _probes(num=3, n=64, seed=13).astype(np.float32)
    matvec_j, vals_j = jsparse.sparse_operator(mat, format="dia")
    logdet_j = jslq.krylov_logdet_slq(12, sample=lambda _k: jnp.asarray(probes), num_batches=1, checkpoint=False)
    value_j, grad_j = _jax_done(jax.value_and_grad(
        lambda p: logdet_j(lambda v: matvec_j(v, p), jax.random.PRNGKey(0))[0])(vals_j))

    matvec, vals = sparse.sparse_operator(mat, device="cpu")
    logdet_t = slq.krylov_logdet_slq(12, sample=lambda _k: torch.tensor(probes), num_batches=1, checkpoint=False)
    p = vals.clone().requires_grad_()
    value_t, _info = logdet_t(matvec, None, p)
    (grad_t,) = torch.autograd.grad(value_t, [p])
    assert len(calls) == 3
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    assert np.linalg.norm(grad_t.numpy() - grad_j) <= 1e-4 * np.linalg.norm(grad_j)


def _quad(v, a):
    return v @ (a @ v)


def test_hutchinson_estimators_match_jax():
    A, probes = _spd(seed=14), _probes(seed=15)
    sample_j, sample_t = (lambda _k: jnp.asarray(probes)), (lambda _k: torch.tensor(probes))
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        A_j = jnp.asarray(A)
        wants = _jax_done([
            jax.value_and_grad(lambda a: jhutchinson.hutchinson(_quad, sample_j)(key, a))(A_j),
            jax.value_and_grad(lambda a: jhutchinson.hutchinson_nograd(_quad, sample_j)(key, a))(A_j),
            jax.value_and_grad(lambda a: jhutchinson.hutchinson_custom_vjp(_quad, sample_j)(key, a))(A_j),
            jax.value_and_grad(lambda a: jhutchinson.hutchinson_batch(
                jhutchinson.hutchinson(_quad, sample_j), num=3)(key, a))(A_j),
        ])
    estimators = [
        hutchinson.hutchinson(_quad, sample_t),
        hutchinson.hutchinson_nograd(_quad, sample_t),
        hutchinson.hutchinson_custom_vjp(_quad, sample_t),
        hutchinson.hutchinson_batch(hutchinson.hutchinson(_quad, sample_t), num=3),
    ]
    for estimate, (value_j, grad_j) in zip(estimators, wants):
        at = torch.tensor(A, requires_grad=True)
        value_t = estimate(torch.Generator().manual_seed(0), at)
        (grad_t,) = torch.autograd.grad(value_t, [at])
        _close(value_t, value_j, _TOL64)
        _close(grad_t, grad_j, _TOL64)


def test_hutchinson_takes_structured_integrands_and_refuses_what_waits():
    probes = torch.tensor(_probes(seed=16))
    est = hutchinson.hutchinson(lambda v: (v.sum(), (v[0], v[1] * 2)), lambda _k: probes)
    total, (first, second) = est(None)
    _close(total, probes.sum(dim=1).mean(), 1e-12)
    _close(second, 2 * probes[:, 1].mean(), 1e-12)
    # Probe sharding (the multi-device layer) splits the 4 probes over a
    # mesh's "probes" axis and gives the unsharded estimate; 3 groups do
    # not divide 4 probes.
    sharded = hutchinson.hutchinson(
        lambda v: (v.sum(), (v[0], v[1] * 2)), lambda _k: probes,
        probe_sharding=parallel.NamedSharding(parallel.make_mesh({"probes": 2}, device="cpu"), "probes"),
    )(None)
    assert all(torch.equal(a, b) for a, b in zip((sharded[0], *sharded[1]), (total, first, second)))
    with pytest.raises(ValueError, match="divide evenly"):
        hutchinson.hutchinson(_quad, lambda _k: probes, probe_sharding=parallel.NamedSharding(
            parallel.make_mesh({"probes": 3}, device="cpu"), "probes"))(None, torch.eye(N))
    with pytest.raises(RuntimeError) as want:
        jhutchinson.hutchinson_custom_vjp(_quad, lambda _k: jnp.asarray(_probes()))(
            jax.random.PRNGKey(0), jnp.eye(N))
    with pytest.raises(RuntimeError) as got:
        hutchinson.hutchinson_custom_vjp(_quad, lambda _k: probes)(
            torch.Generator().manual_seed(0), torch.eye(N, dtype=torch.float64))
    assert str(got.value) == str(want.value)


def test_samplers_draw_from_the_generator():
    like = torch.ones((5, 7), dtype=torch.float64)
    for make in (hutchinson.sampler_normal, hutchinson.sampler_rademacher):
        sample = make(like, num=11)
        a, b = sample(torch.Generator().manual_seed(3)), sample(torch.Generator().manual_seed(3))
        assert a.shape == (11, 5, 7) and a.dtype == torch.float64
        torch.testing.assert_close(a, b)
    draws = hutchinson.sampler_normal(torch.ones(20_000), num=1)(torch.Generator().manual_seed(4))
    assert abs(float(draws.mean())) < 0.05 and abs(float(draws.std()) - 1.0) < 0.05


def test_dense_operator_matches_jax():
    A = np.random.default_rng(17).standard_normal((6, 6)).astype(np.float32)
    v = np.random.default_rng(18).standard_normal(6).astype(np.float32)
    want = np.asarray(jdense.dense_operator()(jnp.asarray(v), jnp.asarray(A)))
    got = dense.dense_operator()(torch.tensor(v), torch.tensor(A))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
