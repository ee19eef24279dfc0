"""The port's GP driver against the JAX package's, module by module, on the CPU.

The posterior mean (``likelihood_condition[_p]``, ``target_posterior``,
``_CovarianceOp.cross_matvec``), the plain likelihood with its Cholesky,
``torch.distributions`` and Krylov log-pdfs, fixed-step CG, the
partitioned and sequential Gram policies, the driver's evaluation
closures against the JAX driver's own (``_common.py``, loaded by path),
its epoch loop with checkpoints, and the JAX run's initial parameters.
Inputs and probes are drawn once with numpy and handed to both packages;
float64 parity runs under a scoped ``jax.enable_x64(True)``.
"""

import argparse
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.utils import exp_util as jexp_util  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp  # noqa: E402
from lanczos_adjoints_tpu_torch.precond import low_rank  # noqa: E402
from lanczos_adjoints_tpu_torch.solvers import cg  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.trace import slq  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import checkpoint  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COMMON = REPO / "experiments/applications/gaussian_process/train/_common.py"
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The problems here are small: one intra-op thread runs them faster
    and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _data(n, d, n_query=0, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n + n_query, d))
    y = np.sin(X @ rng.standard_normal(d)) + 0.1 * rng.standard_normal(n + n_query)
    params = {
        "constant_value": np.asarray(0.1),
        "raw_lengthscale": rng.uniform(0.3, 1.0, d),
        "raw_outputscale": np.asarray(0.4),
        "raw_noise": np.asarray(-1.0),
    }
    return X[:n], y[:n], X[n:], params


def _jax_prior(factory, d):
    mean, _ = jgp.mean_constant(shape_out=())
    kernel, _ = factory(shape_in=(d,), shape_out=())
    return jgp.model_gp(mean, kernel)


def _torch_prior(factory, d):
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = factory(shape_in=(d,), shape_out=())
    return gp.model_gp(mean, kernel)


def _split_params(params, to):
    return (
        {"constant_value": to(params["constant_value"])},
        {"raw_lengthscale": to(params["raw_lengthscale"]), "raw_outputscale": to(params["raw_outputscale"])},
        {"raw_noise": to(params["raw_noise"])},
    )


# ---------------------------------------------------------------------------
# The posterior mean
# ---------------------------------------------------------------------------

CONDITION_CASES = [("dense", "float64", 1e-6), ("dense", "float32", 1e-4), ("fused", "float32", 1e-4)]


def _jax_posterior_mean(likelihood, factory, X, y, Xq, params, to_j):
    """The JAX package's posterior mean at ``Xq``, jitted (eager JAX takes seconds)."""
    d = X.shape[1]

    def mean_at(X_, y_, Xq_, p1, p2, p3):
        condition, _ = jgp.target_posterior(_jax_prior(factory, d), likelihood)(X_, y_, p1, p2, p3)
        return condition(Xq_)[0]

    return np.asarray(jax.jit(mean_at)(to_j(X), to_j(y), to_j(Xq), *_split_params(params, to_j)))


@pytest.mark.parametrize(("policy", "dtype", "tol"), CONDITION_CASES)
def test_posterior_mean_preconditioned_matches_jax(policy, dtype, tol):
    np_dtype, torch_dtype = DTYPES[dtype]
    X, y, Xq, params = _data(300, 3, n_query=50)
    atol = 1e-10 if dtype == "float64" else 1e-5
    with jax.enable_x64(dtype == "float64"):
        likelihood_j, _ = jgp.likelihood_condition_p(
            jgp.gram_matvec(), jsolvers.pcg_adaptive(atol=atol, rtol=0.0, maxiter=200, miniter=10),
            precondition=jprecond.preconditioner(jprecond.cholesky_partial_pivot_blocked(rank=32, block=16)),
            constrain=jgp.constraint_greater_than(1e-4),
        )
        want = _jax_posterior_mean(likelihood_j, jgp.kernel_scaled_matern_32, X, y, Xq, params,
                                   lambda a: jnp.asarray(np.asarray(a, np_dtype)))

    to_t = lambda a: torch.tensor(np.asarray(a, np_dtype), dtype=torch_dtype)  # noqa: E731
    matvec = gp.gram_matvec() if policy == "dense" else gp.gram_matvec_fused()
    likelihood_t, _ = gp.likelihood_condition_p(
        matvec, cg.pcg_adaptive(atol=atol, rtol=0.0, maxiter=200, miniter=10),
        precondition=low_rank.preconditioner(low_rank.cholesky_partial_pivot_blocked(rank=32, block=16)),
        constrain=gp.constraint_greater_than(1e-4),
    )
    posterior_t = gp.target_posterior(_torch_prior(gp.kernel_scaled_matern_32, 3), likelihood_t)
    condition_t, _ = posterior_t(to_t(X), to_t(y), *_split_params(params, to_t))
    got, info = condition_t(to_t(Xq))
    assert got.shape == (50,) and got.dtype == torch_dtype
    assert _rel(got.numpy(), want) <= tol
    assert set(info["solve"]) >= {"residual_abs", "residual_rel", "num_steps"}


def _torch_condition(X, y, params, solve):
    likelihood, _ = gp.likelihood_condition(gp.gram_matvec(), solve, constrain=gp.constraint_greater_than(0.0))
    posterior = gp.target_posterior(_torch_prior(gp.kernel_scaled_rbf, X.shape[1]), likelihood)
    to_t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    condition, _ = posterior(to_t(X), to_t(y), *_split_params(params, to_t))
    return lambda xs: condition(to_t(xs))[0].numpy()


def test_posterior_mean_unpreconditioned_matches_jax():
    X, y, Xq, params = _data(40, 2, n_query=10, seed=1)
    likelihood_j, _ = jgp.likelihood_condition(
        jgp.gram_matvec(), jsolvers.cg_adaptive(atol=1e-6, rtol=1e-6, maxiter=200, miniter=2),
        constrain=jgp.constraint_greater_than(0.0),
    )
    condition_t = _torch_condition(X, y, params, cg.cg_adaptive(atol=1e-6, rtol=1e-6, maxiter=200, miniter=2))
    for xs in (X, Xq):
        want = _jax_posterior_mean(likelihood_j, jgp.kernel_scaled_rbf, X, y, xs, params,
                                   lambda a: jnp.asarray(np.asarray(a, np.float32)))
        assert _rel(condition_t(xs), want) <= 1e-4


def test_posterior_mean_interpolates():
    # tests/test_models/test_gp.py::test_posterior_mean_interpolates: six
    # points, tiny noise.
    X, y, _Xq, params = _data(6, 2, seed=2)
    params = {**params, "raw_lengthscale": np.full(2, 0.5), "raw_noise": np.asarray(-10.0)}
    condition = _torch_condition(X, y, params, cg.cg_adaptive(atol=1e-6, rtol=1e-6, maxiter=100, miniter=2))
    np.testing.assert_allclose(condition(X), np.asarray(y, np.float32), atol=1e-2)


# ---------------------------------------------------------------------------
# The plain likelihood and its log-pdfs
# ---------------------------------------------------------------------------

# tests/test_models/test_gp_golden.py: GPyTorch's conventions in float64.
GOLDEN_X = [[0.1, 0.2], [0.4, 0.3], [0.9, 0.6]]
GOLDEN_Y = [0.5, -0.3, 0.8]
GOLDEN_PARAMS = {"constant_value": 0.1, "raw_lengthscale": [0.25, -0.5], "raw_outputscale": 0.35,
                 "raw_noise": -1.0}
GOLDEN_MLL = {"rbf": -3.4627322401805616, "matern12": -3.381627482922573, "matern32": -3.41257287045953}
KERNELS = {"rbf": gp.kernel_scaled_rbf, "matern12": gp.kernel_scaled_matern_12,
           "matern32": gp.kernel_scaled_matern_32}


@pytest.mark.parametrize("logpdf", ["cholesky", "scipy_stats"])
@pytest.mark.parametrize("kind", sorted(GOLDEN_MLL))
def test_dense_logpdfs_match_the_golden_constants(kind, logpdf):
    backend = gp.logpdf_cholesky() if logpdf == "cholesky" else gp.logpdf_scipy_stats()
    likelihood, _ = gp.likelihood_pdf(gp.gram_matvec(), backend, constrain=gp.constraint_greater_than(0.0))
    to_t = lambda a: torch.tensor(a, dtype=torch.float32, requires_grad=True)  # noqa: E731
    p1, p2, p3 = _split_params(GOLDEN_PARAMS, to_t)
    value, _ = gp.target_logml(_torch_prior(KERNELS[kind], 2), likelihood)(
        torch.tensor(GOLDEN_X), torch.tensor(GOLDEN_Y), params_mean=p1, params_kernel=p2, params_likelihood=p3
    )
    assert abs(value.item() - GOLDEN_MLL[kind]) <= 1e-5 * abs(GOLDEN_MLL[kind])
    grads = torch.autograd.grad(value, [*p1.values(), *p2.values(), *p3.values()])
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0) for g in grads)


def _flat_template(d):
    _m, p_mean = jgp.mean_constant(shape_out=())
    _k, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
    _l, p_lik = jgp.likelihood_pdf(None, None, constrain=None)
    return ravel_pytree((p_mean, p_kernel, p_lik))[1]


def test_krylov_logpdf_value_and_gradient_match_jax():
    X, y, _Xq, params = _data(64, 3, seed=2)
    X, y = X.astype(np.float32), y.astype(np.float32)
    probes = np.random.default_rng(2).choice([-1.0, 1.0], size=(6, 64)).astype(np.float32)
    flat = np.concatenate([np.ravel(params[k]) for k in
                           ("constant_value", "raw_lengthscale", "raw_outputscale", "raw_noise")])
    flat = flat.astype(np.float32)
    unflatten = _flat_template(3)

    def loss_j(p):
        logdet = jgp.krylov_logdet_slq(12, sample=lambda _k: jnp.asarray(probes), num_batches=1,
                                       checkpoint=False)
        likelihood, _ = jgp.likelihood_pdf(
            jgp.gram_matvec(), jgp.logpdf_krylov(jsolvers.cg_fixed_step(40), logdet),
            constrain=jgp.constraint_greater_than(1e-4),
        )
        p1, p2, p3 = unflatten(p)
        value, _ = jgp.target_logml(_jax_prior(jgp.kernel_scaled_matern_32, 3), likelihood)(
            jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(0),
            params_mean=p1, params_kernel=p2, params_likelihood=p3,
        )
        return value

    value_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(flat))

    logdet_t = slq.krylov_logdet_slq(12, sample=lambda _k: torch.tensor(probes), num_batches=1,
                                     checkpoint=False)
    likelihood_t, _ = gp.likelihood_pdf(
        gp.gram_matvec(), gp.logpdf_krylov(cg.cg_fixed_step(40), logdet_t),
        constrain=gp.constraint_greater_than(1e-4),
    )
    p = torch.tensor(flat, requires_grad=True)
    p1, p2, p3 = gp.unflatten_params(p, 3)
    value_t, info = gp.target_logml(_torch_prior(gp.kernel_scaled_matern_32, 3), likelihood_t)(
        torch.tensor(X), torch.tensor(y), None, params_mean=p1, params_kernel=p2, params_likelihood=p3
    )
    (grad_t,) = torch.autograd.grad(value_t, [p])
    assert abs(value_t.item() - float(value_j)) <= 1e-5 * abs(float(value_j))
    assert _rel(grad_t.numpy(), np.asarray(grad_j)) <= 1e-3
    assert "num_steps" not in info["solve"]


# ---------------------------------------------------------------------------
# Fixed-step CG
# ---------------------------------------------------------------------------


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * (1.0 + 4.0 * np.arange(n) / n)) @ q.T
    return A, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fixed_step_cg_value_and_implicit_gradient_match_jax(preconditioned, dtype):
    np_dtype, torch_dtype = DTYPES[dtype]
    n, steps = 24, 8
    A, b, w = (a.astype(np_dtype) for a in _spd(n))
    diag = np.diag(A).copy()
    tol = 1e-10 if dtype == "float64" else 1e-4

    with jax.enable_x64(dtype == "float64"):
        def loss_j(shift, b_):
            op = lambda v: jnp.asarray(A) @ v + shift * v  # noqa: E731
            if preconditioned:
                x, _ = jsolvers.pcg_fixed_step(steps)(op, b_, lambda v: v / (jnp.asarray(diag) + shift))
            else:
                x, _ = jsolvers.cg_fixed_step(steps)(op, b_)
            return jnp.dot(x, jnp.asarray(w)), x

        (_v, x_j), (g_shift_j, g_b_j) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
            jnp.asarray(0.5, np_dtype), jnp.asarray(b))
        x_j, g_shift_j, g_b_j = (np.asarray(a) for a in (x_j, g_shift_j, g_b_j))

    At, diag_t = torch.tensor(A), torch.tensor(diag)
    shift = torch.tensor(0.5, dtype=torch_dtype, requires_grad=True)
    b_t = torch.tensor(b, requires_grad=True)
    op = lambda v, s: At @ v + s * v  # noqa: E731
    if preconditioned:
        x_t, info = cg.pcg_fixed_step(steps)(op, b_t, shift, P=lambda v: v / (diag_t + 0.5))
    else:
        x_t, info = cg.cg_fixed_step(steps)(op, b_t, shift)
    g_shift_t, g_b_t = torch.autograd.grad(torch.dot(x_t, torch.tensor(w)), [shift, b_t])
    assert set(info) == {"residual_abs", "residual_rel"}
    assert _rel(x_t.detach().numpy(), x_j) <= tol
    assert _rel(g_b_t.numpy(), g_b_j) <= tol
    assert abs(g_shift_t.item() - float(g_shift_j)) <= tol * abs(float(g_shift_j))


def test_cg_fixed_full_steps_equals_dense_solve():
    n = 10
    A, b, _w = (torch.tensor(a, dtype=torch.float32) for a in _spd(n, seed=1))
    x, _info = cg.cg_fixed_step(n)(lambda v: A @ v, b)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A.double().numpy(), b.double().numpy()),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The partitioned and sequential Gram policies
# ---------------------------------------------------------------------------

POLICIES = {
    "partitioned": (lambda: jgp.gram_matvec_partitioned(4, checkpoint=False),
                    lambda: gp.gram_matvec_partitioned(4, checkpoint=False)),
    "partitioned-checkpoint": (lambda: jgp.gram_matvec_partitioned(4, checkpoint=True),
                               lambda: gp.gram_matvec_partitioned(4, checkpoint=True)),
    "sequential": (lambda: jgp.gram_matvec_sequential(checkpoint=True),
                   lambda: gp.gram_matvec_sequential(checkpoint=True)),
}


@pytest.mark.parametrize("rhs", [(), (3,)])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gram_policies_match_jax(policy, rhs):
    rng = np.random.default_rng(4)
    n, d = 32, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((n, *rhs)).astype(np.float32)
    u = rng.standard_normal((n, *rhs)).astype(np.float32)
    raw_ell = rng.uniform(0.2, 1.0, d).astype(np.float32)
    raw_out = np.float32(0.3)
    policy_j, policy_t = (make() for make in POLICIES[policy])

    def loss_j(ell, out, v_):
        kernel, _ = jgp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
        k = kernel(raw_lengthscale=ell, raw_outputscale=out)
        return jnp.sum(policy_j(k)(jnp.asarray(X), jnp.asarray(X), v_) * jnp.asarray(u))

    value_j, grads_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2)))(
        jnp.asarray(raw_ell), jnp.asarray(raw_out), jnp.asarray(v))

    factory, _ = gp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
    ell_t, out_t = torch.tensor(raw_ell, requires_grad=True), torch.tensor(raw_out, requires_grad=True)
    v_t = torch.tensor(v, requires_grad=True)
    kernel_t = factory(raw_lengthscale=ell_t, raw_outputscale=out_t)
    out = policy_t(kernel_t)(torch.tensor(X), torch.tensor(X), v_t, ell_t, out_t)
    assert out.shape == (n, *rhs)
    value_t = torch.sum(out * torch.tensor(u))
    grads_t = torch.autograd.grad(value_t, [ell_t, out_t, v_t])
    assert abs(value_t.item() - float(value_j)) <= 1e-5 * abs(float(value_j))
    for got, want in zip(grads_t, grads_j):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-4


def test_partitioned_policy_raises_when_num_does_not_divide():
    factory, _ = gp.kernel_scaled_rbf(shape_in=(2,), shape_out=())
    kernel = factory(raw_lengthscale=torch.zeros(2), raw_outputscale=torch.tensor(0.0))
    x = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="does not divide"):
        gp.gram_matvec_partitioned(3, checkpoint=False)(kernel)(x, x, torch.ones(10))


# ---------------------------------------------------------------------------
# The driver: evaluation closures against _common.py, the epoch loop
# ---------------------------------------------------------------------------

N_TRAIN, N_EVAL, DEPTH, PROBES = 256, 64, 8, 4
DRIVER_ARGS = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "48",
               "--num_partitions", "1", "--num_matvecs", str(DEPTH), "--num_samples", str(PROBES),
               "--num_epochs", "0", "--matvec", "auto", "--slq", "blocked", "--precon_block", "16",
               "--cg_tol", "1.0", "--cg_maxiter", "25"]


def _load_common():
    spec = importlib.util.spec_from_file_location("_common_gp_driver", COMMON)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def driver_problem():
    X, y, Xq, _params = _data(N_TRAIN, 8, n_query=N_EVAL, seed=5)
    rng = np.random.default_rng(5)
    params = np.concatenate([[0.05], rng.uniform(0.5, 1.5, 8), [0.3], [-1.0]]).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(PROBES, N_EVAL)).astype(np.float32)
    yq = np.sin(Xq[:, 0]).astype(np.float32)
    return X.astype(np.float32), y.astype(np.float32), Xq.astype(np.float32), yq, params, probes


def _torch_driver_stack(probes, **kw):
    return train_gp.assemble(
        n_train=N_TRAIN, ndim=8, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=48,
        precon_block=16, matvec=train_gp.gram_policy("auto", 1, device="cpu"), device="cpu",
        eval_sample=lambda _key: torch.tensor(probes), **kw,
    )


def test_predict_mean_and_mll_eval_match_the_jax_driver(driver_problem, monkeypatch):
    X, y, Xq, yq, params, probes = driver_problem
    common = _load_common()
    args = common.build_argparser(argparse.ArgumentParser()).parse_args(DRIVER_ARGS)
    # The JAX driver draws mll_eval's probes from its key; hand it the fixed ones.
    monkeypatch.setattr(common, "trace", SimpleNamespace(
        sampler_rademacher=lambda _like, num: (lambda _key: jnp.asarray(probes[:num]))))
    stack_j = common.assemble(args, n_train=N_TRAIN, ndim=8, solver_mode="adaptive")
    mean_j, info_j = stack_j.predict_mean(jnp.asarray(params), jnp.asarray(Xq), jnp.asarray(X), jnp.asarray(y))
    nll_j, _ = stack_j.mll_eval(jnp.asarray(params), jax.random.PRNGKey(0), jnp.asarray(Xq), jnp.asarray(yq))

    stack_t = _torch_driver_stack(probes)
    t = torch.tensor
    mean_t, info_t = stack_t.predict_mean(t(params), t(Xq), t(X), t(y))
    nll_t, eval_info = stack_t.mll_eval(t(params), None, t(Xq), t(yq))
    assert not mean_t.requires_grad and not nll_t.requires_grad
    assert _rel(mean_t.numpy(), np.asarray(mean_j)) <= 1e-4
    assert abs(nll_t.item() - float(nll_j)) <= 1e-4 * abs(float(nll_j))
    assert float(info_t["solve"]["num_steps"]) >= 10  # miniter
    assert float(eval_info["logpdf"]["solve"]["num_steps"]) >= 10
    assert np.sqrt(np.mean(np.asarray(info_j["solve"]["residual_abs"]) ** 2)) <= 1e-2


@pytest.mark.parametrize("train_log", ["clipped", "plain"])
def test_training_loss_and_gradient_match_the_jax_driver(driver_problem, monkeypatch, train_log):
    X, y, _Xq, _yq, params, _probes = driver_problem
    probes = np.random.default_rng(6).choice([-1.0, 1.0], size=(PROBES, N_TRAIN)).astype(np.float32)
    common = _load_common()
    args = common.build_argparser(argparse.ArgumentParser()).parse_args(
        [*DRIVER_ARGS, "--train_log", train_log])
    monkeypatch.setattr(common, "trace", SimpleNamespace(
        sampler_rademacher=lambda _like, num: (lambda _key: jnp.asarray(probes[:num]))))
    stack_j = common.assemble(args, n_train=N_TRAIN, ndim=8, solver_mode="adaptive")
    (loss_j, _info), grad_j = jax.value_and_grad(stack_j.mll_lanczos, has_aux=True)(
        jnp.asarray(params), jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y))

    stack_t = _torch_driver_stack(None, sample=lambda _key: torch.tensor(probes), train_log=train_log)
    params_t = torch.tensor(params, requires_grad=True)
    loss_t, _ = stack_t.mll_lanczos(params_t, None, torch.tensor(X), torch.tensor(y))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert _rel(params_t.grad.numpy(), np.asarray(grad_j)) <= 1e-3


def test_auto_matvec_is_refused_on_a_cuda_device(tmp_path):
    for num_partitions, device in ((1, "cuda"), (2, "cuda:0")):
        with pytest.raises(ValueError, match="CPU only"):
            train_gp.gram_policy("auto", num_partitions, device=device)
    # run() refuses before it loads the data or touches the device.
    with pytest.raises(ValueError, match="CPU only"):
        train_gp.run(_run_args(tmp_path, epochs=0, device="cuda"), solver_mode="adaptive")
    required = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "48",
                "--num_partitions", "1", "--num_matvecs", "8", "--num_samples", "4", "--num_epochs", "0",
                "--out", str(tmp_path)]
    parsed = train_gp.build_argparser(argparse.ArgumentParser()).parse_args(required)
    assert parsed.matvec == "fused" and parsed.device == "cuda"


def _run_args(out, *, epochs, **kw):
    argv = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "16",
            "--num_partitions", "2", "--num_matvecs", "6", "--num_samples", "2",
            "--num_epochs", str(epochs), "--num_data", "800", "--matvec", "auto", "--slq", "blocked",
            "--precon_block", "16", "--cg_tol", "1.0", "--cg_maxiter", "25", "--device", "cpu",
            "--out", str(out)]
    for flag, value in kw.items():
        argv += [f"--{flag}"] if value is True else [f"--{flag}", str(value)]
    return train_gp.build_argparser(argparse.ArgumentParser()).parse_args(argv)


@pytest.fixture(scope="module")
def two_epoch_runs(tmp_path_factory):
    pin_float32()
    runs = {}
    for mode in ("adaptive", "fixed"):
        out = tmp_path_factory.mktemp(mode)
        runs[mode] = (out, train_gp.run(_run_args(out, epochs=2), solver_mode=mode))
    return runs


@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_run_writes_the_eleven_series(two_epoch_runs, mode):
    out, result = two_epoch_runs[mode]
    files = sorted(p.name for p in out.glob("*.npy"))
    assert files == sorted(f"t_synthetic_gp500k_s1_{name}.npy" for name in train_gp.RESULTS)
    load = lambda name: np.load(out / f"t_synthetic_gp500k_s1_{name}.npy")  # noqa: E731
    for name in train_gp.SERIES:
        assert load(name).shape == (2,), name
    assert load("test_rmses").shape == () and load("test_nlls").shape == ()
    assert np.isfinite(load("loss_curve")).all() and load("params_opt").shape == (11,)
    assert float(load("test_rmses")) == result.test_rmse and np.isfinite(result.test_nll)
    steps = load("cg_numsteps_all")
    # Fixed-step CG reports no step count; the driver records num_matvecs.
    assert (steps == 6).all() if mode == "fixed" else (steps >= 10).all()
    assert (load("notfinite_curve") == 0).all()


def test_run_resumed_from_its_checkpoint_repeats_the_uninterrupted_run(two_epoch_runs, tmp_path):
    _out, whole = two_epoch_runs["fixed"]
    train_gp.run(_run_args(tmp_path, epochs=1, checkpoint_every=1), solver_mode="fixed")
    assert checkpoint.latest_step(tmp_path / "checkpoints_t_synthetic_gp500k_s1") == 0
    resumed = train_gp.run(_run_args(tmp_path, epochs=2, resume=True), solver_mode="fixed")
    for name in train_gp.SERIES:
        if name != "loss_timestamps":
            assert resumed.series[name] == whole.series[name], name
    assert len(resumed.series["loss_timestamps"]) == 2
    assert torch.equal(resumed.params, whole.params)
    assert resumed.test_rmse == whole.test_rmse and resumed.test_nll == whole.test_nll


def test_load_data_names_the_missing_uci_files():
    with pytest.raises(ValueError, match="A11"):
        train_gp.load_data("elevators")


def test_checkpoint_round_trip_and_missing_directory(tmp_path):
    assert checkpoint.restore(tmp_path / "none", {}) == (None, -1)
    state = {"params": torch.arange(3.0), "count": 2, "series": {"loss": [1.0, 0.5]}}
    checkpoint.save(tmp_path, 4, state)
    checkpoint.save(tmp_path, 7, {**state, "count": 3})
    restored, step = checkpoint.restore(tmp_path, state)
    assert step == 7 == checkpoint.latest_step(tmp_path)
    assert restored["count"] == 3 and restored["series"] == state["series"]
    assert torch.equal(restored["params"], state["params"])
    with pytest.raises(ValueError, match="holds"):
        checkpoint.restore(tmp_path, {"params": state["params"]})


def test_adj400k_init_is_the_jax_drivers_draw():
    key = jax.random.PRNGKey(1)
    key, _subkey = jax.random.split(key)
    key, subkey = jax.random.split(key)
    _m, p_mean = jgp.mean_constant(shape_out=())
    _k, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())
    _l, p_lik = jgp.likelihood_pdf_p(None, None, None, constrain=None)
    flat, _ = ravel_pytree(jexp_util.tree_random_like(subkey, (p_mean, p_kernel, p_lik)))
    np.testing.assert_allclose(np.asarray(train_gp.ADJ400K_INIT), np.asarray(flat), rtol=0, atol=1e-7)
