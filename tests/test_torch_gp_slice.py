"""The PyTorch port's GP training step against the JAX package's, end to end.

Same numpy data, parameters and probes on both sides. The JAX side
assembles its stack as the GP training driver does
(``experiments/applications/gaussian_process/train/_common.py``), with
its plain dense Gram policy standing in for the Pallas kernel (which
``tests/test_torch_gram.py`` holds the port's kernels to); the port runs
its own ``train.gp.assemble`` with the fused policy, whose wrappers take
the plain versions of the CUDA kernels on the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.trace.slq import log_clipped as jlog_clipped  # noqa: E402
from lanczos_adjoints_tpu.utils import uci as juci  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import data, uci  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, D, DEPTH, PROBES, RANK, BLOCK = 512, 8, 10, 4, 64, 16
CG = {"atol": 1e-4, "rtol": 0.0, "maxiter": 400, "miniter": 10}


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _problem(seed=0):
    X, y = uci.uci_synthetic_gp500k()
    (X, y), _ = data.split_train_test_shuffle(seed, X[:640], y[:640], train_fraction=0.8)
    rng = np.random.default_rng(seed)
    params = np.concatenate(
        [[0.05], rng.uniform(0.5, 1.5, D), [0.3], [-1.0]]
    ).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(PROBES, N)).astype(np.float32)
    return X, y, params, probes


def _jax_value_and_grad(X, y, params, probes):
    solve_p = jsolvers.pcg_adaptive(**CG)
    logdet = jgp.krylov_logdet_slq(
        DEPTH, sample=lambda _key: jnp.asarray(probes), num_batches=1,
        checkpoint=True, matfun=jlog_clipped(), blocked=True,
    )
    precondition = jprecond.preconditioner(
        jprecond.cholesky_partial_pivot_blocked(rank=RANK, block=BLOCK)
    )
    likelihood, p_lik = jgp.likelihood_pdf_p(
        jgp.gram_matvec(), jgp.logpdf_krylov_p(solve_p, logdet), precondition,
        constrain=jgp.constraint_greater_than(1e-4),
    )
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    loss = jgp.target_logml(jgp.model_gp(mean, kernel), likelihood)
    _flat, unflatten = ravel_pytree((p_mean, p_kernel, p_lik))

    def mll(p):
        p1, p2, p3 = unflatten(p)
        val, info = loss(
            jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(0),
            params_mean=p1, params_kernel=p2, params_likelihood=p3,
        )
        return -val / N, info["logpdf"]["solve"]["num_steps"]

    (value, steps), grad = jax.jit(jax.value_and_grad(mll, has_aux=True))(jnp.asarray(params))
    return float(value), np.asarray(grad), float(steps)


def _torch_stack(probes, **kw):
    return train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=RANK,
        precon_block=BLOCK, cg_tol=CG["atol"], cg_maxiter=CG["maxiter"],
        cg_miniter=CG["miniter"], sample=lambda _key: torch.tensor(probes),
        device="cpu", **kw,
    )


def test_training_loss_and_gradient_match_jax():
    X, y, params, probes = _problem()
    value_j, grad_j, steps_j = _jax_value_and_grad(X, y, params, probes)

    stack = _torch_stack(probes)
    p = torch.tensor(params, requires_grad=True)
    value_t, info = stack.mll_lanczos(p, None, torch.tensor(X), torch.tensor(y))
    (grad_t,) = torch.autograd.grad(value_t, [p])

    assert abs(value_t.item() - value_j) <= 1e-4 * abs(value_j)
    scale = np.max(np.abs(grad_j))
    assert np.max(np.abs(grad_t.numpy() - grad_j)) <= 1e-3 * scale, (grad_t, grad_j)
    # Both PCG runs need about the same number of steps (float32 round-off
    # may move the stopping test by a step).
    assert abs(float(info["logpdf"]["solve"]["num_steps"]) - steps_j) <= 2
    assert bool(info["precondition"]["success"])


def test_krylov_loss_close_to_cholesky_oracle():
    X, y, params, _probes = _problem(seed=1)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    p1, p2, p3 = gp.unflatten_params(torch.tensor(params), D)
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = gp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    prior = gp.model_gp(mean, kernel)
    constrain = gp.constraint_greater_than(train_gp.NOISE_MINVAL)

    def no_precondition(_elem, _n):
        return (lambda v, _s: v), {}

    likelihood, _ = gp.likelihood_pdf_p(
        gp.gram_matvec(), gp.logpdf_cholesky(), no_precondition, constrain=constrain
    )
    exact, _ = gp.target_logml(prior, likelihood)(
        Xt, yt, params_mean=p1, params_kernel=p2, params_likelihood=p3
    )
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=20, num_samples=16, rank_precon=RANK,
        precon_block=BLOCK, cg_tol=1e-4, cg_maxiter=100, cg_miniter=2, device="cpu",
    )
    value, _info = stack.mll_lanczos(torch.tensor(params), torch.Generator().manual_seed(0), Xt, yt)
    assert abs(value.item() - (-exact.item() / N)) <= 0.01 * abs(exact.item() / N)


def test_three_adam_steps_are_finite_and_a_non_finite_one_is_skipped():
    X, y, params, _probes = _problem(seed=2)
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=RANK,
        precon_block=BLOCK, device="cpu",
    )
    opt = train_gp.AdamIfFinite(torch.tensor(params, requires_grad=True), lr=0.05)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(3):
        value, info, grad, applied = train_gp.train_step(
            stack, opt, gen, torch.tensor(X), torch.tensor(y)
        )
        assert applied and bool(torch.isfinite(grad).all())
        assert float(info["logpdf"]["solve"]["num_steps"]) >= 10  # miniter
        losses.append(value.item())
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]

    # A target poisoned with NaN gives a non-finite gradient: skipped.
    before = opt.params.detach().clone()
    y_bad = torch.tensor(y)
    y_bad[0] = float("nan")
    _value, _info, grad, applied = train_gp.train_step(stack, opt, gen, torch.tensor(X), y_bad)
    assert not applied and not bool(torch.isfinite(grad).all())
    assert torch.equal(opt.params.detach(), before) and opt.total_notfinite == 1


def test_non_finite_steps_are_skipped_like_apply_if_finite():
    p = torch.zeros(3, requires_grad=True)
    opt = train_gp.AdamIfFinite(p, lr=0.1, max_consecutive_errors=2)
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert not opt.step()
    assert bool((p == 0).all()) and opt.total_notfinite == 1
    p.grad = torch.tensor([1.0, 1.0, 1.0])
    assert opt.step()
    assert bool((p < 0).all()) and opt.notfinite_count == 0
    before = p.detach().clone()
    for expected in (False, False, True):  # the third in a row goes through
        p.grad = torch.tensor([float("inf"), 0.0, 0.0])
        assert opt.step() == expected
    assert opt.total_notfinite == 4
    assert not torch.equal(p.detach(), before)


def test_params_from_jax_round_trip_and_flat_order():
    X, _y, params, _probes = _problem()
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    _lik, p_lik = jgp.likelihood_pdf_p(None, None, None, constrain=None)
    flat_j, unflatten_j = ravel_pytree((p_mean, p_kernel, p_lik))
    trees_j = jax.tree_util.tree_map(np.asarray, unflatten_j(jnp.asarray(params)))

    trees_t = gp.params_from_jax(*trees_j, device="cpu")
    flat_t = gp.flatten_params(*trees_t)
    np.testing.assert_array_equal(flat_t.numpy(), params)
    assert flat_t.shape == flat_j.shape
    for tree_t, tree_j in zip(gp.unflatten_params(flat_t, D), trees_j):
        assert sorted(tree_t) == sorted(tree_j)
        for k in tree_t:
            np.testing.assert_array_equal(tree_t[k].numpy(), tree_j[k])
    assert gp.unflatten_params(flat_t, D)[1]["raw_lengthscale"].shape == (D,)


def test_synthetic_dataset_is_bitwise_the_jax_packages():
    X_t, y_t = uci.uci_synthetic_gp500k()
    X_j, y_j = juci.uci_synthetic_gp500k()
    assert X_t.dtype == X_j.dtype and y_t.dtype == y_j.dtype
    np.testing.assert_array_equal(X_t, X_j)
    np.testing.assert_array_equal(y_t, y_j)
    (tr, _te) = data.split_train_test_shuffle(1, X_t, y_t, train_fraction=0.8)
    assert tr[0].shape == (400_000, D)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "lanczos_adjoints_tpu_torch").rglob("*.py"))
    studies = {p.stem for p in files if p.parent.name == "studies"}
    assert {"loss_of_orthogonality", "wall_times_vjp", "vjp_through_matvec", "value_and_grad_of_mll",
            "gram_matvec"} <= studies, studies
    assert REPO / "lanczos_adjoints_tpu_torch/train/gp_report.py" in files
    files.append(REPO / "chip_smoke.py")
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 10 and len(scripts) >= 2
    files += scripts
    banned = ("jax", "jaxlib", "optax", "lanczos_adjoints_tpu")
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in banned, f"{path.relative_to(REPO)} imports {name}"


def test_cholesky_logpdf_value_and_gradient_match_jax():
    X, y, params, _probes = _problem(seed=3)
    X, y = X[:128], y[:128]

    def jax_loss(p):
        mean, p_mean = jgp.mean_constant(shape_out=())
        kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
        likelihood, p_lik = jgp.likelihood_pdf(
            jgp.gram_matvec(), jgp.logpdf_cholesky(),
            constrain=jgp.constraint_greater_than(1e-4),
        )
        p1, p2, p3 = ravel_pytree((p_mean, p_kernel, p_lik))[1](p)
        val, _ = jgp.target_logml(jgp.model_gp(mean, kernel), likelihood)(
            jnp.asarray(X), jnp.asarray(y), params_mean=p1, params_kernel=p2,
            params_likelihood=p3,
        )
        return val

    value_j, grad_j = (np.asarray(r) for r in jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(params)))

    p = torch.tensor(params, requires_grad=True)
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = gp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    likelihood, _ = gp.likelihood_pdf_p(
        gp.gram_matvec(), gp.logpdf_cholesky(), lambda _e, _n: ((lambda v, _s: v), {}),
        constrain=gp.constraint_greater_than(1e-4),
    )
    p1, p2, p3 = gp.unflatten_params(p, D)
    value_t, _ = gp.target_logml(gp.model_gp(mean, kernel), likelihood)(
        torch.tensor(X), torch.tensor(y), params_mean=p1, params_kernel=p2, params_likelihood=p3
    )
    (grad_t,) = torch.autograd.grad(value_t, [p])
    assert abs(value_t.item() - float(value_j)) <= 1e-5 * abs(float(value_j))
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-3, atol=1e-3 * np.max(np.abs(grad_j)))
