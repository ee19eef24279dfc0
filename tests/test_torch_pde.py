"""The port's PDE toolkit (``models.pde``) and the wave-PDE training step
(``train.pde``) against the JAX package, piece by piece, on the same numpy
inputs; the training loss and gradient at 32 x 32 on the bundled 8 pairs
against the JAX training script's ``loss_fn`` (rebuilt here from its lines, with
the same flax weights carried over by ``params_from_jax``).

Float32 pieces agree to float32 rounding; the Arnoldi exponential is
compared in float64, where ``torch.linalg.matrix_exp`` and JAX's Pade-13
``expm`` agree to rounding; the training gradient to 1e-3 relative.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.models import pde as jpde  # noqa: E402
from lanczos_adjoints_tpu_torch.models import pde  # noqa: E402
from lanczos_adjoints_tpu_torch.train import pde as train_pde  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _rel(a, b):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_mesh_and_stencils_equal_the_jax_packages():
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    y = np.linspace(0.0, 2.0, 5, dtype=np.float32)
    np.testing.assert_array_equal(_np(pde.mesh_tensorproduct(torch.tensor(x), torch.tensor(y))),
                                  np.asarray(jpde.mesh_tensorproduct(jnp.asarray(x), jnp.asarray(y))))
    for name in ("stencil_laplacian", "stencil_laplacian_reference", "stencil_advection_diffusion"):
        np.testing.assert_allclose(_np(getattr(pde, name)(0.1)), np.asarray(getattr(jpde, name)(0.1)),
                                   rtol=1e-6)


@pytest.mark.parametrize("stencil", ["stencil_laplacian", "stencil_advection_diffusion"])
def test_conv_matches_the_jax_conv(stencil):
    s = getattr(pde, stencil)(0.5)
    x = _field((10, 12), 0)
    want = np.asarray(jpde._conv2d_valid(getattr(jpde, stencil)(0.5), jnp.asarray(x)))
    got = pde._conv2d_valid(s, torch.tensor(x))
    assert got.shape == (8, 10)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_boundaries_equal_the_jax_packages():
    x = _field((4, 5), 1)
    for name in ("boundary_dirichlet", "boundary_neumann"):
        np.testing.assert_array_equal(_np(getattr(pde, name)()(torch.tensor(x))),
                                      np.asarray(getattr(jpde, name)()(jnp.asarray(x))))


def test_initial_conditions_match_the_jax_packages():
    xs = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    mesh_t = pde.mesh_tensorproduct(torch.tensor(xs), torch.tensor(xs))
    mesh_j = jpde.mesh_tensorproduct(jnp.asarray(xs), jnp.asarray(xs))
    logits = np.array([0.3, -0.2], np.float32)
    bell_t, like_t = pde.pde_init_bell(4.0)
    bell_j, like_j = jpde.pde_init_bell(4.0)
    assert like_t["center_logits"].shape == like_j["center_logits"].shape
    np.testing.assert_allclose(_np(bell_t(center_logits=torch.tensor(logits))(mesh_t)),
                               np.asarray(bell_j(center_logits=jnp.asarray(logits))(mesh_j)), rtol=1e-5)
    sine_t, kw_t = pde.pde_init_sine()
    sine_j, kw_j = jpde.pde_init_sine()
    assert kw_t == kw_j
    np.testing.assert_allclose(_np(sine_t(**kw_t)(mesh_t)), np.asarray(sine_j(**kw_j)(mesh_j)),
                               rtol=1e-5, atol=1e-6)


def test_right_hand_sides_match_the_jax_packages():
    n = 12
    stencil_t, stencil_j = pde.stencil_laplacian(0.2), jpde.stencil_laplacian(0.2)
    u, drift, scale = _field((n, n), 2), _field((n, n), 3), _field((n, n), 4)
    state = _field((2, n, n), 5)
    bt, bj = pde.boundary_dirichlet(), jpde.boundary_dirichlet()
    cases = [
        (pde.pde_heat(0.7, stencil_t, boundary=bt)[0](), jpde.pde_heat(0.7, stencil_j, boundary=bj)[0](), u),
        (pde.pde_heat_affine(0.7, torch.tensor(drift), stencil_t, boundary=bt)[0](drift=torch.tensor(drift)),
         jpde.pde_heat_affine(0.7, jnp.asarray(drift), stencil_j, boundary=bj)[0](drift=jnp.asarray(drift)), u),
        (pde.pde_heat_anisotropic(torch.tensor(scale), stencil_t, constrain=torch.square, boundary=bt)[0](
            scale=torch.tensor(scale)),
         jpde.pde_heat_anisotropic(jnp.asarray(scale), stencil_j, constrain=jnp.square, boundary=bj)[0](
            scale=jnp.asarray(scale)), state),
        (pde.pde_wave_anisotropic(torch.tensor(scale), stencil_t, constrain=torch.square, boundary=bt)[0](
            scale=torch.tensor(scale)),
         jpde.pde_wave_anisotropic(jnp.asarray(scale), stencil_j, constrain=jnp.square, boundary=bj)[0](
            scale=jnp.asarray(scale)), state),
    ]
    for rhs_t, rhs_j, x in cases:
        want = np.asarray(rhs_j(jnp.asarray(x)))
        np.testing.assert_allclose(_np(rhs_t(torch.tensor(x))), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        cases[-1][0](torch.tensor(u))


def test_losses_match_the_jax_packages():
    sol, targets = _field((6, 6), 6), _field((6, 6), 7)
    np.testing.assert_allclose(_np(pde.loss_mse()(torch.tensor(sol), targets=torch.tensor(targets))),
                               float(jpde.loss_mse()(jnp.asarray(sol), targets=jnp.asarray(targets))), rtol=1e-6)
    np.testing.assert_allclose(
        _np(pde.loss_mse_relative(nugget=1e-4)(torch.tensor(sol), targets=torch.tensor(targets))),
        float(jpde.loss_mse_relative(nugget=1e-4)(jnp.asarray(sol), targets=jnp.asarray(targets))), rtol=1e-6)


def test_euler_solver_matches_the_jax_package():
    ts = np.linspace(0.0, 1.0, 200, dtype=np.float32)
    y_t, info_t = pde.solver_euler(torch.tensor(ts), lambda y, rate: rate * y)(torch.ones(3), -1.0)
    y_j, info_j = jpde.solver_euler(jnp.asarray(ts), lambda y, rate: rate * y)(jnp.ones(3), -1.0)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=1e-5)
    assert info_t == {"num_matvecs": 199} == info_j
    np.testing.assert_allclose(_np(y_t), np.exp(-1.0), atol=1e-2)


def _dense_problem(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) / np.sqrt(n), rng.standard_normal(n)


@pytest.mark.parametrize("custom_vjp", [True, False])
def test_expm_arnoldi_value_and_gradient_match_jax_in_float64(custom_vjp):
    A, y0 = _dense_problem(16, 8)

    def loss_j(a):
        solve = jpde.solver_expm(0.0, 1.0, lambda y, p: p @ y, jpde.expm_arnoldi(8, custom_vjp=custom_vjp))
        y1, _ = solve(jnp.asarray(y0), a)
        return jnp.sum(y1**2)

    with jax.enable_x64(True):
        value_j, grad_j = (np.asarray(r) for r in jax.value_and_grad(loss_j)(jnp.asarray(A)))
    at = torch.tensor(A, requires_grad=True)
    solve = pde.solver_expm(0.0, 1.0, lambda y, p: p @ y, pde.expm_arnoldi(8, custom_vjp=custom_vjp))
    y1, info = solve(torch.tensor(y0), at)
    value_t = torch.sum(y1**2)
    (grad_t,) = torch.autograd.grad(value_t, [at])
    assert info == {"num_matvecs": 8}
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-10)
    assert _rel(grad_t, grad_j) < 1e-9


def test_expm_arnoldi_matches_the_dense_exponential():
    """The JAX package's test: full-depth Arnoldi equals the dense
    exponential, value and gradient (float32, 1e-3 and 1e-2)."""
    A, y0 = (a.astype(np.float32) for a in _dense_problem(16, 9))
    at = torch.tensor(A, requires_grad=True)
    y_k, _ = pde.solver_expm(0.0, 1.0, lambda y, p: p @ y, pde.expm_arnoldi(16))(torch.tensor(y0), at)
    (g_k,) = torch.autograd.grad(torch.sum(y_k**2), [at])
    ad = torch.tensor(A, requires_grad=True)
    y_d, _ = pde.solver_expm(0.0, 1.0, lambda y, p: p @ y, pde.expm_pade())(torch.tensor(y0), ad)
    (g_d,) = torch.autograd.grad(torch.sum(y_d**2), [ad])
    np.testing.assert_allclose(_np(y_k), _np(y_d), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(g_k), _np(g_d), atol=1e-2, rtol=1e-2)
    want = np.asarray(jpde.solver_expm(0.0, 1.0, lambda y, p: p @ y, jpde.expm_pade())(
        jnp.asarray(y0), jnp.asarray(A))[0])
    np.testing.assert_allclose(_np(y_d), want, atol=1e-4, rtol=1e-4)


def test_mlp_with_flax_weights_matches_flax():
    xs = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    mesh_j = jpde.mesh_tensorproduct(jnp.asarray(xs), jnp.asarray(xs))
    init, apply = jpde.model_mlp(mesh_j, (16, 16, 1), activation=jnp.tanh, output_scale_raw=-1.0)
    params, unflatten = init(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, unflatten(params))
    want = np.asarray(apply(unflatten(params), mesh_j))
    mesh_t = pde.mesh_tensorproduct(torch.tensor(xs), torch.tensor(xs))
    model = pde.params_from_jax(
        pde.model_mlp(mesh_t, (16, 16, 1), torch.tanh, output_scale_raw=-1.0), variables)
    got = model(mesh_t)
    assert got.shape == (8, 8)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_mlp_initialisation_is_flax_lecun_normal():
    mesh = torch.zeros((2, 4, 4))
    a = pde.model_mlp(mesh, (500, 1), torch.tanh, output_scale_raw=0.0, seed=3)
    b = pde.model_mlp(mesh, (500, 1), torch.tanh, output_scale_raw=0.0, seed=3)
    w = a.layers[1].weight.detach()
    assert torch.equal(w, b.layers[1].weight) and float(a.layers[0].bias.abs().max()) == 0.0
    assert abs(float(w.std()) - np.sqrt(1 / 500)) < 0.1 * np.sqrt(1 / 500)
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 500) / 0.87962566103423978 + 1e-6
    with pytest.raises(ValueError):
        pde.model_mlp(mesh, (5, 2), torch.tanh, output_scale_raw=0.0)


def test_grf_sampler_matches_the_jax_package(monkeypatch):
    n, num = 24, 6
    idx = np.arange(n)
    cov = np.exp(-0.1 * (idx[:, None] - idx[None, :]) ** 2) + 0.01 * np.eye(n)
    eps = _field((num, n), 10)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(eps))
    want = np.asarray(jpde.sampler_lanczos(mean=jnp.zeros(n), cov_matvec=lambda v: jnp.asarray(cov, jnp.float32) @ v,
                                           num=num, lanczos_rank=10)(jax.random.PRNGKey(0)))
    monkeypatch.setattr(pde, "_standard_normal", lambda key, shape, like: torch.tensor(eps))
    cov_t = torch.tensor(cov, dtype=torch.float32)
    got = pde.sampler_lanczos(mean=torch.zeros(n), cov_matvec=lambda v: cov_t @ v, num=num, lanczos_rank=10)(None)
    assert got.shape == (num, n)
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4)


def test_grf_sampler_reproduces_the_covariance():
    """The JAX package's statistical test, with the port's generator."""
    n = 32
    idx = torch.arange(n, dtype=torch.float32)
    cov = torch.exp(-0.1 * (idx[:, None] - idx[None, :]) ** 2) + 0.01 * torch.eye(n)
    sample = pde.sampler_lanczos(mean=torch.zeros(n), cov_matvec=lambda v: cov @ v, num=500, lanczos_rank=20)
    draws = sample(torch.Generator().manual_seed(0))
    emp = draws.T @ draws / 500
    assert float(torch.linalg.norm(emp - cov) / torch.linalg.norm(cov)) < 0.35


def _jax_training_problem(resolution, method, num_matvecs=10):
    """The JAX training script's ``loss_fn`` (train.py:59-98), with its flax weights."""
    inputs, targets = (jnp.asarray(a) for a in train_pde.load_data(resolution, device="cpu"))
    n = resolution
    xs_1d = jnp.linspace(0.0, 1.0, n)
    mesh = jpde.mesh_tensorproduct(xs_1d, xs_1d)
    stencil = jpde.stencil_laplacian(float(xs_1d[1] - xs_1d[0]))
    parametrize, _ = jpde.pde_wave_anisotropic(
        mesh[0], stencil, constrain=lambda s: s**2, boundary=jpde.boundary_dirichlet())
    if method == "arnoldi":
        solve = jpde.solver_expm(0.0, 1.0, lambda y, scale: parametrize(scale=scale)(y),
                                 jpde.expm_arnoldi(num_matvecs))
    else:
        ts = jnp.linspace(0.0, 1.0, num_matvecs + 1)
        solve = jpde.solver_euler(ts, lambda y, scale: parametrize(scale=scale)(y))
    init, apply = jpde.model_mlp(mesh, (500, 500, 1), activation=jnp.tanh, output_scale_raw=-5.0)
    params, unflatten = init(jax.random.PRNGKey(1))
    loss_mse = jpde.loss_mse_relative(nugget=1e-4)

    def loss_fn(params_flat):
        scale = apply(unflatten(params_flat), mesh)

        def run_one(y0, y1):
            sol, _info = solve(y0, scale)
            return loss_mse(sol, targets=y1)

        return jnp.mean(jax.vmap(run_one)(inputs, targets))

    return loss_fn, params, unflatten


def _flat_grads(model):
    return np.concatenate([np.concatenate([layer.weight.grad.numpy().T.ravel(), layer.bias.grad.numpy()])
                           for layer in model.layers])


def _jax_flat(tree):
    dense = tree["params"]
    return np.concatenate([np.concatenate([np.asarray(dense[f"Dense_{i}"]["kernel"]).ravel(),
                                           np.asarray(dense[f"Dense_{i}"]["bias"])]) for i in range(len(dense))])


@pytest.mark.parametrize("method", ["arnoldi", "euler"])
def test_training_loss_and_gradient_match_the_jax_training_script(method):
    loss_j, params, unflatten = _jax_training_problem(32, method)
    value_j, grad_j = (np.asarray(r) for r in jax.jit(jax.value_and_grad(loss_j))(params))
    variables = jax.tree_util.tree_map(np.asarray, unflatten(params))

    stack = train_pde.assemble(32, method=method, device="cpu")
    pde.params_from_jax(stack.model, variables)
    value_t, info = train_pde.loss_fn(stack)
    value_t.backward()
    assert stack.inputs.shape == (8, 2, 32, 32)
    assert info == {"num_matvecs": 10}
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-4)
    assert _rel(_flat_grads(stack.model), _jax_flat(unflatten(grad_j))) < 1e-3


def test_train_step_is_one_adam_step_like_optax():
    optax = pytest.importorskip("optax")
    loss_j, params, unflatten = _jax_training_problem(32, "arnoldi")
    grad_j = jax.grad(loss_j)(params)
    optimizer = optax.adam(1e-2)
    updates, _state = optimizer.update(grad_j, optimizer.init(params))
    want = _jax_flat(jax.tree_util.tree_map(np.asarray, unflatten(optax.apply_updates(params, updates))))

    stack = train_pde.assemble(32, device="cpu")
    pde.params_from_jax(stack.model, jax.tree_util.tree_map(np.asarray, unflatten(params)))
    value, _info = train_pde.train_step(stack)
    got = np.concatenate([np.concatenate([layer.weight.detach().numpy().T.ravel(), layer.bias.detach().numpy()])
                          for layer in stack.model.layers])
    assert np.isfinite(value.item())
    np.testing.assert_allclose(got, want, atol=2e-5)
    with pytest.raises(ValueError, match="method"):
        train_pde.assemble(32, method="rk4", device="cpu")
