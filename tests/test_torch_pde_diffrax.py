"""``models.pde.solver_diffrax`` (the tableaux and adjoints of
``models/_runge_kutta.py``) against the JAX package, on the CPU.

The JAX ``solver_diffrax`` needs diffrax, which is not installed, so the
port is held to what the JAX package computes without it, in float64
(scoped ``jax.enable_x64``): its ``solver_euler`` (within 1e-12) and its
dense reference ``solver_expm(..., expm_pade())`` with ``jax.grad``, on the
wave problem at 16 x 16 (a 512-dimensional state), where each method must
converge at its order; and a nonlinear ODE with a closed form,
``y' = p sin(y)``, where the order conditions that a linear problem cannot
see take part. The tableaux are checked against every rooted-tree order
condition and Dopri5's against scipy's ``RK45``.

The observed order between two step counts is ``log(e1 / e2) / log(n2 / n1)``.
Over step counts whose errors lie between about 1e-2 and 1e-13 each
refinement converges at least at the method's order less ``ORDER_TOL``,
and the last, the most asymptotic, within ``ORDER_TOL`` of it. On a
linear problem Dopri8's error is the sum of its stability polynomial's
``z^9`` and ``z^10`` misfits, 3.6e-9 and 3.3e-8: where its error lies
above float64 rounding both show, so there its last order is held
between 8 and 9 (within ``ORDER_TOL``), and to 8 on the nonlinear
problem. The ``backsolve`` gradients on the nonlinear problem mix the
forward's and the backward reconstruction's errors and approach the
order more slowly: ``BACKSOLVE_ORDER_TOL``.
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy.integrate._ivp.rk import RK45  # noqa: E402

from lanczos_adjoints_tpu.models import pde as jpde  # noqa: E402
from lanczos_adjoints_tpu_torch.models import _runge_kutta as rk  # noqa: E402
from lanczos_adjoints_tpu_torch.models import pde  # noqa: E402

METHODS = ("euler", "heun", "dopri5", "tsit5", "dopri8")
ADJOINTS = ("direct", "recursive_checkpoint", "backsolve")
ORDERS = {"euler": 1, "heun": 2, "dopri5": 5, "tsit5": 5, "dopri8": 8}
STAGES = {"euler": 1, "heun": 2, "dopri5": 6, "tsit5": 6, "dopri8": 13}
ORDER_TOL = 0.3
BACKSOLVE_ORDER_TOL = 0.5
# The linear problem's slope bounds (module docstring).
LINEAR_ORDERS = {**{m: (p, p) for m, p in ORDERS.items()}, "dopri8": (8, 9)}
TOL_EULER = 1e-12
TOL_ROUTES = 1e-12
TOL_F32 = 1e-5
N_SIDE = 16

# The wave problem's speed (``scale``'s mean; the speed is its square) and
# step counts for each method, in the asymptotic range.
WAVE_STEPS = {
    "euler": (0.1, (256, 512, 1024, 2048)),
    "heun": (0.1, (16, 32, 64, 128)),
    "dopri5": (0.3, (32, 48, 64, 96)),
    "tsit5": (0.3, (96, 128, 192, 256)),
    "dopri8": (0.3, (12, 16, 24, 32)),
}
# ``y' = p sin(y)`` from eight starting values, with eight rates.
SINE_Y0 = np.linspace(0.1, 1.0, 8)
SINE_P = np.linspace(2.0, 3.0, 8)
SINE_STEPS = {
    "euler": (256, 512, 1024, 2048),
    "heun": (32, 64, 128, 256),
    "dopri5": (24, 32, 48, 64),
    "tsit5": (24, 32, 48, 64),
    "dopri8": (6, 8, 12, 16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _orders(steps, errors):
    """The observed order of each refinement."""
    return -np.diff(np.log(errors)) / np.diff(np.log(steps))


def _assert_order(label, steps, errors, bounds, tol=ORDER_TOL):
    """Every refinement at least ``bounds[0] - tol``; the last within ``bounds`` (+- ``tol``)."""
    orders = _orders(steps, errors)
    lo, hi = bounds
    assert orders.min() >= lo - tol and orders[-1] <= hi + tol, (label, orders, bounds, errors)


# ---------------------------------------------------------------------------
# The wave problem on both sides
# ---------------------------------------------------------------------------


def _wave_inputs(speed, seed=0):
    rng = np.random.default_rng(seed)
    scale = speed * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (N_SIDE, N_SIDE)))
    return scale, rng.standard_normal((2, N_SIDE, N_SIDE)), rng.standard_normal((2, N_SIDE, N_SIDE))


def _torch_wave():
    mesh, stencil = pde.mesh_and_stencil(N_SIDE, dtype=torch.float64, device="cpu")
    parametrize, _ = pde.pde_wave_anisotropic(mesh[0], stencil, constrain=torch.square,
                                              boundary=pde.boundary_dirichlet())
    return lambda y, s: parametrize(scale=s)(y)


def _jax_wave():
    xs = jnp.linspace(0.0, 1.0, N_SIDE)
    mesh = jpde.mesh_tensorproduct(xs, xs)
    stencil = jpde.stencil_laplacian(float(xs[1] - xs[0]))
    parametrize, _ = jpde.pde_wave_anisotropic(mesh[0], stencil, constrain=jnp.square,
                                               boundary=jpde.boundary_dirichlet())
    return lambda y, s: parametrize(scale=s)(y)


def _jax_value_and_grads(solve, scale, y0, w):
    """``y1`` and the gradients of ``sum(w * y1)`` in ``y0`` and ``scale``."""

    def loss(y, s):
        return jnp.sum(jnp.asarray(w) * solve(y, s)[0])

    y1 = solve(jnp.asarray(y0), jnp.asarray(scale))[0]
    g_y0, g_scale = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(scale))
    return np.asarray(y1), np.asarray(g_y0), np.asarray(g_scale)


@functools.cache
def _dense_reference(speed):
    scale, y0, w = _wave_inputs(speed)
    with jax.enable_x64(True):
        return _jax_value_and_grads(jpde.solver_expm(0.0, 1.0, _jax_wave(), jpde.expm_pade()), scale, y0, w)


def _port_value_and_grads(method, adjoint, num_steps, scale, y0, w, *, dtype=torch.float64):
    s = torch.tensor(scale, dtype=dtype, requires_grad=True)
    y = torch.tensor(y0, dtype=dtype, requires_grad=True)
    solve = pde.solver_diffrax(0.0, 1.0, _torch_wave(), num_steps=num_steps, method=method, adjoint=adjoint)
    y1, info = solve(y, s)
    g_y0, g_scale = torch.autograd.grad(torch.sum(torch.tensor(w, dtype=dtype) * y1), (y, s))
    return y1.detach(), g_y0, g_scale, info


# ---------------------------------------------------------------------------
# The tableaux
# ---------------------------------------------------------------------------


@functools.cache
def _trees(n):
    """The rooted trees of ``n`` nodes, each a sorted tuple of its subtrees."""
    if n == 1:
        return ((),)

    def forests(nodes, smallest):
        if nodes == 0:
            yield ()
            return
        for size in range(1, nodes + 1):
            for tree in _trees(size):
                if (size, tree) >= smallest:
                    for rest in forests(nodes - size, (size, tree)):
                        yield (tree, *rest)

    return tuple(sorted(set(forests(n - 1, (0, ())))))


def _density(tree):
    return (1 + sum(_size(t) for t in tree)) * math.prod(_density(t) for t in tree)


def _size(tree):
    return 1 + sum(_size(t) for t in tree)


def _order_condition_misfits(tableau, order):
    """``max |b . Phi(t) - 1 / gamma(t)|`` over the rooted trees of ``order`` nodes."""
    s = tableau.stages
    a = np.zeros((s, s))
    for i, row in enumerate(tableau.a):
        a[i, :len(row)] = row
    b = np.asarray(tableau.b)

    def weights(tree):
        out = np.ones(s)
        for child in tree:
            out = out * (a @ weights(child))
        return out

    return max(abs(b @ weights(t) - 1.0 / _density(t)) for t in _trees(order))


def test_rooted_trees_are_counted_right():
    assert [len(_trees(n)) for n in range(1, 10)] == [1, 1, 2, 4, 9, 20, 48, 115, 286]


def test_dopri5_is_scipys_rk45():
    tab = rk.TABLEAUX["dopri5"]
    a = np.zeros((6, 6))
    for i, row in enumerate(tab.a):
        a[i, :len(row)] = row
    np.testing.assert_allclose(a[:, :5], RK45.A, rtol=0, atol=1e-15)
    assert not a[:, 5].any()
    np.testing.assert_allclose(tab.b, RK45.B, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tab.c, RK45.C, rtol=0, atol=1e-15)


@pytest.mark.parametrize("method", METHODS)
def test_tableau_has_its_order_and_no_more(method):
    """Every order condition up to the method's order holds to rounding;
    one of the next order fails."""
    tab = rk.TABLEAUX[method]
    assert tab.order == ORDERS[method] and tab.stages == STAGES[method]
    assert all(len(row) == i for i, row in enumerate(tab.a))
    np.testing.assert_allclose([sum(row) for row in tab.a], tab.c, rtol=0, atol=1e-14)
    for order in range(1, tab.order + 1):
        assert _order_condition_misfits(tab, order) < 1e-13, order
    assert _order_condition_misfits(tab, tab.order + 1) > 1e-7


# ---------------------------------------------------------------------------
# Against the JAX package's solvers
# ---------------------------------------------------------------------------


@functools.cache
def _jax_euler(num_steps, seed):
    scale, y0, w = _wave_inputs(0.3, seed=seed)
    with jax.enable_x64(True):
        ts = jnp.linspace(0.0, 1.0, num_steps + 1)
        return _jax_value_and_grads(jpde.solver_euler(ts, _jax_wave()), scale, y0, w)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_euler_matches_the_jax_solver_euler(adjoint):
    """The value within 1e-12 for every adjoint; the discrete gradients of
    ``direct`` and ``recursive_checkpoint`` within 1e-12 of ``jax.grad``."""
    num_steps = 40
    scale, y0, w = _wave_inputs(0.3, seed=1)
    want = _jax_euler(num_steps, seed=1)
    y1, g_y0, g_scale, info = _port_value_and_grads("euler", adjoint, num_steps, scale, y0, w)
    assert info == {"num_matvecs": num_steps}
    assert _rel(y1, want[0]) < TOL_EULER
    if adjoint != "backsolve":
        assert _rel(g_y0, want[1]) < TOL_EULER
        assert _rel(g_scale, want[2]) < TOL_EULER


@pytest.mark.parametrize("adjoint", ["direct", "backsolve"])
@pytest.mark.parametrize("method", METHODS)
def test_orders_against_the_dense_exponential(method, adjoint):
    """The value and both gradients converge to the JAX dense reference's
    at the method's order; for ``backsolve`` the gradients are the
    continuous adjoint's, which converges at the same order."""
    speed, steps = WAVE_STEPS[method]
    scale, y0, w = _wave_inputs(speed)
    want = _dense_reference(speed)
    errors = np.array([[_rel(got, ref) for got, ref in zip(_port_value_and_grads(method, adjoint, n, scale, y0, w)[:3],
                                                            want)] for n in steps])
    assert errors.max() < 0.1 and errors.min() > 1e-13, errors
    for k, name in enumerate(("y1", "d/dy0", "d/dscale")):
        _assert_order(f"{method} {adjoint} {name}", steps, errors[:, k], LINEAR_ORDERS[method])


def _sine_exact(y0, p, w):
    """``y(1)`` of ``y' = p sin(y)`` and the gradients of ``sum(w * y(1))``."""
    growth = np.exp(p)
    t = np.tan(y0 / 2) * growth
    dy_dt = 2.0 / (1.0 + t**2)
    return 2.0 * np.arctan(t), w * dy_dt * growth / (2.0 * np.cos(y0 / 2) ** 2), w * dy_dt * t


def _sine_errors(method, adjoint, steps):
    """Relative errors of ``y(1)`` and of the gradients in ``y0`` and ``p``."""
    w = np.random.default_rng(2).standard_normal(SINE_Y0.shape)
    want = _sine_exact(SINE_Y0, SINE_P, w)

    def field(y, p):
        return p["rate"] * torch.sin(y)

    errors = []
    for n in steps:
        y0 = torch.tensor(SINE_Y0, requires_grad=True)
        p = {"rate": torch.tensor(SINE_P, requires_grad=True)}
        y1, _ = pde.solver_diffrax(0.0, 1.0, field, num_steps=n, method=method, adjoint=adjoint)(y0, p)
        g_y0, g_p = torch.autograd.grad(torch.sum(torch.tensor(w) * y1), (y0, p["rate"]))
        errors.append([_rel(y1, want[0]), _rel(g_y0, want[1]), _rel(g_p, want[2])])
    return np.array(errors)


@pytest.mark.parametrize("adjoint", ["direct", "backsolve"])
@pytest.mark.parametrize("method", METHODS)
def test_orders_on_a_nonlinear_ode(method, adjoint):
    """``y' = p sin(y)``, ``p`` in a dict: the value and the ``direct``
    gradients in ``y0`` and ``p`` converge to the closed form at the
    method's order, the ``backsolve`` gradients within ``BACKSOLVE_ORDER_TOL``."""
    errors = _sine_errors(method, adjoint, SINE_STEPS[method])
    assert errors.max() < 0.1 and errors.min() > 1e-14, errors
    order = ORDERS[method]
    for k, name in enumerate(("y1", "d/dy0", "d/dp")):
        tol = BACKSOLVE_ORDER_TOL if adjoint == "backsolve" and k else ORDER_TOL
        _assert_order(f"{method} {adjoint} {name}", SINE_STEPS[method], errors[:, k], (order, order), tol)


# ---------------------------------------------------------------------------
# The adjoints, the info and the errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_direct_and_recursive_checkpoint_agree(method):
    """The same discrete gradient; 10 steps make checkpointed segments of
    3, 3, 3 and 1 steps."""
    scale, y0, w = _wave_inputs(0.3, seed=3)
    assert rk.segment_length(10) == 3
    direct = _port_value_and_grads(method, "direct", 10, scale, y0, w)
    checkpointed = _port_value_and_grads(method, "recursive_checkpoint", 10, scale, y0, w)
    for a, b in zip(direct[:3], checkpointed[:3]):
        assert _rel(b, a) < TOL_ROUTES


def _damped_field(wave, stack):
    def field(y, p):
        return wave(y, p["scale"]) - p["shift"] * p["damping"] * stack([y[0] * 0.0, y[1]])

    return field


@functools.cache
def _jax_damped_reference():
    """The gradients of ``sum(w * y(1))`` in ``y0`` and the dict ``p``, dense."""
    scale, y0, w = _wave_inputs(0.3, seed=4)
    damping = np.random.default_rng(5).uniform(0.0, 0.5, (N_SIDE, N_SIDE))
    with jax.enable_x64(True):
        solve = jpde.solver_expm(0.0, 1.0, _damped_field(_jax_wave(), jnp.stack), jpde.expm_pade())

        def loss(y, p):
            return jnp.sum(jnp.asarray(w) * solve(y, p)[0])

        p_j = {"scale": jnp.asarray(scale), "damping": jnp.asarray(damping), "shift": 0.5}
        g_y0, g_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y0), p_j)
        return np.asarray(g_y0), {k: np.asarray(v) for k, v in g_p.items()}


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_gradients_flow_to_y0_and_a_dict_p(adjoint):
    """``p = {"scale": ..., "damping": ..., "shift": 0.5}`` (a float leaf too):
    Dopri8 at 32 steps against the JAX dense reference with the same dict,
    within 1e-8; with one leaf frozen the gradient in ``y0`` is the same."""
    scale, y0, w = _wave_inputs(0.3, seed=4)
    damping = np.random.default_rng(5).uniform(0.0, 0.5, (N_SIDE, N_SIDE))
    want_y0, want_p = _jax_damped_reference()
    y = torch.tensor(y0, requires_grad=True)
    p = {"scale": torch.tensor(scale, requires_grad=True), "damping": torch.tensor(damping, requires_grad=True),
         "shift": 0.5}
    solve_t = pde.solver_diffrax(0.0, 1.0, _damped_field(_torch_wave(), torch.stack), num_steps=32, method="dopri8",
                                 adjoint=adjoint)
    y1, _ = solve_t(y, p)
    g_y0, g_scale, g_damping = torch.autograd.grad(torch.sum(torch.tensor(w) * y1), (y, p["scale"], p["damping"]))
    assert _rel(g_y0, want_y0) < 1e-8
    assert _rel(g_scale, want_p["scale"]) < 1e-8
    assert _rel(g_damping, want_p["damping"]) < 1e-8
    frozen = {**p, "damping": p["damping"].detach()}
    (g_only,) = torch.autograd.grad(torch.sum(torch.tensor(w) * solve_t(y, frozen)[0]), (y,))
    assert torch.equal(g_only, g_y0)


@pytest.mark.parametrize("method", METHODS)
def test_num_matvecs_is_the_jax_formula_and_no_grad_gives_one_value(method):
    scale, y0, _w = _wave_inputs(0.3, seed=6)
    values = []
    for adjoint in ADJOINTS:
        solve = pde.solver_diffrax(0.0, 1.0, _torch_wave(), num_steps=7, method=method, adjoint=adjoint)
        with torch.no_grad():
            y1, info = solve(torch.tensor(y0), torch.tensor(scale))
        assert info == {"num_matvecs": 7 * ORDERS[method]}
        values.append(y1)
    assert all(torch.equal(v, values[0]) for v in values[1:])


def test_unknown_method_or_adjoint_raises_key_error():
    with pytest.raises(KeyError):
        pde.solver_diffrax(0.0, 1.0, lambda y, p: y, num_steps=2, method="rk4", adjoint="direct")
    with pytest.raises(KeyError):
        pde.solver_diffrax(0.0, 1.0, lambda y, p: y, num_steps=2, method="tsit5", adjoint="implicit")


def test_evaluations_a_step_are_the_stage_counts():
    calls = []

    def field(y, p):
        calls.append(1)
        return p * y

    for method in METHODS:
        calls.clear()
        pde.solver_diffrax(0.0, 1.0, field, num_steps=3, method=method, adjoint="direct")(
            torch.ones(2, dtype=torch.float64), torch.tensor(-1.0, dtype=torch.float64))
        assert len(calls) == 3 * STAGES[method], method


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_float32_follows_y0(adjoint):
    """Dopri5 at 32 steps in float32 against the same solve in float64:
    float32 in and out, within ``TOL_F32``."""
    scale, y0, w = _wave_inputs(0.3, seed=7)
    got = _port_value_and_grads("dopri5", adjoint, 32, scale, y0, w, dtype=torch.float32)
    want = _port_value_and_grads("dopri5", adjoint, 32, scale, y0, w)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert _rel(a, b) < TOL_F32
