"""Fixed-step explicit Runge-Kutta methods and three ways to differentiate them.

What ``models.pde.solver_diffrax`` needs of diffrax, with no package:
``diffeqsolve`` under ``ConstantStepSize`` with ``Euler``, ``Heun``,
``Dopri5``, ``Tsit5`` or ``Dopri8``, and the ``DirectAdjoint``,
``RecursiveCheckpointAdjoint`` and ``BacksolveAdjoint`` gradients.

Each method is its Butcher tableau ``(A, b, c)``, copied here: under a
constant step no error estimate and no step control take part, so only
the solution weights ``b`` are kept, and the stages that only the error
estimate or the first-same-as-last reuse would need are left out (a
recomputed first stage gives the same value).

The vector field is ``vector_field(y, p)`` with no time argument
(diffrax's ``ODETerm`` in the JAX package drops it); ``y`` is a tensor
and ``p`` a tensor, ``None`` or a tuple, list or dict of them (a pytree,
as the JAX ``args``). Every tensor that the integration makes follows
``y``'s device and dtype.

- ``direct``: autograd through the steps (every stage kept).
- ``recursive_checkpoint``: the same discrete gradient from segments of
  about ``sqrt(num_steps)`` steps that keep only their first state; the
  backward pass runs each segment again under autograd. diffrax's binomial
  schedule is not copied, only the gradient it gives. The vector field is
  a deterministic function of ``(y, p)``, as diffrax requires, so no
  random-number state is kept for the second run. (``torch.utils.checkpoint``
  would do the same, but it makes tensors on the CPU at every call and
  imports ``torch._dynamo`` at its first, which took 8.7 s on an H100
  host.)
- ``backsolve``: the continuous adjoint. The forward keeps only
  ``y(t1)``; the backward integrates ``[y, a_y, a_p]`` from ``t1`` back to
  ``t0`` with the same tableau and step ``-dt0``: ``y' = f(y, p)``,
  ``a_y' = -a_y^T df/dy``, ``a_p' = -a_y^T df/dp``, one
  ``torch.autograd.grad`` a stage at the reconstructed ``y``. It is not
  the gradient of the discrete solution; it converges to the exact
  gradient at the method's order.
"""

import dataclasses
import math

import torch
import torch.utils._pytree as pytree


@dataclasses.dataclass(frozen=True)
class Tableau:
    """An explicit Runge-Kutta method: ``a[i]`` holds stage ``i``'s
    coefficients on the stages before it, ``b`` the solution weights,
    ``c`` the nodes; ``order`` is diffrax's ``order``."""

    order: int
    a: tuple
    b: tuple
    c: tuple

    @property
    def stages(self) -> int:
        """Vector-field evaluations a step."""
        return len(self.b)


EULER = Tableau(order=1, a=((),), b=(1.0,), c=(0.0,))

# The explicit trapezoid rule.
HEUN = Tableau(order=2, a=((), (1.0,)), b=(0.5, 0.5), c=(0.0, 1.0))

# Dormand and Prince, "A family of embedded Runge-Kutta formulae" (1980):
# the 5th-order solution of RK5(4)7M, its 7th stage (the FSAL one, only for
# the error estimate) left out. scipy's ``RK45.A``, ``B``, ``C``.
DOPRI5 = Tableau(
    order=5,
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0),
)

# Tsitouras, "Runge-Kutta pairs of order 5(4) satisfying only the first
# column simplifying assumption" (2011): the 5th-order weights (the 7th,
# FSAL, stage has weight zero and is left out). The coefficients are the
# paper's decimals, as diffrax and OrdinaryDiffEq carry them.
TSIT5 = Tableau(
    order=5,
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.897153057105493, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401, -0.028269050394068383),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0),
)

# Prince and Dormand, "High order embedded Runge-Kutta formulae" (1981):
# RK8(7)13M, the 8th-order weights, which is diffrax's ``Dopri8`` (scipy's
# ``DOP853`` is Hairer's other 8th-order pair).
DOPRI8 = Tableau(
    order=8,
    a=(
        (),
        (1 / 18,),
        (1 / 48, 1 / 16),
        (1 / 32, 0.0, 3 / 32),
        (5 / 16, 0.0, -75 / 64, 75 / 64),
        (3 / 80, 0.0, 0.0, 3 / 16, 3 / 20),
        (29443841 / 614563906, 0.0, 0.0, 77736538 / 692538347, -28693883 / 1125000000, 23124283 / 1800000000),
        (16016141 / 946692911, 0.0, 0.0, 61564180 / 158732637, 22789713 / 633445777, 545815736 / 2771057229,
         -180193667 / 1043307555),
        (39632708 / 573591083, 0.0, 0.0, -433636366 / 683701615, -421739975 / 2616292301, 100302831 / 723423059,
         790204164 / 839813087, 800635310 / 3783071287),
        (246121993 / 1340847787, 0.0, 0.0, -37695042795 / 15268766246, -309121744 / 1061227803,
         -12992083 / 490766935, 6005943493 / 2108947869, 393006217 / 1396673457, 123872331 / 1001029789),
        (-1028468189 / 846180014, 0.0, 0.0, 8478235783 / 508512852, 1311729495 / 1432422823,
         -10304129995 / 1701304382, -48777925059 / 3047939560, 15336726248 / 1032824649,
         -45442868181 / 3398467696, 3065993473 / 597172653),
        (185892177 / 718116043, 0.0, 0.0, -3185094517 / 667107341, -477755414 / 1098053517,
         -703635378 / 230739211, 5731566787 / 1027545527, 5232866602 / 850066563, -4093664535 / 808688257,
         3962137247 / 1805957418, 65686358 / 487910083),
        (403863854 / 491063109, 0.0, 0.0, -5068492393 / 434740067, -411421997 / 543043805,
         652783627 / 914296604, 11173962825 / 925320556, -13158990841 / 6184727034, 3936647629 / 1978049680,
         -160528059 / 685178525, 248638103 / 1413531060, 0.0),
    ),
    b=(14005451 / 335480064, 0.0, 0.0, 0.0, 0.0, -59238493 / 1068277825, 181606767 / 758867731,
       561292985 / 797845732, -1041891430 / 1371343529, 760417239 / 1151165299, 118820643 / 751138087,
       -528747749 / 2220607170, 1 / 4),
    c=(0.0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200, 5490023248 / 9719169821, 13 / 20,
       1201146811 / 1299019798, 1.0, 1.0),
)

TABLEAUX = {"euler": EULER, "heun": HEUN, "dopri5": DOPRI5, "tsit5": TSIT5, "dopri8": DOPRI8}


def _combine(state, h, coefs, ks):
    """``state + h * sum_j coefs[j] * ks[j]``, tensor by tensor, over the
    nonzero coefficients."""
    terms = [(coef, k) for coef, k in zip(coefs, ks) if coef != 0.0]
    if not terms:
        return state
    (coef0, k0), rest = terms[0], terms[1:]
    out = []
    for i, x in enumerate(state):
        acc = k0[i] * coef0
        for coef, k in rest:
            acc = acc.add(k[i], alpha=coef)
        out.append(x.add(acc, alpha=h))
    return out


def rk_step(tableau: Tableau, field, state, h):
    """One step of ``tableau`` with step ``h`` on a list of tensors:
    ``field(state) -> list`` of their derivatives."""
    ks = []
    for a_i in tableau.a:
        ks.append(field(_combine(state, h, a_i, ks)))
    return _combine(state, h, tableau.b, ks)


def _steps(tableau, vector_field, y, p, h, num_steps):
    def field(state):
        return [vector_field(state[0], p)]

    state = [y]
    for _ in range(num_steps):
        state = rk_step(tableau, field, state, h)
    return state[0]


def integrate_direct(tableau, vector_field, y0, p, *, dt0, num_steps):
    """``y(t0 + num_steps dt0)``; autograd differentiates through every stage."""
    return _steps(tableau, vector_field, y0, p, dt0, num_steps)


def segment_length(num_steps: int) -> int:
    """Steps a checkpointed segment: about ``sqrt(num_steps)``."""
    return max(1, round(math.sqrt(num_steps)))


def _split(p):
    """``p``'s tensor leaves, and what ``_join`` rebuilds ``p`` from with them."""
    leaves, spec = pytree.tree_flatten(p)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    return tensors, (spec, tuple(None if isinstance(x, torch.Tensor) else x for x in leaves))


def _join(rebuild, tensors):
    spec, others = rebuild
    tensors = iter(tensors)
    return pytree.tree_unflatten([next(tensors) if x is None else x for x in others], spec)


class _Segment(torch.autograd.Function):
    """``count`` steps from ``y`` that keep only ``y`` and ``p``'s tensor
    leaves for the backward pass, which runs the steps again under autograd."""

    @staticmethod
    def forward(ctx, tableau, vector_field, rebuild, dt0, count, y, *leaves):
        ctx.args = (tableau, vector_field, rebuild, dt0, count)
        ctx.save_for_backward(y, *leaves)
        return _steps(tableau, vector_field, y, _join(rebuild, leaves), dt0, count)

    @staticmethod
    def backward(ctx, grad):
        tableau, vector_field, rebuild, dt0, count = ctx.args
        inputs = [x.detach().requires_grad_(w) for x, w in zip(ctx.saved_tensors, ctx.needs_input_grad[5:])]
        with torch.enable_grad():
            out = _steps(tableau, vector_field, inputs[0], _join(rebuild, inputs[1:]), dt0, count)
        grads = iter(torch.autograd.grad(out, [x for x in inputs if x.requires_grad], grad, allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if x.requires_grad else None for x in inputs)


def integrate_recursive_checkpoint(tableau, vector_field, y0, p, *, dt0, num_steps):
    """``integrate_direct``'s value and gradient, with only the segments'
    first states kept for the backward pass; each segment runs again there."""
    tensors, rebuild = _split(p)
    y, length = y0, segment_length(num_steps)
    for start in range(0, num_steps, length):
        y = _Segment.apply(tableau, vector_field, rebuild, dt0, min(length, num_steps - start), y, *tensors)
    return y


class _Backsolve(torch.autograd.Function):
    """``y(t1)`` with the continuous adjoint as its backward pass. The
    arguments after ``y0`` are ``p``'s tensor leaves."""

    @staticmethod
    def forward(ctx, tableau, vector_field, rebuild, dt0, num_steps, y0, *leaves):
        ctx.args = (tableau, vector_field, rebuild, dt0, num_steps)
        y1 = _steps(tableau, vector_field, y0, _join(rebuild, leaves), dt0, num_steps)
        ctx.save_for_backward(y1, *leaves)
        return y1

    @staticmethod
    def backward(ctx, grad_y1):
        tableau, vector_field, rebuild, dt0, num_steps = ctx.args
        y1, *leaves = ctx.saved_tensors
        wanted = ctx.needs_input_grad[6:]

        def field(state):
            with torch.enable_grad():
                y = state[0].detach().requires_grad_()
                leaves_ = [x.detach().requires_grad_(w) for x, w in zip(leaves, wanted)]
                f = vector_field(y, _join(rebuild, leaves_))
                inputs = [y] + [x for x in leaves_ if x.requires_grad]
                grads = torch.autograd.grad(f, inputs, grad_outputs=state[1], allow_unused=True)
            grads = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
            a_y = -next(grads)
            a_p = [-next(grads) if w else torch.zeros_like(x) for x, w in zip(leaves, wanted)]
            return [f.detach(), a_y, *a_p]

        state = [y1, grad_y1] + [torch.zeros_like(x) for x in leaves]
        for _ in range(num_steps):
            state = rk_step(tableau, field, state, -dt0)
        grad_y0 = state[1] if ctx.needs_input_grad[5] else None
        return (None,) * 5 + (grad_y0, *[g if w else None for g, w in zip(state[2:], wanted)])


def integrate_backsolve(tableau, vector_field, y0, p, *, dt0, num_steps):
    """``integrate_direct``'s value; the gradient of the continuous adjoint."""
    tensors, rebuild = _split(p)
    return _Backsolve.apply(tableau, vector_field, rebuild, dt0, num_steps, y0, *tensors)


ADJOINTS = {
    "direct": integrate_direct,
    "recursive_checkpoint": integrate_recursive_checkpoint,
    "backsolve": integrate_backsolve,
}
