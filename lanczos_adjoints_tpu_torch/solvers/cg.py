"""Fixed-step and adaptive (preconditioned) conjugate gradients with an implicit backward pass.

Counterpart of ``pcg_fixed_step`` / ``cg_fixed_step``, ``pcg_adaptive`` /
``cg_adaptive`` and ``pcg_fixed_step_reortho`` / ``cg_fixed_step_reortho``
in ``lanczos_adjoints_tpu/solvers/cg.py``.
``lax.custom_linear_solve(symmetric=True)``
becomes a ``torch.autograd.Function`` over ``(b, *params)``: the forward
pass solves ``A(params) x = b`` without recording a graph, and the
backward pass solves ``A lam = x_bar`` with the same PCG and returns
``lam`` for ``b`` and ``-d/dp <lam, A(p) x>`` for the parameters (one
vector-Jacobian product of the operator; with the fused Gram matvec, one
K2 launch). Under ``torch.func.jvp`` the same Function solves for the
tangent, ``A x_dot = b_dot - (dA/dp p_dot) x``, as the JAX package's
linear-solve rule does, instead of differentiating the iterations. The
preconditioner contributes no gradient, as in the JAX package. The
adaptive ``while_loop`` becomes a Python loop that reads its stopping
test on the host, one synchronisation per step; the fixed-step
``fori_loop`` a Python loop of ``num_matvecs`` steps with no
synchronisation.
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.ops import fused_gram
from lanczos_adjoints_tpu_torch.utils.precision import requires_float32


def cg_fixed_step(num_matvecs: int, /) -> Callable:
    pcg_solve = pcg_fixed_step(num_matvecs)

    def cg(A: Callable, b, *params):
        return pcg_solve(A, b, *params, P=lambda v: v)

    return cg


def pcg_fixed_step(num_matvecs: int, /) -> Callable:
    """PCG with a fixed matvec budget: exactly ``num_matvecs`` steps.

    Returns ``pcg(A, b, *params, P) -> (x, info)``, as ``pcg_adaptive``;
    the info holds ``residual_abs`` and ``residual_rel`` and, as in the
    JAX package, no ``num_steps``.
    """

    def pcg_impl(A, b, P):
        x, r, p, rz = _pcg_start(A, b, P)
        for _ in range(num_matvecs):
            x, r, p, rz = _pcg_step(A, P, x, r, p, rz)
        return x, {"residual_abs": r, "residual_rel": _residual_rel(r, b)}

    return _implicit(pcg_impl)


def cg_adaptive(**kwargs) -> Callable:
    pcg_solve = pcg_adaptive(**kwargs)

    def cg(A: Callable, b, *params):
        return pcg_solve(A, b, *params, P=lambda v: v)

    return cg


def pcg_adaptive(*, atol: float, rtol: float, maxiter: int, miniter: int) -> Callable:
    """PCG iterated until an allclose-style tolerance.

    Returns ``pcg(A, b, *params, P) -> (x, info)`` for ``A(v, *params)``
    symmetric positive definite and ``P(v)`` its preconditioner.
    """

    def pcg_impl(A, b, P):
        x, r, p, rz = _pcg_start(A, b, P)
        nsteps = 0
        while nsteps < maxiter:
            error_rel = r / (atol + torch.abs(x) * rtol)
            too_large = bool(torch.sqrt(torch.mean(error_rel**2)) > 1.0)
            if not (too_large or nsteps < miniter):
                break
            x, r, p, rz = _pcg_step(A, P, x, r, p, rz)
            nsteps += 1
        return x, {
            "residual_abs": r,
            "residual_rel": _residual_rel(r, b),
            "num_steps": torch.tensor(float(nsteps)),
        }

    return _implicit(pcg_impl)


def cg_fixed_step_reortho(num_matvecs: int, /) -> Callable:
    pcg_solve = pcg_fixed_step_reortho(num_matvecs)

    def cg(A: Callable, b, *params):
        return pcg_solve(A, b, *params, P=lambda v: v)

    return cg


# The name under which the linearised-Laplace predictives import it.
krylov_solve_cg_fixed_step_reortho = cg_fixed_step_reortho


def pcg_fixed_step_reortho(num_matvecs: int, /) -> Callable:
    """PCG that re-orthogonalises each residual against the previous ones.

    Stores the residuals, normalised in the ``P`` inner product, as the
    rows of ``Q (num_matvecs, n)`` and projects each new residual off
    them, which restores convergence on ill-conditioned spectra where
    plain CG loses orthogonality. Returns ``pcg(A, b, *params, P) ->
    (x, info)`` with ``residual_abs`` and ``Q`` in the info.
    """

    def pcg_impl(A, b, P):
        x, r, p, rz = _pcg_start(A, b, P)
        z = p
        Q = torch.zeros((num_matvecs, b.shape[0]), dtype=b.dtype, device=b.device)
        for i in range(num_matvecs):
            Ap = A(p)
            step = _safe_divide(rz, torch.dot(p, Ap))
            x = x + step * p
            r_new, r_old, z_old = r - step * Ap, r, z
            Q[i] = _safe_divide(r_old, _safe_sqrt(rz))
            z_new = P(r_new)
            r_new = r_new - Q.T @ (Q @ z_new)
            z_new = P(r_new)
            rz_new = torch.dot(r_new, z_new)
            p = z_new + _safe_divide(rz_new, torch.dot(r_old, z_old)) * p
            r, z, rz = r_new, z_new, rz_new
        return x, {"residual_abs": r, "Q": Q}

    return _implicit(pcg_impl)


def _pcg_start(A, b, P):
    """PCG's start from ``x = 0``: the iterate, residual, direction and ``<r, P r>``."""
    x = torch.zeros_like(b)
    r = b - A(x)
    z = P(r)
    return x, r, z, torch.dot(r, z)


def _pcg_step(A, P, x, r, p, rz):
    """One PCG step: the next iterate, residual, direction and ``<r, P r>``."""
    Ap = A(p)
    step = _safe_divide(rz, torch.dot(p, Ap))
    x = x + step * p
    r = r - step * Ap
    z = P(r)
    rz_new = torch.dot(r, z)
    return x, r, z + _safe_divide(rz_new, rz) * p, rz_new


def _implicit(pcg_impl: Callable) -> Callable:
    """``pcg(A, b, *params, P)``: ``pcg_impl(A, b, P)`` run without a graph,
    its solution given the implicit derivatives of ``_ImplicitSolve``."""

    @requires_float32
    def pcg(A: Callable, b, *params, P: Callable):
        with torch.no_grad():
            x, info = pcg_impl(lambda v: A(v, *params), b, P)
        return _ImplicitSolve.apply(A, P, pcg_impl, x, b, *params), info

    return pcg


class _ImplicitSolve(torch.autograd.Function):
    """Attach the derivatives of ``x = A(params)^{-1} b`` to a computed ``x``.

    Reverse mode solves ``A lam = x_bar``; forward mode (``torch.func.jvp``)
    solves ``A x_dot = b_dot - (dA/dp p_dot) x``, as ``custom_linear_solve``
    does, instead of differentiating the iterations.
    """

    @staticmethod
    def forward(A, P, pcg_impl, x, b, *params):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, P, pcg_impl, x, _b, *params = inputs
        ctx.A, ctx.P, ctx.pcg_impl = A, P, pcg_impl
        ctx.save_for_backward(x, *params)
        ctx.save_for_forward(x, *params)

    @staticmethod
    def _solve(ctx, rhs, params):
        return ctx.pcg_impl(lambda v: ctx.A(v, *params), rhs, ctx.P)[0]

    @staticmethod
    def backward(ctx, x_bar):
        x, *params = ctx.saved_tensors
        lam = _ImplicitSolve._solve(ctx, x_bar, params)  # symmetric: the transposed solve is the solve
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[5:]) if need]
        dparams = [None] * len(params)
        if wanted:
            with torch.enable_grad(), fused_gram.values_unused():
                p = [q.detach().requires_grad_(i in wanted) for i, q in enumerate(params)]
                ax = ctx.A(x, *p)
                found = torch.autograd.grad(ax, [p[i] for i in wanted], lam, allow_unused=True)
            for i, g in zip(wanted, found):
                dparams[i] = None if g is None else -g
        return (None, None, None, None, lam, *dparams)

    @staticmethod
    def jvp(ctx, _A_dot, _P_dot, _impl_dot, _x_dot, b_dot, *params_dot):
        x, *params = ctx.saved_tensors
        rhs = torch.zeros_like(x) if b_dot is None else b_dot
        moving = [i for i, t in enumerate(params_dot) if t is not None]
        if moving:
            def a_of(*q):
                full = list(params)
                for i, qi in zip(moving, q):
                    full[i] = qi
                return ctx.A(x, *full)

            _ax, dax = torch.func.jvp(
                a_of, tuple(params[i] for i in moving), tuple(params_dot[i] for i in moving)
            )
            rhs = rhs - dax
        return _ImplicitSolve._solve(ctx, rhs, params)


def _safe_divide(a, b, /):
    """NaN-free division: returns ``a`` where ``|b|`` underflows.

    Lets CG iterate beyond convergence (numerator and denominator both
    ~0) without poisoning the solution.
    """
    eps = torch.finfo(a.dtype).eps ** 2
    big = torch.abs(b) > eps
    return torch.where(big, a / torch.where(big, b, torch.ones_like(b)), a)


def _safe_sqrt(a, /):
    return torch.sqrt(torch.where(a > 0.0, a, torch.zeros_like(a)))


def _residual_rel(r, b, /):
    """Residual relative to the right-hand side, ``r / ||b||_rms``."""
    scale = torch.sqrt(torch.mean(torch.abs(b) ** 2))
    return _safe_divide(r, scale)
