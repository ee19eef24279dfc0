"""Adaptive (preconditioned) conjugate gradients with an implicit backward pass.

Counterpart of ``pcg_adaptive`` / ``cg_adaptive`` in
``lanczos_adjoints_tpu/solvers/cg.py``. ``lax.custom_linear_solve(symmetric=True)``
becomes a ``torch.autograd.Function`` over ``(b, *params)``: the forward
pass solves ``A(params) x = b`` without recording a graph, and the
backward pass solves ``A lam = x_bar`` with the same PCG and returns
``lam`` for ``b`` and ``-d/dp <lam, A(p) x>`` for the parameters (one
vector-Jacobian product of the operator; with the fused Gram matvec, one
K2 launch). The preconditioner contributes no gradient, as in the JAX
package. The ``while_loop`` becomes a Python loop that reads its stopping
test on the host, one synchronisation per step.
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.ops import fused_gram
from lanczos_adjoints_tpu_torch.utils.precision import requires_float32


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
        x = torch.zeros_like(b)
        r = b - A(x)
        z = P(r)
        p, rz, nsteps = z, torch.dot(r, z), 0
        while nsteps < maxiter:
            error_rel = r / (atol + torch.abs(x) * rtol)
            too_large = bool(torch.sqrt(torch.mean(error_rel**2)) > 1.0)
            if not (too_large or nsteps < miniter):
                break
            Ap = A(p)
            step = _safe_divide(rz, torch.dot(p, Ap))
            x = x + step * p
            r = r - step * Ap
            z = P(r)
            rz_new = torch.dot(r, z)
            p = z + _safe_divide(rz_new, rz) * p
            rz = rz_new
            nsteps += 1
        return x, {
            "residual_abs": r,
            "residual_rel": _residual_rel(r, b),
            "num_steps": torch.tensor(float(nsteps)),
        }

    @requires_float32
    def pcg(A: Callable, b, *params, P: Callable):
        with torch.no_grad():
            x, info = pcg_impl(lambda v: A(v, *params), b, P)
        if torch.is_grad_enabled() and (b.requires_grad or any(q.requires_grad for q in params)):
            x = _ImplicitSolve.apply(A, lambda rhs: pcg_impl(
                lambda v: A(v, *params), rhs, P)[0], x, b, *params)
        return x, info

    return pcg


class _ImplicitSolve(torch.autograd.Function):
    """Attach the gradient of ``x = A(params)^{-1} b`` to a computed ``x``."""

    @staticmethod
    def forward(ctx, A, solve, x, b, *params):
        ctx.A = A
        ctx.solve = solve
        ctx.save_for_backward(x, *params)
        return x.clone()

    @staticmethod
    def backward(ctx, x_bar):
        x, *params = ctx.saved_tensors
        lam = ctx.solve(x_bar)  # symmetric: the transposed solve is the solve
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[4:]) if need]
        dparams = [None] * len(params)
        if wanted:
            with torch.enable_grad(), fused_gram.values_unused():
                p = [q.detach().requires_grad_(i in wanted) for i, q in enumerate(params)]
                ax = ctx.A(x, *p)
                found = torch.autograd.grad(ax, [p[i] for i in wanted], lam, allow_unused=True)
            for i, g in zip(wanted, found):
                dparams[i] = None if g is None else -g
        return (None, None, None, lam, *dparams)


def _safe_divide(a, b, /):
    """NaN-free division: returns ``a`` where ``|b|`` underflows.

    Lets CG iterate beyond convergence (numerator and denominator both
    ~0) without poisoning the solution.
    """
    eps = torch.finfo(a.dtype).eps ** 2
    big = torch.abs(b) > eps
    return torch.where(big, a / torch.where(big, b, torch.ones_like(b)), a)


def _residual_rel(r, b, /):
    """Residual relative to the right-hand side, ``r / ||b||_rms``."""
    scale = torch.sqrt(torch.mean(torch.abs(b) ** 2))
    return _safe_divide(r, scale)
