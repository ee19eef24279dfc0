"""Legacy SLQ gradient strategies, kept for comparison studies.

Counterpart of ``lanczos_adjoints_tpu/krylov/deprecated.py``, the
strategies that pre-date the closed-form adjoints:

- ``integrand_spd_value_and_grad``: ``(value, grad)`` in one pass, the
  gradient from one extra operator VJP against ``|v| Q^T V f'(Lambda) V^T e1``;
  neither forward- nor reverse-mode, for when SLQ is the whole chain;
- ``integrand_spd_custom_vjp_recursive``: a ``torch.autograd.Function``
  whose backward pass evaluates two more SLQ quadratic forms of ``f'`` on
  ``v +- A v`` and differentiates their difference over four (the
  polarisation identity for ``v^T f'(A) A v``), with the decompositions
  held fixed.

Both decompose with ``krylov.lanczos.tridiag(reortho="full",
custom_vjp=False)``. Prefer ``krylov.lanczos.integrand_spd`` (exact
adjoints) or ``integrand_spd_custom_vjp_reuse``.
"""

import torch

from lanczos_adjoints_tpu_torch.krylov import lanczos


def _decompose(matvec, krylov_depth, v0, *parameters):
    """``(|v0|, v0 / |v0|, basis, eigvals, eigvecs)`` of the full-reortho
    tridiagonalisation from ``v0`` (flattened); ``matvec`` on ``v0``'s shape."""
    v0_flat = v0.reshape(-1)
    scale = torch.linalg.vector_norm(v0_flat)
    v0_unit = v0_flat / scale

    def matvec_flat(v_flat, *p):
        return matvec(v_flat.reshape(v0.shape), *p).reshape(-1)

    factorise = lanczos.tridiag(matvec_flat, krylov_depth, reortho="full", custom_vjp=False)
    (basis, (diags, offdiags)), _remainder = factorise(v0_unit, *parameters)
    dense = torch.diag(diags) + torch.diag(offdiags, 1) + torch.diag(offdiags, -1)
    eigvals, eigvecs = torch.linalg.eigh(dense)
    return scale, v0_unit, basis, eigvals, eigvecs, matvec_flat


def _derivative(matfun):
    return torch.func.vmap(torch.func.grad(matfun))


def integrand_spd_value_and_grad(matfun, krylov_depth, matvec, /):
    """SLQ integrand returning ``(value, grad)`` in one evaluation.

    ``value`` is ``dim * e1^T f(T) e1`` (calibrated for Rademacher probes,
    where ``|v|^2 = dim``), ``grad`` the gradient in the first parameter.
    """

    def quadform(v0, *parameters):
        with torch.no_grad():
            scale, _unit, basis, eigvals, eigvecs, matvec_flat = _decompose(matvec, krylov_depth, v0, *parameters)
            fx = torch.func.vmap(matfun)(eigvals)
            first = eigvecs[0, :]
            value = v0.numel() * torch.dot(first, fx * first)
            sol = eigvecs @ (_derivative(matfun)(eigvals) * first)
            w1 = scale * (basis.T @ sol)
        with torch.enable_grad():
            params = [p.detach().requires_grad_() for p in parameters]
            (grad,) = torch.autograd.grad(torch.dot(matvec_flat(v0.reshape(-1), *params), w1), params[:1])
        return value, grad

    return quadform


def _quadform_fixed_decomposition(matfun, krylov_depth, matvec, v0, *parameters):
    """``|v0|^2 z^T f(Lambda) z``, ``z = V^T Q v0 / |v0|``, differentiable in ``v0``
    only through ``z`` and ``|v0|``: the decomposition is held fixed."""
    with torch.no_grad():
        _scale, _unit, basis, eigvals, eigvecs, _mv = _decompose(matvec, krylov_depth, v0, *parameters)
    v0_flat = v0.reshape(-1)
    scale = torch.linalg.vector_norm(v0_flat)
    # Not the shortcut basis @ v0 = e1: that would drop the gradient.
    z = eigvecs.T @ (basis @ (v0_flat / scale))
    return scale**2 * torch.dot(z, torch.func.vmap(matfun)(eigvals) * z)


class _IntegrandRecursive(torch.autograd.Function):
    """``v0^T f(A) v0`` by SLQ; its VJP in the parameters differentiates
    ``(Z(v0 + A v0) - Z(v0 - A v0)) / 4``, each ``Z`` an SLQ quadratic form of
    ``f'`` with its decomposition held fixed. ``v0`` gets no gradient."""

    @staticmethod
    def forward(ctx, matfun, krylov_depth, matvec, v0, *parameters):
        ctx.matfun, ctx.krylov_depth, ctx.matvec = matfun, krylov_depth, matvec
        ctx.save_for_backward(v0, *parameters)
        with torch.no_grad():
            return _quadform_fixed_decomposition(matfun, krylov_depth, matvec, v0, *parameters)

    @staticmethod
    def backward(ctx, cotangent):
        v0, *parameters = ctx.saved_tensors
        dmatfun = torch.func.grad(ctx.matfun)
        with torch.enable_grad():
            params = [p.detach().requires_grad_() for p in parameters]
            mv = ctx.matvec(v0, *params)
            z1 = _quadform_fixed_decomposition(dmatfun, ctx.krylov_depth, ctx.matvec, v0 + mv, *params)
            z2 = _quadform_fixed_decomposition(dmatfun, ctx.krylov_depth, ctx.matvec, v0 - mv, *params)
            grads = torch.autograd.grad((z1 - z2) / 4, params, cotangent, allow_unused=True)
        return None, None, None, None, *grads


def integrand_spd_custom_vjp_recursive(matfun, krylov_depth, matvec, /):
    """SLQ integrand whose VJP calls SLQ again (``_IntegrandRecursive``)."""

    def quadform(v0, *parameters):
        return _IntegrandRecursive.apply(matfun, krylov_depth, matvec, v0, *parameters)

    return quadform
