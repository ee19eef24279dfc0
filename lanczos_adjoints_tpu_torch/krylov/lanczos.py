"""Blocked Lanczos tridiagonalisation with closed-form adjoints.

Counterpart of the blocked half of ``lanczos_adjoints_tpu/krylov/lanczos.py``
(``tridiag_block``, its forward recursion, the two adjoints and the
blocked SLQ integrand). ``m`` independent Lanczos recurrences share one
operator application ``matvec(V, *params)`` on an ``(n, m)`` block per
step, so the fused Gram kernel evaluates each kernel cell once for all
probes.

The closed-form adjoint is a ``torch.autograd.Function`` over
``(V, *params)``. Its parameter gradient is deferred, as in the JAX
package: the backward recursion emits the adjoint vectors, and one wide
``(n, K*m)`` vector-Jacobian product of the operator,
``torch.autograd.grad(matvec(lam_flat, *params), params, x_flat)``,
accumulates all K steps (``sum_s <x_s, A lam_s> = <X, A LAM>`` for a
columnwise operator). With the fused Gram matvec that is one K2 launch.
``params`` must be explicit tensors: a Function gives no gradient to
tensors that a closure captures (the JAX package lifts them with
``jax.closure_convert``).
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.ops import fused_gram
from lanczos_adjoints_tpu_torch.utils.precision import requires_float32


def _eigh_tridiag(diags, offdiags):
    """Eigendecomposition of a batch of small symmetric tridiagonal matrices.

    ``diags (..., K)``, ``offdiags (..., K-1)``.
    """
    dense = (
        torch.diag_embed(diags)
        + torch.diag_embed(offdiags, 1)
        + torch.diag_embed(offdiags, -1)
    )
    return torch.linalg.eigh(dense)


def tridiag_block(matvec: Callable, krylov_depth: int, /, *, reortho="none", custom_vjp=True):
    """``m`` independent Lanczos recurrences sharing operator applications.

    Returns ``estimate(V, *params) -> ((xs, (alphas, betas)), (x_res, beta_res))``
    for ``V (n, m)``: ``xs (K, n, m)``, ``alphas (K, m)``, ``betas (K-1, m)``.
    Per column the recursion matches single-probe Lanczos;
    ``reortho="full"`` re-orthogonalises each residual against the
    probe's own basis (twice), and its adjoint is the re-projected
    backward substitution. ``custom_vjp=False`` backpropagates through
    the loop instead (the oracle for the closed-form adjoint).
    """
    if reortho not in ("none", "full"):
        msg = f"reortho={reortho!r} unsupported; choose one of 'full', 'none'."
        raise ValueError(msg)

    @requires_float32
    def estimate(V, *params):
        if not 0 < krylov_depth <= V.shape[0]:
            msg = (
                f"Parameter depth {krylov_depth} is outside the expected "
                f"range (0, {V.shape[0]}]"
            )
            raise ValueError(msg)
        if custom_vjp:
            xs, alphas, betas, x_res, beta_res = _TridiagBlock.apply(
                matvec, krylov_depth, reortho, V, *params
            )
        else:
            (xs, (alphas, betas)), (x_res, beta_res), _ = _forward_block(
                matvec, krylov_depth, V, *params, reortho=reortho
            )
        return (xs, (alphas, betas)), (x_res, beta_res)

    return estimate


class _TridiagBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, krylov_depth, reortho, V, *params):
        (xs, (alphas, betas)), (x_res, beta_res), _ = _forward_block(
            matvec, krylov_depth, V, *params, reortho=reortho
        )
        ctx.matvec = matvec
        ctx.reortho = reortho
        ctx.save_for_backward(
            xs, alphas, betas, x_res, beta_res, torch.linalg.norm(V, dim=0), *params
        )
        return xs, alphas, betas, x_res, beta_res

    @staticmethod
    def backward(ctx, dxs_head, dalphas, dbetas_head, dx_res, dbeta_res):
        xs_head, alphas, betas_head, x_res, beta_res, norms, *params = ctx.saved_tensors
        adjoint = (
            _adjoint_block_reprojected if ctx.reortho == "full" else _adjoint_block
        )
        dvec, dparams = adjoint(
            ctx.matvec,
            params,
            ctx.needs_input_grad[4:],
            vec_norms=norms,
            xs=torch.cat([xs_head, x_res[None]]),
            alphas=alphas,
            betas=torch.cat([betas_head, beta_res[None]]),
            dxs=torch.cat([dxs_head, dx_res[None]]),
            dalphas=dalphas,
            dbetas=torch.cat([dbetas_head, dbeta_res[None]]),
        )
        return (None, None, None, dvec, *dparams)


def _forward_block(matvec, krylov_depth, V, *params, reortho="none"):
    norms = torch.linalg.norm(V, dim=0)
    x0 = V / norms
    x_prev, x = torch.zeros_like(x0), x0
    beta_prev = torch.zeros(x0.shape[1:], dtype=x0.dtype, device=x0.device)
    basis, alphas, betas = [x0], [], []

    def orthogonalise(resid):
        # Project the residual off every stored basis vector of the same
        # probe.
        stacked = torch.stack(basis)
        proj = torch.einsum("knm,nm->km", stacked, resid)
        return resid - torch.einsum("km,knm->nm", proj, stacked)

    for _ in range(krylov_depth):
        ax = matvec(x, *params)
        alpha = torch.sum(x * ax, dim=0)
        resid = ax - alpha * x - beta_prev * x_prev
        if reortho == "full":  # twice, for float32 robustness
            resid = orthogonalise(orthogonalise(resid))
        beta = torch.linalg.norm(resid, dim=0)
        x_next = resid / beta
        basis.append(x_next)
        alphas.append(alpha)
        betas.append(beta)
        x_prev, x, beta_prev = x, x_next, beta

    xs = torch.stack(basis)
    betas = torch.stack(betas)
    decomposition = (xs[:-1], (torch.stack(alphas), betas[:-1]))
    remainder = (xs[-1], betas[-1])
    return decomposition, remainder, 1.0 / norms


def _deferred_param_grads(matvec, params, needs, lams, xs):
    """``sum_s [d/dp <x_s, A(p) lam_s>]`` as one wide vector-Jacobian product."""
    wanted = [i for i, need in enumerate(needs) if need]
    grads = [None] * len(params)
    if not wanted:
        return grads
    k, n, m = lams.shape
    lam_flat = torch.movedim(lams, 0, -1).reshape(n, k * m)
    x_flat = torch.movedim(xs, 0, -1).reshape(n, k * m)
    with torch.enable_grad(), fused_gram.values_unused():
        p = [q.detach().requires_grad_(i in wanted) for i, q in enumerate(params)]
        out = matvec(lam_flat, *p)
        found = torch.autograd.grad(out, [p[i] for i in wanted], x_flat, allow_unused=True)
    for i, g in zip(wanted, found):
        grads[i] = g
    return grads


def _adjoint_block(matvec, params, needs, *, vec_norms, xs, alphas, betas, dxs, dalphas, dbetas):
    """Per-column closed-form adjoint with blocked operator applications."""
    k = alphas.shape[0]
    xi = -dxs[-1]
    lam_next = torch.zeros_like(dxs[-1])
    lams = [None] * k
    for s in reversed(range(k)):
        x, x_next = xs[s], xs[s + 1]
        alpha, beta = alphas[s], betas[s]
        # Happy-breakdown guard, per probe column.
        alive = beta > 0.0
        xi = torch.where(alive, xi / torch.where(alive, beta, 1.0), torch.zeros_like(xi))
        mu = dbetas[s] - torch.sum(lam_next * x, dim=0) + torch.sum(x_next * xi, dim=0)
        nu = dalphas[s] + torch.sum(x * xi, dim=0)
        lam = -xi + mu * x_next + nu * x
        a_lam = matvec(lam, *params)
        xi = -dxs[s] - a_lam + alpha * lam + beta * lam_next - beta * nu * x_next
        lam_next = lam
        lams[s] = lam

    dparams = _deferred_param_grads(matvec, params, needs, torch.stack(lams), xs[:-1])
    dvec = (torch.sum(xi * xs[0], dim=0) * xs[0] - xi) / vec_norms
    return dvec, dparams


def _tridiag_mat(diag_km, off_km):
    """(k, k, m) symmetric tridiagonal matrices from (k, m) and (k-1, m) bands."""
    k, m = diag_km.shape
    mat = torch.diag_embed(diag_km.T).permute(1, 2, 0)
    if k > 1:
        off = torch.diag_embed(off_km.T, 1).permute(1, 2, 0)
        mat = mat + off + off.transpose(0, 1)
    return mat


def _adjoint_block_reprojected(
    matvec, params, needs, *, vec_norms, xs, alphas, betas, dxs, dalphas, dbetas
):
    """Re-projected blocked adjoint for ``tridiag_block(reortho="full")``.

    The blocked, symmetric-tridiagonal form of the Arnoldi adjoint with
    full re-orthogonalisation: every backward step projects the adjoint
    vector onto the orthogonal complement of the still-active basis rows
    and restores the components prescribed by the tridiagonal
    cotangents. Same recursion as the JAX package's
    ``_adjoint_block_reprojected``, written as a Python loop.
    """
    kp1, n, m = xs.shape
    k = kp1 - 1
    dtype, device = alphas.dtype, alphas.device

    P = xs[:-1]  # (k, n, m) basis rows per probe
    betas_head = betas[:-1]  # (k-1, m)
    beta_res = betas[-1]
    x_hat = xs[-1]  # normalised residual direction
    res = x_hat * beta_res

    # Pull the remainder cotangents back through (res/|res|, |res|).
    inner = torch.sum(x_hat * dxs[-1], dim=0)
    dres = (dxs[-1] - x_hat * inner) / beta_res + dbetas[-1] * x_hat
    dXrows = dxs[:-1]

    H = _tridiag_mat(alphas, betas_head)
    dH = _tridiag_mat(dalphas, 0.5 * dbetas[:-1])

    eta = dH[:, -1, :] - torch.einsum("knm,nm->km", P, dres)
    lam = dres + torch.einsum("km,knm->nm", eta, P)

    Xi = dXrows + torch.einsum("km,nm->knm", eta, res)
    Gamma = torch.einsum("ijm,kjm->ikm", H, dH) - torch.einsum("inm,jnm->ijm", dXrows, P)

    ones_kk = torch.ones((k, k), dtype=dtype, device=device)
    half_lower = torch.tril(ones_kk) - 0.5 * torch.eye(k, dtype=dtype, device=device)
    proj_mask = torch.tril(ones_kk, 1)  # row idx: basis rows j <= idx+1 active
    dHT = dH.transpose(0, 1)
    ones_m = torch.ones((1, m), dtype=dtype, device=device)
    beta_lower = torch.cat([ones_m, betas_head])  # step idx divides by this
    beta_upper = torch.cat([betas_head, torch.zeros_like(ones_m)])

    Lambda = torch.zeros_like(P)
    Sigma = torch.zeros((k, k, m), dtype=dtype, device=device)
    lams = [None] * k
    for idx in reversed(range(k)):
        mask = proj_mask[idx][:, None]
        coeffs = torch.einsum("knm,nm->km", P, lam) * mask
        lam = lam + torch.einsum("km,knm->nm", dHT[idx] * mask - coeffs, P)

        a_lam = matvec(lam, *params)  # symmetric operator: A^T lam = A lam

        gram = torch.einsum("nm,knm->km", a_lam, P)
        Sigma[idx] = half_lower[idx][:, None] * (Gamma[idx] - gram)
        Lambda[idx] = lam
        s_row = Sigma[idx] + Sigma[:, idx]
        xi = Xi[idx] + torch.einsum("km,knm->nm", s_row, P)
        lam_up = Lambda[min(idx + 1, k - 1)]
        lam_next = xi - (alphas[idx] * lam - a_lam) - beta_upper[idx] * lam_up
        lams[idx] = lam
        lam = lam_next / beta_lower[idx]

    dparams = _deferred_param_grads(matvec, params, needs, torch.stack(lams), P)
    return lam / vec_norms, dparams


def integrand_spd_block(
    matfun: Callable,
    krylov_depth: int,
    matvec: Callable,
    /,
    *,
    reortho: str = "full",
    use_adjoints_for_tridiag: bool = True,
) -> Callable:
    """Blocked SLQ integrand: ``(n, m)`` probes -> ``(m,)`` quadratic forms ``v^T f(A) v``."""
    factorise = tridiag_block(
        matvec, krylov_depth, reortho=reortho, custom_vjp=use_adjoints_for_tridiag
    )

    def quadform(V, *parameters):
        scale = torch.linalg.norm(V, dim=0)
        (_xs, (diags, offdiags)), _remainder = factorise(V / scale, *parameters)
        eigvals, eigvecs = _eigh_tridiag(diags.T, offdiags.T)  # (m, K), (m, K, K)
        first = eigvecs[:, 0, :]
        return scale**2 * torch.sum(first * matfun(eigvals) * first, dim=-1)

    return quadform
