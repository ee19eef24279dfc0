"""Lanczos tridiagonalisation with closed-form adjoints.

Counterpart of ``lanczos_adjoints_tpu/krylov/lanczos.py``: the
single-vector ``tridiag(reortho="none")`` with its closed-form adjoint
and its dispatch of DIA operators to the fused Lanczos kernels, and the
blocked half (``tridiag_block``, its forward recursion, the two adjoints
and the blocked SLQ integrand).

``tridiag``'s adjoint runs the reverse recursion with one operator
application and one parameter vector-Jacobian product per step,
``torch.autograd.grad(matvec(lam, *params), params, x)``; with the DIA
kernel matvec that is one K4 and one K5 launch. ``reortho="full"`` runs
through Arnoldi (``krylov.arnoldi.hessenberg``: K9 for DIA operators on
the card) and inherits its re-projected adjoint; the per-probe SLQ
integrands ``integrand_spd`` (its quadratic form with a Daleckii-Krein
derivative) and ``integrand_spd_custom_vjp_reuse`` build on it.

In the blocked half ``m`` independent Lanczos recurrences share one
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

from lanczos_adjoints_tpu_torch.krylov import arnoldi
from lanczos_adjoints_tpu_torch.ops import fused_gram, native
from lanczos_adjoints_tpu_torch.utils import spans
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
    @spans.spanned("slq.lanczos")
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
    @spans.spanned("slq.adjoint")
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


# ---------------------------------------------------------------------------
# Single-vector Lanczos (tridiag) and its dispatch to the fused DIA kernels
# ---------------------------------------------------------------------------


def tridiag(
    matvec: Callable,
    krylov_depth: int,
    /,
    *,
    reortho: str,
    custom_vjp: bool = True,
    allow_fused: bool = True,
    dispatch_log: list | None = None,
) -> Callable:
    """Construct a Lanczos tridiagonalisation ``A ~ X^T T X``.

    Returns ``estimate(vec, *params)`` producing
    ``((basis, (diags, offdiags)), (residual_vector, last_offdiag))`` with
    ``basis (K, n)``, ``diags (K,)`` and ``offdiags (K-1,)``, for a
    symmetric operator ``matvec(v, *params) -> A v``. ``params`` must be
    the tensors to differentiate: the adjoint gives no gradient to
    tensors the closure captures.

    ``custom_vjp=True`` registers the closed-form adjoint;
    ``custom_vjp=False`` backpropagates through the recurrence (the
    oracle). An operator tagged ``.dia_data`` (``ops.sparse``) runs the
    fused DIA kernels on the card, where the JAX package runs its Pallas
    kernels on a TPU; the card has none of the TPU's size limits.
    ``dispatch_log``, if a list, gets one event per call:
    ``"tridiag:dia_fused"`` or ``"tridiag:generic"``; with
    ``reortho="full"``, ``"tridiag:arnoldi_full"`` followed by
    ``hessenberg``'s event (``allow_fused`` passes on to it).
    """
    if reortho == "full":
        est = _tridiag_via_arnoldi(
            matvec, krylov_depth, custom_vjp=custom_vjp, allow_fused=allow_fused,
            dispatch_log=dispatch_log,
        )
        return _with_dispatch_event(est, dispatch_log, "tridiag:arnoldi_full")
    if reortho != "none":
        msg = f"reortho={reortho!r} unsupported; choose one of 'full', 'none'."
        raise ValueError(msg)
    plain = _tridiag_plain(matvec, krylov_depth, custom_vjp=custom_vjp)
    dia = getattr(matvec, "dia_data", None)
    if allow_fused and custom_vjp and dia is not None:
        return _tridiag_dispatch_dia(plain, dia, krylov_depth, dispatch_log=dispatch_log)
    return _with_dispatch_event(plain, dispatch_log, "tridiag:generic")


def _log_dispatch(dispatch_log, event):
    """Record a dispatch decision (no-op when the log is None)."""
    if dispatch_log is not None:
        dispatch_log.append(event)


def _with_dispatch_event(estimate, dispatch_log, event):
    if dispatch_log is None:
        return estimate

    def logged(vec, *params):
        _log_dispatch(dispatch_log, event)
        return estimate(vec, *params)

    return logged


def _tridiag_dispatch_dia(plain, dia, krylov_depth, *, dispatch_log=None):
    """Route DIA-tagged operators on the card to the fused kernels.

    Any ``(vec (n,), values (D, n))`` call on the card goes to K6/K7:
    they take any n, and the basis lives in device memory, so the JAX
    package's TPU limits (``n % 128``, a VMEM budget) do not apply. A
    dtype the kernels do not take raises there. Other calls, and calls
    off the card, run the generic recursion.
    """

    def estimate(vec, *params):
        n = dia.shape[0]
        is_plain_call = (
            len(params) == 1
            and tuple(params[0].shape) == (len(dia.offsets), n)
            and tuple(vec.shape) == (n,)
            and 0 < krylov_depth <= n
            and native.on_card(vec.device)
        )
        if is_plain_call:
            from lanczos_adjoints_tpu_torch.ops import fused_lanczos

            _log_dispatch(dispatch_log, "tridiag:dia_fused")
            fused = fused_lanczos.tridiag_dia_fused(dia, krylov_depth, check_tiling=False)
            return fused(vec, params[0])
        _log_dispatch(dispatch_log, "tridiag:generic")
        return plain(vec, *params)

    return estimate


def _tridiag_via_arnoldi(matvec, krylov_depth, /, *, custom_vjp, allow_fused, dispatch_log=None):
    """Full re-orthogonalisation: Arnoldi, read off as a tridiagonal decomposition.

    Arnoldi orthogonalises against the whole basis; its adjoint is the
    re-projected backward substitution.
    """
    hess = arnoldi.hessenberg(
        matvec, krylov_depth, reortho="full", custom_vjp=custom_vjp,
        allow_fused=allow_fused, dispatch_log=dispatch_log,
    )

    def estimate(vec, *params):
        Q, H, res, _inv_norm = hess(vec, *params)
        T = 0.5 * (H + H.T)
        sq = res @ res
        alive = sq > 0.0
        res_norm = torch.where(alive, torch.sqrt(torch.where(alive, sq, 1.0)), 0.0)
        decomposition = (Q.T, (torch.diagonal(T), torch.diagonal(T, 1)))
        # Happy breakdown leaves an exactly-zero residual: normalise it
        # safely (the zero vector, like the truncated basis columns).
        res_unit = torch.where(
            alive, res / torch.where(alive, res_norm, 1.0), torch.zeros_like(res)
        )
        return decomposition, (res_unit, res_norm)

    return estimate


def _tridiag_plain(matvec, krylov_depth, /, *, custom_vjp):
    @requires_float32
    def estimate(vec, *params):
        if not 0 < krylov_depth <= len(vec):
            msg = (
                f"Parameter depth {krylov_depth} is outside the expected "
                f"range (0, {len(vec)}]"
            )
            raise ValueError(msg)
        if custom_vjp:
            xs, alphas, betas, x_res, beta_res = _Tridiag.apply(
                matvec, krylov_depth, vec, *params
            )
            return (xs, (alphas, betas)), (x_res, beta_res)
        decomposition, remainder, _inv_norm = _forward(matvec, krylov_depth, vec, *params)
        return decomposition, remainder

    return estimate


class _Tridiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, krylov_depth, vec, *params):
        (xs, (alphas, betas)), (x_res, beta_res), _ = _forward(
            matvec, krylov_depth, vec, *params
        )
        ctx.matvec = matvec
        ctx.save_for_backward(
            xs, alphas, betas, x_res, beta_res, torch.linalg.vector_norm(vec), *params
        )
        return xs, alphas, betas, x_res, beta_res

    @staticmethod
    def backward(ctx, dxs_head, dalphas, dbetas_head, dx_res, dbeta_res):
        xs_head, alphas, betas_head, x_res, beta_res, vec_norm, *params = ctx.saved_tensors
        # Stack the residual entries back onto the main sequences.
        dvec, dparams = _adjoint(
            ctx.matvec,
            params,
            ctx.needs_input_grad[3:],
            vec_norm=vec_norm,
            xs=torch.cat([xs_head, x_res[None]]),
            alphas=alphas,
            betas=torch.cat([betas_head, beta_res[None]]),
            dxs=torch.cat([dxs_head, dx_res[None]]),
            dalphas=dalphas,
            dbetas=torch.cat([dbetas_head, dbeta_res[None]]),
        )
        return (None, None, dvec, *dparams)


def _forward(matvec, krylov_depth, vec, *params):
    """Three-term recurrence, one matvec per step, with the exhaustion guards."""
    norm = torch.linalg.vector_norm(vec)
    x0 = vec / norm
    x_prev, x = torch.zeros_like(x0), x0
    beta_prev = torch.zeros((), dtype=x0.dtype, device=x0.device)
    xs, alphas, betas = [x0], [], []
    for _ in range(krylov_depth):
        ax = matvec(x, *params)
        alpha = x @ ax
        resid = ax - alpha * x - beta_prev * x_prev
        # Safe norm: backprop through sqrt at an exactly-zero residual
        # (after an exhausted Krylov space) would be 0 * inf = NaN.
        sq = resid @ resid
        alive = sq > 0.0
        beta = torch.where(alive, torch.sqrt(torch.where(alive, sq, 1.0)), 0.0)
        # An exactly-exhausted Krylov space (beta == 0) truncates with zero
        # columns instead of 0 / 0.
        x_next = torch.where(
            alive, resid / torch.where(alive, beta, 1.0), torch.zeros_like(resid)
        )
        xs.append(x_next)
        alphas.append(alpha)
        betas.append(beta)
        x_prev, x, beta_prev = x, x_next, beta
    xs = torch.stack(xs)
    betas = torch.stack(betas)
    decomposition = (xs[:-1], (torch.stack(alphas), betas[:-1]))
    remainder = (xs[-1], betas[-1])
    return decomposition, remainder, 1.0 / norm


def _adjoint(matvec, params, needs, *, vec_norm, xs, alphas, betas, dxs, dalphas, dbetas):
    """Closed-form adjoint: the reverse (lambda, mu, nu) recursion.

    The adjoint system of arXiv:2405.17277 for the three-term recurrence.
    Each step applies the operator to lambda and takes the parameter
    vector-Jacobian product ``x^T d/dp (A(p) lambda)`` in the same
    autograd call; the increments are summed over the steps.
    """
    wanted = [i for i, need in enumerate(needs) if need]
    dparams = [None] * len(params)
    xi = -dxs[-1]
    lam_next = torch.zeros_like(dxs[-1])
    for s in reversed(range(alphas.shape[0])):
        x, x_next = xs[s], xs[s + 1]
        alpha, beta = alphas[s], betas[s]
        # A zero beta decouples the trailing (truncated) block: its adjoint
        # vector is zero, not xi / 0.
        alive = beta > 0.0
        xi = torch.where(alive, xi / torch.where(alive, beta, 1.0), torch.zeros_like(xi))
        mu = dbetas[s] - lam_next @ x + x_next @ xi
        nu = dalphas[s] + x @ xi
        lam = -xi + mu * x_next + nu * x
        if wanted:
            with torch.enable_grad():
                p = [q.detach().requires_grad_(i in wanted) for i, q in enumerate(params)]
                a_lam = matvec(lam, *p)
                found = torch.autograd.grad(a_lam, [p[i] for i in wanted], x, allow_unused=True)
            a_lam = a_lam.detach()
            for i, g in zip(wanted, found):
                if g is not None:
                    dparams[i] = g if dparams[i] is None else dparams[i] + g
        else:
            a_lam = matvec(lam, *params)
        xi = -dxs[s] - a_lam + alpha * lam + beta * lam_next - beta * nu * x_next
        lam_next = lam
    for i in wanted:
        if dparams[i] is None:
            dparams[i] = torch.zeros_like(params[i])
    dvec = ((xi @ xs[0]) * xs[0] - xi) / vec_norm
    return dvec, dparams


# ---------------------------------------------------------------------------
# Per-probe SLQ integrands
# ---------------------------------------------------------------------------


def _flat_operator(matvec, shape):
    """``matvec`` on flat vectors for probes of ``shape``.

    A 1-D probe keeps ``matvec`` itself, with its ``.dia_data`` tag, so
    that ``tridiag`` can dispatch it to the fused kernels.
    """
    if len(shape) == 1:
        return matvec

    def matvec_flat(v_flat, *p):
        return matvec(v_flat.reshape(shape), *p).reshape(-1)

    return matvec_flat


def integrand_spd(
    matfun: Callable,
    krylov_depth: int,
    matvec: Callable,
    /,
    *,
    reortho: str = "full",
    use_adjoints_for_tridiag: bool = True,
) -> Callable:
    """Quadratic form ``|v|^2 e1^T f(T) e1`` for stochastic Lanczos quadrature.

    Returns ``quadform(v0, *params)``, differentiable through the
    tridiagonalisation adjoint and the Daleckii-Krein derivative of the
    small matrix function.
    """

    def quadform(v0, *parameters):
        flat = v0.reshape(-1)
        scale = torch.linalg.vector_norm(flat)
        factorise = tridiag(
            _flat_operator(matvec, v0.shape), krylov_depth, reortho=reortho,
            custom_vjp=use_adjoints_for_tridiag,
        )
        (_basis, (diags, offdiags)), _remainder = factorise(flat / scale, *parameters)
        return scale**2 * _QuadformTridiag.apply(matfun, diags, offdiags)

    return quadform


def _quadform_value(matfun, diags, offdiags):
    eigvals, eigvecs = _eigh_tridiag(diags, offdiags)
    fx = torch.func.vmap(matfun)(eigvals)
    u = eigvecs[0, :]
    return torch.dot(u, fx * u), (eigvals, eigvecs, fx)


class _QuadformTridiag(torch.autograd.Function):
    """``e1^T f(T) e1`` with a degeneracy-safe derivative.

    Differentiating through ``eigh`` divides eigenvector cotangents by
    eigenvalue gaps: NaN on clustered or ghost Ritz values and on the
    exactly degenerate zero block an exhausted Krylov space leaves. The
    backward pass uses the Daleckii-Krein form of the Frechet derivative
    instead: with ``T = V diag(lam) V^T`` and ``u = V[0, :]``,
    ``d/dT = V (Phi o u u^T) V^T``, ``Phi_ij = (f(lam_i) - f(lam_j)) /
    (lam_i - lam_j)`` and ``f'`` (the midpoint derivative) where the gap
    is below ``sqrt(eps)`` times the scale. Finite for any spectrum.
    """

    @staticmethod
    def forward(ctx, matfun, diags, offdiags):
        value, (eigvals, eigvecs, fx) = _quadform_value(matfun, diags, offdiags)
        ctx.matfun = matfun
        ctx.save_for_backward(eigvals, eigvecs, fx)
        return value

    @staticmethod
    def backward(ctx, cotangent):
        eigvals, eigvecs, fx = ctx.saved_tensors
        dfx = torch.func.vmap(torch.func.grad(ctx.matfun))(eigvals)
        gaps = eigvals[:, None] - eigvals[None, :]
        eps = torch.finfo(eigvals.dtype).eps
        tiny = eps**0.5 * (eigvals[:, None].abs() + eigvals[None, :].abs() + eps)
        near = gaps.abs() <= tiny
        phi = torch.where(
            near,
            0.5 * (dfx[:, None] + dfx[None, :]),
            (fx[:, None] - fx[None, :]) / torch.where(near, 1.0, gaps),
        )
        u = eigvecs[0, :]
        grad_T = eigvecs @ (phi * torch.outer(u, u)) @ eigvecs.T
        d_diags = cotangent * torch.diagonal(grad_T)
        d_offdiags = cotangent * (torch.diagonal(grad_T, 1) + torch.diagonal(grad_T, -1))
        return None, d_diags, d_offdiags


def integrand_spd_custom_vjp_reuse(
    matfun: Callable, krylov_depth: int, matvec: Callable, /, *, reortho: str = "full"
) -> Callable:
    """SLQ integrand whose VJP reuses the forward Lanczos decomposition.

    One extra operator VJP in the backward pass (Dong et al., NeurIPS
    2017 style inexact gradients); no higher derivatives. The gradient
    with respect to the probe, ``2 f(A) v0``, comes from the cached
    decomposition at no extra operator application, as in the JAX
    package.
    """

    @requires_float32
    def quadform(v0, *parameters):
        return _QuadformReuse.apply(matfun, krylov_depth, matvec, reortho, v0, *parameters)

    return quadform


class _QuadformReuse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matfun, krylov_depth, matvec, reortho, v0, *parameters):
        matvec_flat = _flat_operator(matvec, v0.shape)
        flat = v0.reshape(-1)
        scale = torch.linalg.vector_norm(flat)
        v0_unit = flat / scale
        factorise = tridiag(matvec_flat, krylov_depth, reortho=reortho, custom_vjp=False)
        (basis, (diags, offdiags)), _remainder = factorise(v0_unit, *parameters)

        value, (eigvals, eigvecs, fx) = _quadform_value(matfun, diags, offdiags)
        first = eigvecs[0, :]
        # The direction pair (w1, w2) makes the backward pass one parameter
        # VJP of w1^T A w2; f(A) v0 in the Krylov space gives the probe's.
        dfx = torch.func.vmap(torch.func.grad(matfun))(eigvals)
        w1 = scale**2 * (basis.T @ (eigvecs @ (dfx * first)))
        f_of_a_v0 = scale * (basis.T @ (eigvecs @ (fx * first)))
        ctx.matvec_flat = matvec_flat
        ctx.v0_shape = v0.shape
        ctx.save_for_backward(w1, v0_unit, f_of_a_v0, *parameters)
        return scale**2 * value

    @staticmethod
    def backward(ctx, cotangent):
        w1, w2, f_of_a_v0, *parameters = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        wanted = [i for i, need in enumerate(needs) if need]
        grads = [None] * len(parameters)
        if wanted:
            with torch.enable_grad():
                p = [x.detach().requires_grad_(i in wanted) for i, x in enumerate(parameters)]
                out = torch.dot(ctx.matvec_flat(w2, *p), w1)
                found = torch.autograd.grad(out, [p[i] for i in wanted], allow_unused=True)
            for i, g in zip(wanted, found):
                grads[i] = cotangent * (torch.zeros_like(parameters[i]) if g is None else g)
        dv0 = (cotangent * 2.0 * f_of_a_v0).reshape(ctx.v0_shape)
        return (None, None, None, None, dv0, *grads)
