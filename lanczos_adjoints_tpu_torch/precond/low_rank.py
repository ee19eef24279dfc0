"""Partial Cholesky (plain, pivoted, pivoted in blocks) and the Woodbury preconditioner.

Counterpart of ``woodbury_solve``, ``preconditioner``, ``cholesky_partial``,
``cholesky_partial_pivot`` and ``cholesky_partial_pivot_blocked`` in
``lanczos_adjoints_tpu/precond/low_rank.py``. The factor is built under
``torch.no_grad()``, and both the factor and the solve refuse to be
differentiated, as the JAX package's custom VJPs do: a preconditioner
must not contribute gradients.
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.utils import spans


class _WoodburySolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chol, v, s):
        rank = chol.shape[1]
        scaled = chol / torch.sqrt(s)
        v_scaled = v / s
        capacitance = torch.eye(rank, dtype=chol.dtype, device=chol.device) + scaled.T @ scaled
        factor = torch.linalg.cholesky(capacitance)
        rhs = scaled.T @ v_scaled
        correction = torch.cholesky_solve(rhs.reshape(rank, -1), factor).reshape(rhs.shape)
        return v_scaled - scaled @ correction

    @staticmethod
    def backward(ctx, *_cotangents):
        msg = "Preconditioners must not be differentiated through."
        raise RuntimeError(msg)


def woodbury_solve(chol, v, s):
    """``(s*I + L L^T)^{-1} v`` from a partial factor ``L`` (n, rank).

    Refuses to be differentiated, like the closure built by
    :func:`preconditioner`.
    """
    s = torch.as_tensor(s, dtype=chol.dtype, device=chol.device)
    return _WoodburySolve.apply(chol, v, s)


def preconditioner(cholesky: Callable, /) -> Callable:
    """Turn a partial Cholesky routine into a Woodbury solver factory.

    ``solve(v, s) ~= (s*I + L L^T)^{-1} v``; ``s`` is the noise/shift.
    """

    @spans.spanned("precond.cholesky")
    def precondition(lazy_kernel: Callable, nrows: int, /):
        chol, info = cholesky(lazy_kernel, nrows)
        n_full, rank = chol.shape
        if rank > n_full:
            msg = f"rank {rank} exceeds the {n_full} rows"
            raise ValueError(msg)

        def solve(v, s):
            return woodbury_solve(chol, v, s)

        return solve, info

    return precondition


class _RefuseGrad(torch.autograd.Function):
    """Identity on a factor; raises if a gradient ever reaches it."""

    @staticmethod
    def forward(ctx, factor, *_params):
        return factor.clone()

    @staticmethod
    def backward(ctx, *_cotangents):
        msg = "Partial Cholesky factorisations must not be differentiated through."
        raise RuntimeError(msg)


def _refusing_grad(cholesky_fn, lazy_kernel, n):
    """Run a factorisation without gradients; a gradient reaching it raises."""
    with torch.no_grad():
        factor, info = cholesky_fn(lazy_kernel, n)
    params = getattr(lazy_kernel, "params", ())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        factor = _RefuseGrad.apply(factor, *params)
    return factor, info


def cholesky_partial(*, rank: int) -> Callable:
    """Rank-``rank`` partial Cholesky of a lazily indexed matrix, without pivoting:
    column ``i`` is the Schur complement's column ``i``, over the root of its diagonal."""

    def cholesky(lazy_kernel: Callable, n: int, /):
        _check_rank(rank, n)
        return _refusing_grad(_cholesky, lazy_kernel, n)

    def _cholesky(element: Callable, n: int):
        all_idx = torch.arange(n)
        L = None
        for i in range(rank):
            col = element(all_idx, torch.tensor(i))
            if L is None:
                L = torch.zeros((n, rank), dtype=col.dtype, device=col.device)
            pivot = torch.sqrt(col[i] - torch.dot(L[i], L[i]))
            L[:, i] = (col - L @ L[i, :]) / pivot
        return L, {}

    return cholesky


def cholesky_partial_pivot(*, rank: int) -> Callable:
    """Partial Cholesky with greedy diagonal pivoting, one column a step.

    Each step pivots to the largest residual diagonal entry of the
    active (not yet pivoted) rows and evaluates one kernel column; the
    residual diagonal is tracked, not recomputed. Below the pivot
    threshold ``n * eps * max(diag)`` the remaining columns are zero and
    ``info["success"]`` is False. The rows come back in the original
    order.
    """

    def cholesky(lazy_kernel: Callable, n: int, /):
        _check_rank(rank, n)
        return _refusing_grad(_cholesky, lazy_kernel, n)

    def _cholesky(element: Callable, n: int):
        diag0 = element(torch.arange(n), torch.arange(n))
        all_idx = torch.arange(n, device=diag0.device)
        L = torch.zeros((n, rank), dtype=diag0.dtype, device=diag0.device)
        perm, matrix_perm = all_idx.clone(), all_idx.clone()
        residual_diag = diag0.clone()
        tol = n * torch.finfo(diag0.dtype).eps * torch.max(diag0)
        success = torch.tensor(True, device=diag0.device)
        for i in range(rank):
            k = torch.argmax(torch.where(all_idx >= i, residual_diag, -torch.inf))
            pair = torch.stack([all_idx[i], k])
            for arr in (matrix_perm, L, perm, residual_diag):
                arr[pair] = arr[pair.flip(0)]
            pivot_sq = residual_diag[i]
            safe = pivot_sq > tol
            pivot = torch.sqrt(torch.where(safe, pivot_sq, 1.0))
            col = element(matrix_perm, matrix_perm[i]) - L @ L[i, :]
            col = torch.where(safe, col / pivot, 0.0)
            success = success & safe
            residual_diag = torch.clamp(residual_diag - col**2, min=0.0)
            L[:, i] = col
        return L[torch.argsort(perm)], {"success": success}

    return cholesky


def _top_k(values, k):
    """Indices of the ``k`` largest values, lower index first among ties
    (the order of ``jax.lax.top_k``)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def cholesky_partial_pivot_blocked(*, rank: int, block: int = 64) -> Callable:
    """Partial Cholesky with block-greedy diagonal pivoting.

    Each sweep selects the ``block`` largest residual-diagonal entries,
    evaluates that kernel panel at once and applies the Schur-complement
    update as ``(n, rank) @ (rank, block)`` matmuls. A duplicate data
    point makes the pivot block exactly singular, so the update factors
    through ``eigh`` and drops the deficient directions.

    ``cholesky(lazy_kernel, n) -> (L, {"success": ...})``, with
    ``lazy_kernel(i, j)`` evaluating kernel entries on broadcastable
    index tensors.
    """
    if rank % block != 0:
        msg = f"rank={rank} must be a multiple of block={block}"
        raise ValueError(msg)

    def cholesky(lazy_kernel: Callable, n: int, /):
        _check_rank(rank, n)
        if block > n:
            msg = f"block={block} exceeds n={n}"
            raise ValueError(msg)
        return _refusing_grad(_cholesky, lazy_kernel, n)

    def _cholesky(element: Callable, n: int):
        diag0 = element(torch.arange(n), torch.arange(n))
        all_idx = torch.arange(n, device=diag0.device)
        L = torch.zeros((n, rank), dtype=diag0.dtype, device=diag0.device)
        residual_diag = diag0.clone()
        success = torch.tensor(True, device=diag0.device)
        for s in range(rank // block):
            piv = _top_k(torch.abs(residual_diag), block)
            C = element(all_idx[:, None], piv[None, :]) - L @ L[piv, :].T
            S = C[piv, :]
            S = 0.5 * (S + S.T)
            w, Q = torch.linalg.eigh(S)
            tol = block * torch.finfo(w.dtype).eps * torch.max(torch.abs(w))
            inv_sqrt = torch.where(
                w > tol, 1.0 / torch.sqrt(torch.clamp(w, min=tol)), torch.zeros_like(w)
            )
            W = (C @ Q) * inv_sqrt
            success = success & (torch.min(w) > -tol)
            L[:, s * block : (s + 1) * block] = W
            residual_diag = residual_diag - torch.sum(W * W, dim=1)
        return L, {"success": success}

    return cholesky


def _check_rank(rank: int, n: int):
    if rank > n:
        msg = f"Rank exceeds n: {rank} >= {n}."
        raise ValueError(msg)
    if rank < 1:
        msg = f"Rank must be positive, but {rank} < {1}."
        raise ValueError(msg)
