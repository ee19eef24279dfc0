"""Blocked pivoted partial Cholesky and the Woodbury preconditioner.

Counterpart of ``woodbury_solve``, ``preconditioner`` and
``cholesky_partial_pivot_blocked`` in
``lanczos_adjoints_tpu/precond/low_rank.py``. The factor is built under
``torch.no_grad()``, and both the factor and the solve refuse to be
differentiated, as the JAX package's custom VJPs do: a preconditioner
must not contribute gradients.
"""

from typing import Callable

import torch


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
        with torch.no_grad():
            factor, info = _cholesky(lazy_kernel, n)
        params = getattr(lazy_kernel, "params", ())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            factor = _RefuseGrad.apply(factor, *params)
        return factor, info

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
