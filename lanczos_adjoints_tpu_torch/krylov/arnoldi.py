"""Arnoldi Hessenberg factorisation with a closed-form reverse-mode adjoint.

Counterpart of ``lanczos_adjoints_tpu/krylov/arnoldi.py``:

- ``_forward``: the K-step recurrence with classical Gram-Schmidt,
  applied twice with a DGKS truncation for ``reortho="full"``, and the
  alive-masked normalisation after an exhausted Krylov space. ``H``
  keeps the first-pass coefficients; the subdiagonal entry of the last
  step is dropped. Complex operators are taken (the projections
  conjugate).
- ``_adjoint``: the backward substitution on ``H`` of arXiv:2405.17277,
  one transposed operator application and one parameter-gradient
  increment per step, re-projected against the basis for
  ``reortho="full"``. The per-step ``jax.vjp`` of the JAX package
  becomes a ``vjp(q, lam) -> (A^T lam, [d/dp <lam, A(p) q>])`` callable:
  one autograd call through ``matvec`` in the generic route, the DIA
  Function's two backward kernels in the fused one
  (``ops.fused_arnoldi``).
- ``hessenberg``: the entry point, with ``custom_vjp=False`` (backprop
  through the loop) as the oracle, and the dispatch of DIA operators on
  the card to the fused forward K9.

``params`` must be explicit tensors: a ``torch.autograd.Function`` gives
no gradient to tensors that a closure captures (the JAX package lifts
them with ``jax.closure_convert``).
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.ops import native
from lanczos_adjoints_tpu_torch.utils.precision import requires_float32

OPTIONS = ("none", "full")


def check_option(value, options=OPTIONS):
    """The JAX package's error for an unexpected ``reortho``/``reortho_vjp``."""
    if value not in options:
        msg = f"Unexpected input for {value}: either of {list(options)} expected."
        raise TypeError(msg)


def _safe_norm(w):
    """2-norm whose backprop is zero (not NaN) at an exactly-zero vector.

    Happy-breakdown truncation leaves exact zeros; ``sqrt`` has an
    infinite derivative at 0 and ``0 * inf`` poisons the backprop oracle.
    """
    sq = torch.dot(w.conj(), w)
    alive = sq.real > 0.0
    return torch.where(alive, torch.sqrt(torch.where(alive, sq, 1.0)), torch.zeros_like(sq))


def hessenberg(
    matvec: Callable,
    krylov_depth: int,
    /,
    *,
    reortho: str,
    custom_vjp: bool = True,
    reortho_vjp: str = "match",
    allow_fused: bool = True,
    dispatch_log: list | None = None,
) -> Callable:
    """Construct an Arnoldi factorisation ``A Q = Q H + r e_k^T``.

    Returns ``estimate(v, *params) -> (Q, H, residual, 1/|v|)`` with ``Q``
    of shape ``(n, krylov_depth)`` and ``H`` upper Hessenberg of shape
    ``(krylov_depth, krylov_depth)``. ``reortho`` controls the forward
    pass, ``reortho_vjp`` (default ``"match"``) may override the
    adjoint's re-projection. ``custom_vjp=False`` backpropagates through
    the loop instead (the oracle).

    An operator tagged ``.dia_data`` (``ops.sparse``) runs the fused
    forward K9 on the card for any ``(v (n,), values (D, n))`` call, with
    the closed-form adjoint over the DIA kernels; ``allow_fused=False``
    keeps the generic loop. ``dispatch_log``, if a list, gets one event
    per call: ``"hessenberg:dia_fused"`` or ``"hessenberg:generic"``
    (the JAX package's ``"hessenberg:pallas_dia_fused"`` and
    ``"hessenberg:xla_loop"``).
    """
    check_option(reortho)
    check_option(reortho_vjp, (*OPTIONS, "match"))
    reortho_adjoint = reortho if reortho_vjp == "match" else reortho_vjp

    @requires_float32
    def estimate(v, *params):
        if custom_vjp:
            return _Hessenberg.apply(matvec, krylov_depth, reortho, reortho_adjoint, v, *params)
        return _forward(matvec, krylov_depth, v, *params, reortho=reortho)

    dia = getattr(matvec, "dia_data", None)
    if allow_fused and custom_vjp and dia is not None:
        return _hessenberg_dispatch_dia(
            estimate, dia, krylov_depth, reortho=reortho, reortho_vjp=reortho_vjp,
            dispatch_log=dispatch_log,
        )
    if dispatch_log is None:
        return estimate

    def logged(v, *params):
        dispatch_log.append("hessenberg:generic")
        return estimate(v, *params)

    return logged


def _hessenberg_dispatch_dia(plain, dia, krylov_depth, *, reortho, reortho_vjp, dispatch_log=None):
    """Route DIA-tagged operators on the card to the fused forward K9.

    Any ``(vec (n,), values (D, n))`` call on the card goes to K9 for any
    n and any ``1 <= K <= n``: the basis lives in device memory, so the
    JAX package's TPU limits (``n % 128``, a VMEM budget, a depth cap) do
    not apply. A dtype K9 does not take raises there. Other calls, and
    calls off the card, run the generic loop.
    """

    @requires_float32
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
            from lanczos_adjoints_tpu_torch.ops import fused_arnoldi

            if dispatch_log is not None:
                dispatch_log.append("hessenberg:dia_fused")
            fused = fused_arnoldi.hessenberg_dia_fused(
                dia, krylov_depth, reortho=reortho, reortho_vjp=reortho_vjp, check_tiling=False
            )
            return fused(vec, params[0])
        if dispatch_log is not None:
            dispatch_log.append("hessenberg:generic")
        return plain(vec, *params)

    return estimate


class _Hessenberg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, krylov_depth, reortho, reortho_adjoint, v, *params):
        Q, H, res, inv_norm = _forward(matvec, krylov_depth, v, *params, reortho=reortho)
        ctx.matvec = matvec
        ctx.reortho_adjoint = reortho_adjoint
        ctx.save_for_backward(Q, H, res, inv_norm, *params)
        return Q, H, res, inv_norm

    @staticmethod
    def backward(ctx, dQ, dH, dres, dinv_norm):
        Q, H, res, inv_norm, *params = ctx.saved_tensors
        vjp = _matvec_vjp(ctx.matvec, params, ctx.needs_input_grad[5:])
        dv, dparams = _adjoint(
            vjp, Q=Q, H=H, res=res, inv_norm=inv_norm, dQ=dQ, dH=dH, dres=dres,
            dinv_norm=dinv_norm, reortho=ctx.reortho_adjoint,
        )
        return (None, None, None, None, dv, *dparams)


def _matvec_vjp(matvec, params, needs):
    """``vjp(q, lam) -> (A^T lam, [d/dp_i <lam, A(p) q>])`` through autograd.

    One operator application with its vector-Jacobian product per call;
    the parameter gradients are None where ``needs`` is False.
    """
    wanted = [i for i, need in enumerate(needs) if need]

    def vjp(q, lam):
        with torch.enable_grad():
            u = q.detach().requires_grad_()
            p = [x.detach().requires_grad_(i in wanted) for i, x in enumerate(params)]
            out = matvec(u, *p)
            found = torch.autograd.grad(
                out, [u, *(p[i] for i in wanted)], lam, allow_unused=True
            )
        incs = [None] * len(params)
        for i, g in zip(wanted, found[1:]):
            incs[i] = torch.zeros_like(params[i]) if g is None else g
        at_lam = torch.zeros_like(lam) if found[0] is None else found[0]
        return at_lam, incs

    return vjp


def _forward(matvec, krylov_depth, v, *params, reortho: str):
    if krylov_depth < 1 or krylov_depth > len(v):
        msg = f"Parameter depth {krylov_depth} is outside the expected range"
        raise ValueError(msg)

    k = krylov_depth
    norm0 = torch.sqrt(torch.dot(v.conj(), v))
    columns, h_columns = [], []
    w, norm = v, norm0
    for idx in range(k):
        # Happy-breakdown-safe normalisation: once an earlier step
        # truncated (norm == 0), every later column stays exactly zero.
        alive = torch.abs(norm) > 0.0
        q = torch.where(alive, w / torch.where(alive, norm, 1.0), torch.zeros_like(w))
        columns.append(q)
        basis = torch.stack(columns, dim=1)  # (n, idx + 1): the columns written so far

        w = matvec(q, *params)
        # Classical Gram-Schmidt against the basis so far, optionally twice.
        coeffs = basis.conj().T @ w
        w = w - basis @ coeffs
        if reortho == "full":
            norm_pass1 = _safe_norm(w)
            w = w - basis @ (basis.conj().T @ w)
            norm = _safe_norm(w)
            # DGKS "twice is enough": if the second pass removed more
            # than half of what remained, the residual is rounding noise
            # (the Krylov space is exhausted at this precision); truncate
            # with an exact zero instead of normalising the noise.
            exhausted = torch.abs(norm) <= 0.5 * torch.abs(norm_pass1)
            norm = torch.where(exhausted, torch.zeros_like(norm), norm)
            w = torch.where(exhausted, torch.zeros_like(w), w)
        else:
            norm = _safe_norm(w)

        # Column idx of H: the first-pass coefficients, then the
        # subdiagonal entry, which the last step drops.
        tail = [norm[None]] if idx + 1 < k else []
        pad = torch.zeros(k - idx - 1 - len(tail), dtype=coeffs.dtype, device=coeffs.device)
        h_columns.append(torch.cat([coeffs, *tail, pad]))

    Q = torch.stack(columns, dim=1)
    H = torch.stack(h_columns, dim=1)
    return Q, H, w, 1.0 / norm0


def _adjoint(vjp, *, Q, H, res, inv_norm, dQ, dH, dres, dinv_norm, reortho: str):
    """Backward substitution on H, the Krylov steps in reverse.

    Solves the adjoint system of arXiv:2405.17277 for the Arnoldi
    recurrence. Per step: one ``vjp(q_idx, lam)`` (the transposed
    operator and the parameter-gradient increment) and O(nk) projections.
    The masked projections of the JAX package run on the active rows
    only (the masked ones contribute exact zeros). Returns
    ``(dv, [dparams])``.
    """
    k = Q.shape[1]
    dtype, device = H.dtype, H.device
    P = Q.T  # (k, n): basis rows
    eye = torch.eye(k, dtype=dtype, device=device)
    e1, ek = eye[0], eye[-1]

    # Strictly-lower-plus-half-diagonal mask that symmetrises the Gramian adjoint.
    half_lower = torch.tril(torch.ones((k, k), dtype=dtype, device=device)) - 0.5 * eye

    # The initial adjoint direction from the residual and H cotangents.
    eta = dH @ ek - Q.T @ dres
    lam = dres + Q @ eta

    c = inv_norm  # the forward returns 1/|v|; dinv_norm is its cotangent
    Xi_rows = dQ.T + torch.outer(eta, res)  # (k, n)
    Gamma_rows = -dinv_norm * c * torch.outer(e1, e1) + H @ dH.T - dQ.T @ Q  # (k, k)

    # Sub-/diagonal decomposition of H for the three-term backward relation.
    subdiag = torch.diagonal(H, -1)
    beta_lower = torch.cat([torch.ones(1, dtype=dtype, device=device), subdiag])
    alphas = torch.diagonal(H)
    beta_upper = torch.triu(H, 1)
    dHT = dH.T

    Lambda = torch.zeros_like(P)  # rows: the adjoint vectors
    Sigma = torch.zeros((k, k), dtype=dtype, device=device)
    dparams = None
    for idx in reversed(range(k)):
        if reortho == "full":
            # Project the adjoint vector onto the orthogonal complement of
            # the active basis rows (j <= idx + 1), then add the components
            # the masked dH row prescribes.
            active = P[: idx + 2]
            lam = lam - active.T @ (active @ lam - dHT[idx, : idx + 2])

        at_lam, incs = vjp(P[idx], lam)
        dparams = incs if dparams is None else [
            a if b is None else a + b for a, b in zip(dparams, incs)
        ]

        # The symmetrised Gramian adjoint row.
        Sigma[idx] = half_lower[idx] * (Gamma_rows[idx] - at_lam @ Q)

        # Backward substitution for the next adjoint vector.
        Lambda[idx] = lam
        xi = Xi_rows[idx] + (Sigma[idx] + Sigma[:, idx]) @ P
        lam_next = xi - (alphas[idx] * lam - at_lam) - beta_upper[idx] @ Lambda
        # Happy-breakdown guard (as the forward's truncation): a zero
        # subdiagonal decouples the trailing block, whose adjoint vector
        # is zero, not xi / 0.
        beta = beta_lower[idx]
        alive = torch.abs(beta) > 0.0
        lam = torch.where(
            alive, lam_next / torch.where(alive, beta, 1.0), torch.zeros_like(lam_next)
        )

    return lam * c, dparams
