"""Stochastic Lanczos quadrature log-determinants.

Counterpart of ``lanczos_adjoints_tpu/trace/slq.py`` for the blocked mode
of the GP training step: all probes' Lanczos recurrences run together,
one multi-RHS operator application per step, differentiated through the
closed-form blocked adjoint (``krylov.lanczos.tridiag_block``).
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.krylov import lanczos


def log_clipped(*, clip_value: float = 1.0) -> Callable:
    """log with tiny/negative Ritz values clipped (f32 SLQ robustness).

    Negative Ritz values appear when the operator is numerically singular
    in float32; a plain log turns the whole estimate into NaN.
    """

    def log(x):
        eps = torch.finfo(x.dtype).eps
        return torch.log(torch.where(x < eps, clip_value, x))

    return log


def krylov_logdet_slq(
    krylov_depth: int,
    /,
    *,
    sample: Callable,
    num_batches: int,
    checkpoint: bool,
    matfun: Callable = torch.log,
    blocked: bool = False,
) -> Callable:
    """SLQ estimator of ``logdet(A)``, differentiable through Lanczos adjoints.

    Returns ``logdet(matvec, key, *params) -> (value, info)`` with
    ``matvec(V, *params)`` applying the operator to an ``(n, m)`` block
    and ``sample(key)`` returning ``(m, n)`` probes. ``checkpoint`` is
    accepted for the JAX signature and has no effect: the blocked adjoint
    stores only the Krylov basis either way.

    Only ``blocked=True`` with ``num_batches=1`` is ported so far.
    """
    if not blocked:
        msg = (
            "per-probe SLQ (blocked=False) needs krylov/arnoldi.py, which a "
            "later slice of the port brings; use blocked=True"
        )
        raise NotImplementedError(msg)
    if num_batches != 1:
        msg = "only num_batches=1 is ported so far"
        raise NotImplementedError(msg)
    del checkpoint

    def logdet(matvec: Callable, /, key, *params):
        integrand_b = lanczos.integrand_spd_block(matfun, krylov_depth, matvec)
        samples = sample(key)
        flat = samples.reshape(samples.shape[0], -1)
        value = torch.mean(integrand_b(flat.T, *params))
        return value, {"std_abs": 0.0, "std_rel": 0.0}

    return logdet
