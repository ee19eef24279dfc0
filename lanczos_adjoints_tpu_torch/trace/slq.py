"""Stochastic Lanczos quadrature log-determinants.

Counterpart of ``lanczos_adjoints_tpu/trace/slq.py``: Hutchinson over
SLQ integrands, per probe (``krylov.lanczos.integrand_spd``, by default
through the re-orthogonalised Lanczos of ``krylov.arnoldi``: K9 for a DIA
operator on the card) or blocked (all probes' recurrences together, one
multi-RHS operator application per step, ``tridiag_block``), with
sequential batches and the std diagnostics in the info dict.

``logdet(matvec, key, *params)`` takes the operator's parameters
explicitly (the JAX package lets ``matvec`` close over them); ``key`` is
the ``torch.Generator`` that ``sample`` draws from, and each batch draws
the next probes from it. ``checkpoint`` is accepted for the JAX signature
and has no effect: the closed-form adjoints store only the Krylov bases.
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.krylov import lanczos
from lanczos_adjoints_tpu_torch.trace.hutchinson import hutchinson


def log_clipped(*, clip_value: float = 1.0) -> Callable:
    """log with tiny/negative Ritz values clipped (f32 SLQ robustness).

    Negative Ritz values appear when the operator is numerically singular
    in float32; a plain log turns the whole estimate into NaN.
    """

    def log(x):
        eps = torch.finfo(x.dtype).eps
        return torch.log(torch.where(x < eps, clip_value, x))

    return log


def _batches(estimate, key, params, num_batches):
    """Mean and population std of ``num_batches`` sequential estimates."""
    values = torch.stack([estimate(key, *params) for _ in range(num_batches)])
    return torch.mean(values, dim=0), torch.std(values, dim=0, correction=0)


def krylov_logdet_slq(
    krylov_depth: int,
    /,
    *,
    sample: Callable,
    num_batches: int,
    checkpoint: bool,
    matfun: Callable = torch.log,
    blocked: bool = False,
    probe_sharding=None,
) -> Callable:
    """SLQ estimator of ``logdet(A)``, differentiable through Lanczos adjoints.

    Returns ``logdet(matvec, key, *params) -> (value, info)``.
    ``sample(key)`` returns ``(m, n)`` probes. Per probe
    (``blocked=False``) ``matvec(v, *params)`` takes one vector; blocked,
    it applies the operator to an ``(n, m)`` block. ``probe_sharding``
    (``parallel.NamedSharding`` over a mesh's ``"probes"`` axis) splits
    the per-probe mode's probes over that axis (``trace.hutchinson``);
    the blocked mode keeps its probes together and ignores it, as the
    JAX package does.
    """
    del checkpoint

    def logdet(matvec: Callable, /, key, *params):
        if blocked:
            integrand_b = lanczos.integrand_spd_block(matfun, krylov_depth, matvec)

            def estimate(k, *p):
                samples = sample(k)
                flat = samples.reshape(samples.shape[0], -1)
                return torch.mean(integrand_b(flat.T, *p))

        else:
            estimate = hutchinson(
                lanczos.integrand_spd(matfun, krylov_depth, matvec), sample,
                probe_sharding=probe_sharding,
            )

        if num_batches == 1:
            return estimate(key, *params), {"std_abs": 0.0, "std_rel": 0.0}
        mean, std = _batches(estimate, key, params, num_batches)
        return mean, {"std_abs": std, "std_rel": std / torch.abs(mean)}

    return logdet


def krylov_logdet_slq_vjp_reuse(
    krylov_depth: int, /, *, sample: Callable, num_batches: int, checkpoint: bool
) -> Callable:
    """SLQ logdet with the cheap decomposition-reusing (inexact) VJP.

    Recycles the forward Lanczos decomposition for the gradient (one
    extra operator VJP) instead of running the exact adjoint, Dong et
    al., NeurIPS 2017 style.
    """
    del checkpoint

    def logdet(matvec: Callable, /, key, *params):
        integrand = lanczos.integrand_spd_custom_vjp_reuse(torch.log, krylov_depth, matvec)
        mean, std = _batches(hutchinson(integrand, sample), key, params, num_batches)
        return mean, {"std": std}

    return logdet
