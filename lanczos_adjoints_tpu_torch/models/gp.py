"""Gaussian-process models with a matrix-free marginal likelihood.

Counterpart of ``lanczos_adjoints_tpu/models/gp.py``: targets (the
marginal likelihood and the posterior), model, constant mean, the
GPyTorch-parametrised scaled kernels, the Gaussian likelihoods (the
marginal pdf and the conditioned mean, each plain or preconditioned) and
the log-pdf backends (matrix-free Krylov and the dense Cholesky and
``torch.distributions`` oracles).

Everything is a closure factory returning ``(value, info)`` pairs, as in
the JAX package. The one structural difference: a kernel's raw
parameters travel explicitly. ``kernel(x, y, *params)`` defaults
``params`` to the raw tensors it was built with and exposes them as
``kernel.params``; the likelihood hands them, with ``raw_noise``, to the
log-pdf as ``cov_params``, and the covariance matvec is
``cov_matvec(v, raw_lengthscale, raw_outputscale, raw_noise)``. The
Krylov adjoints and the CG backward pass then differentiate with respect
to them, which ``jax.closure_convert`` and ``lax.custom_linear_solve``
arrange in the JAX package. Training inputs that require a gradient
travel the same way, as one more explicit parameter of ``cov_matvec``.
"""

import functools
import math
from typing import Callable

import numpy as np
import torch

# Re-exported here because the JAX package exposes them through models.gp.
from lanczos_adjoints_tpu_torch.ops.gram import (  # noqa: F401
    gram_matrix,
    gram_matvec,
    gram_matvec_fused,
    gram_matvec_partitioned,
    gram_matvec_sequential,
)

# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------


def target_logml(model: Callable, likelihood: Callable, /) -> Callable:
    """Construct a log-marginal-likelihood target."""

    def mll(
        inputs,
        targets,
        *p_logpdf,
        params_mean: dict,
        params_kernel: dict,
        params_likelihood: dict,
    ):
        mean, kernel = model(params_mean=params_mean, params_kernel=params_kernel)
        loss = likelihood(inputs, mean=mean, kernel=kernel, params=params_likelihood)
        return loss(targets, *p_logpdf)

    return mll


def target_posterior(model: Callable, likelihood: Callable, /) -> Callable:
    """Construct a posterior-predictive target.

    ``posterior(inputs, targets, params_mean, params_kernel,
    params_likelihood) -> (condition, {})`` with ``condition(xs) ->
    (posterior_mean, info)``.
    """

    def posterior(inputs, targets, params_mean: dict, params_kernel: dict, params_likelihood: dict):
        mean, kernel = model(params_mean, params_kernel)
        condition = likelihood(inputs, mean, kernel, params=params_likelihood)
        return functools.partial(condition, targets=targets), {}

    return posterior


# ---------------------------------------------------------------------------
# Model, mean, kernels
# ---------------------------------------------------------------------------


def model_gp(mean_fun: Callable, kernel_fun: Callable) -> Callable:
    """Bundle parametrised mean and kernel factories into a prior."""

    def prior(params_mean: dict, params_kernel: dict):
        return mean_fun(**params_mean), kernel_fun(**params_kernel)

    return prior


def mean_constant(*, shape_out) -> tuple:
    """Constant mean function."""

    def parametrize(*, constant_value):
        return lambda x: constant_value.expand(x.shape[:1])

    return parametrize, {"constant_value": torch.empty(shape_out)}


def constraint_greater_than(minval, /) -> Callable:
    """Softplus constraint matching GPyTorch/PyTorch semantics."""

    def softplus(x, beta=1.0, threshold=20.0):
        below = x * beta < threshold
        x_safe = torch.where(below, x, torch.ones_like(x))
        soft = 1 / beta * torch.log(1 + torch.exp(beta * x_safe))
        return torch.where(below, soft, x)

    return lambda raw: minval + softplus(raw)


def _scaled_sq_distance(x, y, lengthscale):
    """|x - y|^2 / lengthscale^2 via the expanded form, as the JAX package."""
    x = x / lengthscale
    y = y / lengthscale
    sq = (
        torch.sum(x * x, dim=-1)
        + torch.sum(y * y, dim=-1)
        - 2 * torch.sum(x * y, dim=-1)
    )
    return torch.clamp(sq, min=0.0)


def _assert_shapes(x, y, shape_in):
    if tuple(x.shape[-len(shape_in):]) != tuple(shape_in) or x.shape[-1] != y.shape[-1]:
        msg = f"Shapes {tuple(x.shape)} and {tuple(y.shape)} do not match shape_in={shape_in}"
        raise ValueError(msg)


def _scaled_kernel(kind: str, value: Callable, shape_in, shape_out) -> tuple:
    constrain = constraint_greater_than(0.0)

    def parametrize(*, raw_lengthscale, raw_outputscale):
        def k(x, y, raw_ell=raw_lengthscale, raw_out=raw_outputscale):
            _assert_shapes(x, y, shape_in)
            return constrain(raw_out) * value(x, y, constrain(raw_ell))

        k.fused_spec = (kind, constrain)
        k.params = (raw_lengthscale, raw_outputscale)
        return k

    params_like = {
        "raw_lengthscale": torch.empty(shape_in),
        "raw_outputscale": torch.empty(shape_out),
    }
    return parametrize, params_like


def kernel_scaled_matern_32(*, shape_in, shape_out) -> tuple:
    """Scaled Matern(nu=3/2); GPyTorch's ``ScaleKernel(MaternKernel(nu=1.5))``."""

    def value(x, y, lengthscale):
        sq = _scaled_sq_distance(math.sqrt(3.0) * x, math.sqrt(3.0) * y, lengthscale)
        # Epsilon-shift keeps sqrt differentiable at zero distance.
        dist = torch.sqrt(sq + torch.finfo(sq.dtype).eps)
        return (1.0 + dist) * torch.exp(-dist)

    return _scaled_kernel("matern32", value, shape_in, shape_out)


def kernel_scaled_matern_12(*, shape_in, shape_out) -> tuple:
    """Scaled Matern(nu=1/2) (exponential kernel), GPyTorch-parametrised."""

    def value(x, y, lengthscale):
        sq = _scaled_sq_distance(x, y, lengthscale)
        dist = torch.sqrt(sq + torch.finfo(sq.dtype).eps)
        return torch.exp(-dist)

    return _scaled_kernel("matern12", value, shape_in, shape_out)


def kernel_scaled_rbf(*, shape_in, shape_out) -> tuple:
    """Scaled RBF kernel, GPyTorch-parametrised."""

    def value(x, y, lengthscale):
        return torch.exp(-_scaled_sq_distance(x, y, lengthscale) / 2)

    return _scaled_kernel("rbf", value, shape_in, shape_out)


# ---------------------------------------------------------------------------
# Likelihood
# ---------------------------------------------------------------------------


class _CovarianceOp:
    """Lazy N x N kernel covariance: element access plus matvec.

    ``elem(i, j)`` evaluates ``k(x_i, x_j) (+ noise * delta_ij)`` on
    broadcastable index tensors -- the access pattern of the partial
    Cholesky -- with the kernel's own parameters; ``matvec(v, *params)``
    applies the Gram matrix through the injected policy with explicit
    kernel parameters, and ``matvec_rows(v, *params, inputs)`` with the
    inputs as one more explicit parameter, for a gradient in them.
    """

    def __init__(self, matvec, kernel, inputs, *, noise=0.0):
        self._inputs = inputs

        def elem(i, j, *params):
            val = kernel(inputs[i], inputs[j], *params)
            if isinstance(noise, (int, float)) and noise == 0.0:
                return val
            return val + noise * (i == j)

        # Propagate the fused-kernel tag through the index-based wrapper,
        # with the data it needs to resolve indices back to rows.
        spec = getattr(kernel, "fused_spec", None)
        if spec is not None:
            elem.fused_spec = spec
            elem.fused_data = (inputs, noise)
        elem.params = kernel.params
        self.elem = elem
        self._apply_gram = matvec(elem)
        self._apply_rows = matvec(kernel)

    def matvec(self, v, *params):
        idx = torch.arange(len(self._inputs), device=self._inputs.device)
        return self._apply_gram(idx, idx, v, *params)

    def matvec_rows(self, v, *params_and_inputs):
        *params, inputs = params_and_inputs
        return self._apply_rows(inputs, inputs, v, *params)

    def cross_matvec(self, xs, v, *params):
        """``K(xs, inputs) @ v``, the posterior mean's cross covariance."""
        return self._apply_rows(xs, self._inputs, v, *params)


def _noisy_matvec(cov: _CovarianceOp, constrain: Callable) -> Callable:
    """``cov_matvec(v, raw_lengthscale, raw_outputscale, raw_noise, *rows)``:
    the Gram matvec plus ``noise * v``, with the inputs as the last
    parameter where they need a gradient."""

    def cov_matvec(v, raw_lengthscale, raw_outputscale, raw_noise, *rows):
        if rows:
            gram = cov.matvec_rows(v, raw_lengthscale, raw_outputscale, *rows)
        else:
            gram = cov.matvec(v, raw_lengthscale, raw_outputscale)
        return gram + constrain(raw_noise) * v

    return cov_matvec


def _cov_params(kernel, raw_noise, inputs) -> tuple:
    """The explicit parameters of ``_noisy_matvec``'s matvec."""
    return (*kernel.params, raw_noise, *((inputs,) if inputs.requires_grad else ()))


def likelihood_pdf(matvec: Callable, logpdf: Callable, *, constrain: Callable) -> tuple:
    """Gaussian likelihood evaluating the marginal pdf through a lazy matvec."""

    def likelihood(inputs, mean: Callable, kernel: Callable, params: dict):
        cov = _CovarianceOp(matvec, kernel, inputs)

        def logpdf_partial(targets, *p_logpdf):
            return logpdf(
                targets,
                *p_logpdf,
                mean=mean(inputs),
                cov_matvec=_noisy_matvec(cov, constrain),
                cov_params=_cov_params(kernel, params["raw_noise"], inputs),
            )

        return logpdf_partial

    return likelihood, {"raw_noise": torch.empty(())}


def likelihood_pdf_p(
    matvec: Callable, logpdf_p: Callable, precondition: Callable, *, constrain: Callable
) -> tuple:
    """Gaussian likelihood with a preconditioned log-pdf backend.

    The preconditioner sees the noiseless lazy kernel (it adds the noise
    itself through the Woodbury identity) and is built without gradients;
    the log-pdf's matvec carries ``+ noise * v``. Inputs that require a
    gradient become the last of ``cov_params``, and the matvec reads its
    rows from there (``_CovarianceOp.matvec_rows``); the preconditioner
    still reads them without gradients, as ``custom_linear_solve`` never
    differentiates it in the JAX package.
    """

    def likelihood(inputs, mean: Callable, kernel: Callable, params: dict):
        raw_noise = params["raw_noise"]
        cov = _CovarianceOp(matvec, kernel, inputs)
        pre, info_pre = precondition(cov.elem, len(inputs))

        def logpdf_partial(targets, *p_logpdf):
            noise = constrain(raw_noise).detach()
            value, info = logpdf_p(
                targets,
                *p_logpdf,
                mean=mean(inputs),
                cov_matvec=_noisy_matvec(cov, constrain),
                cov_params=_cov_params(kernel, raw_noise, inputs),
                P=lambda v: pre(v, noise),
            )
            return value, {"precondition": info_pre, "logpdf": info}

        return logpdf_partial

    return likelihood, {"raw_noise": torch.empty(())}


def likelihood_condition(matvec: Callable, solve: Callable, *, constrain: Callable) -> tuple:
    """Gaussian likelihood returning the conditioned (posterior) mean.

    ``condition(xs, targets) -> (posterior_mean, {"solve": info})``, with
    ``solve(cov_matvec, rhs, *cov_params)`` (``solvers.cg``).
    """
    return _likelihood_condition(matvec, solve, None, constrain)


def likelihood_condition_p(
    matvec: Callable, solve_p: Callable, *, precondition: Callable, constrain: Callable
) -> tuple:
    """Conditioned mean through a preconditioned solver (``P=...``).

    The preconditioner sees the noiseless lazy kernel, as in
    ``likelihood_pdf_p``.
    """
    return _likelihood_condition(matvec, solve_p, precondition, constrain)


def _likelihood_condition(matvec, solve, precondition, constrain) -> tuple:
    """``likelihood_condition[_p]``: ``precondition=None`` calls ``solve`` without ``P``."""

    def likelihood(inputs, mean: Callable, kernel: Callable, params: dict):
        raw_noise = params["raw_noise"]
        cov = _CovarianceOp(matvec, kernel, inputs)
        pre = None if precondition is None else precondition(cov.elem, len(inputs))[0]

        def condition_partial(xs, targets):
            kwargs = {}
            if pre is not None:
                noise = constrain(raw_noise).detach()
                kwargs["P"] = lambda v: pre(v, noise)
            weights, info = solve(
                _noisy_matvec(cov, constrain), targets - mean(inputs),
                *_cov_params(kernel, raw_noise, inputs), **kwargs,
            )
            posterior_mean = mean(xs) + cov.cross_matvec(xs, weights, *kernel.params)
            return posterior_mean, {"solve": info}

        return condition_partial

    return likelihood, {"raw_noise": torch.empty(())}


# ---------------------------------------------------------------------------
# Log-pdf backends: log N(y | mu, K) = -logdet(K)/2 - (y-mu)^T K^{-1} (y-mu)/2
# - n/2 log(2 pi), differing only in how the logdet and the solve are made.
# ---------------------------------------------------------------------------


def _gaussian_logpdf(residual, half_logdet, mahalanobis):
    (n,) = residual.shape
    return -half_logdet - 0.5 * mahalanobis - n / 2 * math.log(2 * math.pi)


def _materialize(cov_matvec: Callable, like, cov_params=()):
    """Dense covariance from a matvec: ``cov_matvec`` on the identity (small n only)."""
    return cov_matvec(torch.eye(len(like), dtype=like.dtype, device=like.device), *cov_params)


def logpdf_scipy_stats() -> Callable:
    """Materialise the covariance and take ``torch.distributions.MultivariateNormal``'s
    log-density (the JAX package calls ``jax.scipy.stats``; the name is kept)."""

    def logpdf(y, /, *, mean, cov_matvec: Callable, cov_params=()):
        cov_matrix = _materialize(cov_matvec, mean, cov_params)
        normal = torch.distributions.MultivariateNormal(mean, covariance_matrix=cov_matrix)
        return normal.log_prob(y), {}

    return logpdf


def logpdf_cholesky() -> Callable:
    """Materialise the covariance and factor it."""

    def logpdf(y, /, *_p_logdet, mean, cov_matvec: Callable, cov_params=(), **_kw):
        chol = torch.linalg.cholesky(_materialize(cov_matvec, y, cov_params))
        white = torch.linalg.solve_triangular(chol, (y - mean)[:, None], upper=False)[:, 0]
        value = _gaussian_logpdf(
            y - mean,
            half_logdet=torch.sum(torch.log(torch.diagonal(chol))),
            mahalanobis=torch.dot(white, white),
        )
        return value, {}

    return logpdf


def _logpdf_matrix_free(logdet: Callable, run_solve: Callable) -> Callable:
    """SLQ logdet + CG Mahalanobis.

    ``logdet(cov_matvec, *params_logdet, *cov_params)`` and
    ``run_solve(cov_matvec, rhs, *cov_params, **solve_kwargs)``.
    """

    def logpdf(y, *params_logdet, mean, cov_matvec: Callable, cov_params=(), **solve_kwargs):
        logdet_, info_logdet = logdet(cov_matvec, *params_logdet, *cov_params)
        residual = y - mean
        solution, info_solve = run_solve(cov_matvec, residual, *cov_params, **solve_kwargs)
        value = _gaussian_logpdf(
            residual,
            half_logdet=logdet_ / 2,
            mahalanobis=torch.dot(residual, solution),
        )
        return value, {"logdet": info_logdet, "solve": info_solve}

    return logpdf


def logpdf_krylov(solve: Callable, logdet: Callable) -> Callable:
    """Matrix-free log-pdf: SLQ logdet + CG Mahalanobis (``solvers.cg``)."""
    return _logpdf_matrix_free(logdet, solve)


def logpdf_krylov_p(solve_p: Callable, logdet: Callable) -> Callable:
    """Matrix-free log-pdf with a preconditioned Mahalanobis solve (``P=...``)."""
    return _logpdf_matrix_free(logdet, solve_p)


# ---------------------------------------------------------------------------
# Parameters: the JAX package's dicts and its flat optimiser vector
# ---------------------------------------------------------------------------


def params_from_jax(p_mean: dict, p_kernel: dict, p_likelihood: dict, *, device="cuda"):
    """The JAX package's parameter dicts (numpy arrays) as the port's (float32 tensors)."""

    def convert(tree):
        return {
            k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in tree.items()
        }

    return convert(p_mean), convert(p_kernel), convert(p_likelihood)


def flatten_params(p_mean: dict, p_kernel: dict, p_likelihood: dict):
    """The flat vector of ``jax.flatten_util.ravel_pytree((p_mean, p_kernel, p_likelihood))``.

    Layout: ``constant_value``, ``raw_lengthscale[d]``, ``raw_outputscale``,
    ``raw_noise`` (dict keys in sorted order, as JAX flattens them).
    """
    leaves = [
        tree[k].reshape(-1)
        for tree in (p_mean, p_kernel, p_likelihood)
        for k in sorted(tree)
    ]
    return torch.cat(leaves)


def unflatten_params(flat, ndim: int):
    """Inverse of ``flatten_params`` for a GP on ``(ndim,)`` inputs (views of ``flat``)."""
    return (
        {"constant_value": flat[0]},
        {"raw_lengthscale": flat[1 : 1 + ndim], "raw_outputscale": flat[1 + ndim]},
        {"raw_noise": flat[2 + ndim]},
    )
