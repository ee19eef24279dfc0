"""Hutchinson probes and estimators.

Counterpart of ``lanczos_adjoints_tpu/trace/hutchinson.py``. A JAX key
becomes a ``torch.Generator``: the two give different draws for the same
seed, so tests hand both packages the same numpy probes through a custom
``sample`` callable instead. JAX's ``vmap`` over the probes becomes a
loop over them, and ``jax.random.split`` a generator that advances from
one batch to the next.
"""

from typing import Callable

import torch


def sampler_rademacher(x_like, /, *, num: int) -> Callable:
    """``sample(generator)`` -> ``num`` Rademacher (+-1) probes shaped like ``x_like``.

    The draw happens on the generator's device; the probes land on
    ``x_like``'s device and dtype.
    """

    def sample(generator: torch.Generator):
        bits = torch.randint(
            0, 2, (num, *x_like.shape), generator=generator, device=generator.device
        )
        return (2 * bits - 1).to(dtype=x_like.dtype, device=x_like.device)

    return sample


def sampler_normal(x_like, /, *, num: int) -> Callable:
    """``sample(generator)`` -> ``num`` standard-normal probes shaped like ``x_like``."""

    def sample(generator: torch.Generator):
        probes = torch.randn((num, *x_like.shape), generator=generator, device=generator.device)
        return probes.to(dtype=x_like.dtype, device=x_like.device)

    return sample


def _mean(values):
    """The mean over a list of results: tensors, or tuples of them."""
    if isinstance(values[0], torch.Tensor):
        return torch.mean(torch.stack(values), dim=0)
    return tuple(_mean(list(group)) for group in zip(*values))


def _probe_groups(samples, probe_sharding):
    """The probes split into the sharding's groups, in partition order."""
    if probe_sharding is None:
        return [samples]
    groups = probe_sharding.size
    if samples.shape[0] % groups != 0:
        msg = f"{samples.shape[0]} probes must divide evenly over {groups} probe partitions"
        raise ValueError(msg)
    return list(samples.chunk(groups))


def hutchinson(integrand_fun: Callable, /, sample_fun: Callable, *, probe_sharding=None) -> Callable:
    """Monte-Carlo mean of ``integrand_fun(v, *params)`` over sampled probes.

    Returns ``estimate(key, *params)``. ``probe_sharding``
    (``parallel.NamedSharding`` over a mesh's ``"probes"`` axis) splits
    the probes into that axis's groups, which are evaluated in partition
    order; the mean is taken over all probes in their one fixed order,
    so the estimate is the unsharded one.
    """

    def estimate(key, *parameters):
        groups = _probe_groups(sample_fun(key), probe_sharding)
        return _mean([integrand_fun(v, *parameters) for group in groups for v in group])

    return estimate


def hutchinson_nograd(integrand_fun: Callable, /, sample_fun: Callable) -> Callable:
    """Hutchinson estimator with gradients stopped through the samples."""

    def estimate(key, *parameters):
        samples = sample_fun(key).detach()
        return _mean([integrand_fun(v, *parameters) for v in samples])

    return estimate


def hutchinson_custom_vjp(integrand_fun: Callable, /, sample_fun: Callable) -> Callable:
    """Hutchinson estimator whose backward pass re-samples with a fresh generator.

    The forward estimate and the gradient estimate are decorrelated; the
    gradient is still unbiased. As in the JAX package it is evaluable
    only under differentiation: with no parameter that requires a
    gradient it raises. The backward generator is seeded from ``key``
    before the forward pass draws from it.
    """

    def estimate(key, *parameters):
        if not (torch.is_grad_enabled() and any(p.requires_grad for p in parameters)):
            msg = "hutchinson_custom_vjp is only evaluable inside a VJP"
            raise RuntimeError(msg)
        seed = int(torch.randint(0, 2**62, (), generator=key, device=key.device))
        return _HutchinsonFreshBackward.apply(integrand_fun, sample_fun, key, seed, *parameters)

    return estimate


class _HutchinsonFreshBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, integrand_fun, sample_fun, key, seed, *parameters):
        ctx.integrand_fun, ctx.sample_fun = integrand_fun, sample_fun
        ctx.key_device, ctx.seed = key.device, seed
        ctx.save_for_backward(*parameters)
        return hutchinson(integrand_fun, sample_fun)(key, *parameters)

    @staticmethod
    def backward(ctx, cotangent):
        parameters = ctx.saved_tensors
        key_bwd = torch.Generator(device=ctx.key_device).manual_seed(ctx.seed)

        def integrand_vjp(v, *params):
            with torch.enable_grad():
                p = [x.detach().requires_grad_() for x in params]
                value = ctx.integrand_fun(v, *p)
                found = torch.autograd.grad(value, p, cotangent, allow_unused=True)
            return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(p, found))

        grads = hutchinson(integrand_vjp, ctx.sample_fun)(key_bwd, *parameters)
        return (None, None, None, None, *grads)


def hutchinson_batch(estimate_fun: Callable, /, num: int) -> Callable:
    """Average ``estimate_fun`` over ``num`` sequential batches drawn from one generator."""

    def estimate(key, *parameters):
        return _mean([estimate_fun(key, *parameters) for _ in range(num)])

    return estimate
