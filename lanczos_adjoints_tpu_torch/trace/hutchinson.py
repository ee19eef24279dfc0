"""Hutchinson probes.

Counterpart of ``lanczos_adjoints_tpu/trace/hutchinson.py::sampler_rademacher``.
A JAX key becomes a ``torch.Generator``; the two give different draws for
the same seed, so tests hand both packages the same numpy probes through
a custom ``sample`` callable instead.
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
