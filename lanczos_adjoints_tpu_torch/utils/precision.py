"""Full-float32 matmuls for the numerically sensitive code paths.

The JAX package pins ``jax.default_matmul_precision("highest")`` because a
TPU multiplies in bfloat16 by default. On an NVIDIA GPU the analogue is
TF32: with it, a float32 matmul or convolution keeps about three decimal
digits, which makes tight CG tolerances unreachable and breaks
Gram-Schmidt. ``pin_float32()`` turns TF32 off for both cuBLAS and cuDNN;
the port's entry points check it with ``requires_float32`` and refuse to
run otherwise.
"""

import functools

import torch


def pin_float32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_float32() -> None:
    """Raise unless ``pin_float32()`` is in effect."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        msg = (
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); call "
            "lanczos_adjoints_tpu_torch.utils.precision.pin_float32() first"
        )
        raise RuntimeError(msg)


def requires_float32(fn):
    """Run ``fn`` only while float32 matmuls are exact (see ``pin_float32``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        assert_float32()
        return fn(*args, **kwargs)

    return wrapped
