"""Gram-matrix evaluation and Gram matvec policies.

Counterpart of ``lanczos_adjoints_tpu/ops/gram.py``. A kernel here is
``k(x, y, *params)`` on broadcastable batches of rows (``(..., d)``);
``params`` are the kernel's raw parameters, passed explicitly so that a
``torch.autograd.Function`` around a matvec can return their gradients
(the port's stand-in for ``jax.closure_convert``). A policy turns a
kernel into ``matvec(i, j, v, *params) -> K(i, j) @ v``, where ``i`` and
``j`` are feature rows or, for the index-based kernel of
``models.gp._CovarianceOp``, row indices.
"""

from typing import Callable

from lanczos_adjoints_tpu_torch.ops import fused_gram


def gram_matrix(fun: Callable, /) -> Callable:
    """Materialise the Gram matrix ``fun(x_i, y_j)`` of a kernel."""

    def gram(x, y, *params):
        return fun(x.unsqueeze(1), y.unsqueeze(0), *params)

    return gram


def gram_matvec() -> Callable:
    """Dense policy: form the whole Gram matrix, then multiply (small N only)."""

    def matvec(fun: Callable) -> Callable:
        dense = gram_matrix(fun)

        def matvec_y(i, j, v, *params):
            return dense(i, j, *params) @ v

        return matvec_y

    return matvec


def gram_matvec_fused(*, data_grads: bool = False) -> Callable:
    """Fused streaming policy: the CUDA kernels of ``ops.fused_gram``.

    Needs a kernel built by the ``models.gp.kernel_scaled_*`` factories,
    which tag it with ``fused_spec = (kind, constrain)``; raises for an
    untagged kernel. ``matvec_y(i, j, v, raw_lengthscale,
    raw_outputscale)`` constrains the raw parameters and calls the fused
    matvec. For the index-based kernel of ``models.gp._CovarianceOp``
    (tagged ``fused_data = (inputs, noise)``) the indices resolve to rows
    and a non-zero noise adds ``noise * v`` on the square matvec.
    ``data_grads=True`` gives the feature rows a gradient (K3); the rows
    must then be explicit arguments, as ``models.gp._CovarianceOp.matvec_rows``
    passes them, since an autograd Function gives no gradient to the
    captured ``fused_data``.
    """

    def matvec(fun: Callable) -> Callable:
        spec = getattr(fun, "fused_spec", None)
        if spec is None:
            msg = (
                "kernel is not tagged for the fused path "
                "(build it with models.gp.kernel_scaled_*); use gram_matvec()"
            )
            raise ValueError(msg)
        kind, constrain = spec
        fused = fused_gram.gram_matvec_fused(kind, data_grads=data_grads)
        indexed = getattr(fun, "fused_data", None)

        def matvec_y(i, j, v, raw_lengthscale, raw_outputscale):
            ell, out_s = constrain(raw_lengthscale), constrain(raw_outputscale)
            if indexed is None:
                return fused(i, j, v, ell, out_s)
            inputs, noise = indexed
            out = fused(inputs[i], inputs[j], v, ell, out_s)
            if isinstance(noise, (int, float)) and noise == 0.0:
                return out
            if i.shape[0] == v.shape[0]:
                return out + noise * v
            return out + noise * v[i]

        return matvec_y

    return matvec
