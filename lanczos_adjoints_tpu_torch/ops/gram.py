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

import torch
import torch.utils.checkpoint

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


def gram_matvec_partitioned(num: int, *, checkpoint: bool) -> Callable:
    """Gram matvec streamed over ``num`` row blocks, one after another.

    Peak memory O(N^2 / num); ``checkpoint`` recomputes each block in the
    backward pass (``torch.utils.checkpoint``) instead of storing it.
    Raises ``ValueError`` if ``num`` does not divide the number of rows.
    Trailing axes of ``v`` are kept: an ``(N, m)`` probe block gives an
    ``(N, m)`` product.
    """

    def matvec(fun: Callable) -> Callable:
        dense = gram_matvec()(fun)

        def matvec_map(i, j, v, *params):
            ndata, *feature_shape = i.shape
            if ndata % num != 0:
                msg = f"num = {num} does not divide dataset size {ndata}."
                raise ValueError(msg)
            blocks = i.reshape(num, ndata // num, *feature_shape)
            return torch.cat([_run_block(dense, checkpoint, block, j, v, *params) for block in blocks])

        return matvec_map

    return matvec


def gram_matvec_sequential(*, checkpoint: bool) -> Callable:
    """Row-at-a-time Gram matvec (minimum memory, maximum latency).

    ``checkpoint`` recomputes each row in the backward pass; trailing
    axes of ``v`` are kept.
    """

    def matvec(fun: Callable) -> Callable:
        dense = gram_matvec()(fun)

        def matvec_map(i, j, v, *params):
            return torch.cat([_run_block(dense, checkpoint, row[None], j, v, *params) for row in i])

        return matvec_map

    return matvec


def _run_block(dense, checkpoint, rows, j, v, *params):
    """``dense(rows, j, v, *params)``, recomputed in the backward pass if ``checkpoint``."""
    if checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(dense, rows, j, v, *params, use_reentrant=False)
    return dense(rows, j, v, *params)


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
