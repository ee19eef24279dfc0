"""Fused streaming Gram matvec: the CUDA kernels K1 and K2 and their plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_gram.py``. For the
distance kernels ``rbf``, ``matern12`` and ``matern32`` (GPyTorch
parametrisation, ``models.gp``):

- K1 (``csrc/gram_matvec.cu``) computes ``K(x, y) @ v`` without forming
  the N x M matrix, for ``v`` of shape ``(M,)`` or ``(M, m)``;
- K2 (``csrc/gram_grads.cu``) computes the lengthscale and outputscale
  gradients of ``sum_k u_k^T K(x, y) v_k`` in one more streamed pass.

Both take rows scaled by ``sqrt(pscale) / lengthscale`` (``PSCALE`` folds
the family's distance factor into the data) and zero-padded to a width
in ``WIDTHS``; ``outputscale`` multiplies the O(N) output. A wrapper
launches its kernel for CUDA tensors and runs the plain PyTorch version
of the same arithmetic for CPU tensors; there is no other path.

``gram_matvec_fused(kind)`` wraps both in a ``torch.autograd.Function``:
the forward pass runs K1, the backward pass runs K1 on the transposed
operator for ``dv`` (only when ``v`` needs a gradient) and K2 for the
lengthscale and outputscale. ``x`` and ``y`` get no gradient, as with the
JAX package's default ``data_grads=False``.
"""

import contextlib
import contextvars
import math

import torch

from lanczos_adjoints_tpu_torch.ops import native

PSCALE = {"rbf": 0.5, "matern12": 1.0, "matern32": 3.0}
_KIND_ID = {"rbf": 0, "matern12": 1, "matern32": 2}
WIDTHS = (8, 16, 32, 64)
_EPS = float(torch.finfo(torch.float32).eps)
# Cells per row chunk of the plain versions (bounds their memory).
_PLAIN_CELLS = 1 << 26
_VALUES_UNUSED = contextvars.ContextVar("fused_gram_values_unused", default=False)


GRAM_MATVEC = native.Kernel("gram_matvec", "gram_matvec", "lat_gram_matvec")
GRAM_GRADS = native.Kernel("gram_grads", "gram_grads", "lat_gram_grads")
_GRADS_BLOCK_ROWS = 64  # rows per K2 block: kBR in csrc/gram_grads.cu


def padded_width(d: int) -> int:
    for width in WIDTHS:
        if d <= width:
            return width
    msg = f"d={d} exceeds the widest fused Gram kernel (d <= {WIDTHS[-1]})"
    raise ValueError(msg)


def kernel_rows(arr, lengthscale, kind: str):
    """Rows scaled by ``sqrt(pscale) / lengthscale``, zero-padded to a width."""
    scaled = arr * (math.sqrt(PSCALE[kind]) / lengthscale)
    d = arr.shape[-1]
    pad = padded_width(d) - d
    if pad:
        scaled = torch.nn.functional.pad(scaled, (0, pad))
    return scaled.to(torch.float32).contiguous()


def _check(kind, *arrays):
    if kind not in _KIND_ID:
        msg = f"kind={kind!r} not supported; choose one of {sorted(_KIND_ID)}"
        raise ValueError(msg)
    device = arrays[0].device
    for a in arrays:
        if a.device != device:
            msg = f"all operands must lie on one device, got {a.device} and {device}"
            raise ValueError(msg)
        if a.dtype != torch.float32:
            msg = f"the fused Gram kernels take float32, got {a.dtype}"
            raise TypeError(msg)
        if not a.is_contiguous():
            raise ValueError("the fused Gram kernels take contiguous operands")
    if device.type not in ("cpu", "cuda"):
        msg = f"no fused Gram kernel for device {device}"
        raise ValueError(msg)
    return device


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def kernel_value(kind, p):
    """g(p), with p = pscale * sq and k = outputscale * g."""
    if kind == "rbf":
        return torch.exp(-p)
    dist = torch.sqrt(p + _EPS)
    e = torch.exp(-dist)
    return e if kind == "matern12" else (1.0 + dist) * e


def kernel_value_dsq(kind, p):
    """(g, dg/dsq), the derivative with respect to the unscaled sq."""
    if kind == "rbf":
        g = torch.exp(-p)
        return g, -0.5 * g
    dist = torch.sqrt(p + _EPS)
    e = torch.exp(-dist)
    if kind == "matern12":
        return e, -0.5 * e / dist
    return (1.0 + dist) * e, -1.5 * e


def _scaled_sq(xc, ys):
    """Pre-scaled squared distances by direct differences, (rows, cols)."""
    p = torch.zeros((xc.shape[0], ys.shape[0]), dtype=xc.dtype, device=xc.device)
    for dd in range(xc.shape[1]):
        diff = xc[:, dd, None] - ys[None, :, dd]
        p.addcmul_(diff, diff)
    return p


def _chunks(n_rows, n_cols):
    step = max(1, _PLAIN_CELLS // max(1, n_cols))
    return range(0, n_rows, step), step


def gram_matvec_plain(kind, xs, ys, v2):
    """Plain K1: ``g(xs, ys) @ v2`` in row chunks."""
    starts, step = _chunks(xs.shape[0], ys.shape[0])
    return torch.cat(
        [kernel_value(kind, _scaled_sq(xs[i : i + step], ys)) @ v2 for i in starts]
    )


def gram_matvec_reference(kind, x, y, v, lengthscale, outputscale):
    """Plain, autograd-differentiable ``outputscale * K(x, y) @ v``.

    The oracle for ``gram_matvec_fused``'s values and gradients: the same
    arithmetic as the plain K1, differentiated by autograd.
    """
    xs = kernel_rows(x, lengthscale, kind)
    ys = kernel_rows(y, lengthscale, kind)
    return outputscale * gram_matvec_plain(kind, xs, ys, v)


def gram_grads_plain(kind, xs, ys, v2, u2):
    """Plain K2: the (1 + D,) totals ``[sum uv g, sum w (xs - ys)^2 per dim]``."""
    width = xs.shape[1]
    total = torch.zeros(1 + width, dtype=xs.dtype, device=xs.device)
    starts, step = _chunks(xs.shape[0], ys.shape[0])
    for i in starts:
        xc = xs[i : i + step]
        g, dg = kernel_value_dsq(kind, _scaled_sq(xc, ys))
        uv = u2[i : i + step] @ v2.T
        total[0] += torch.sum(uv * g)
        w = uv * dg
        for dd in range(width):
            diff = xc[:, dd, None] - ys[None, :, dd]
            total[1 + dd] += torch.sum(w * diff * diff)
    return total


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def gram_matvec_rows(kind, xs, ys, v2):
    """K1 on prepared rows: ``xs (n, D)``, ``ys (M, D)``, ``v2 (M, m)`` -> ``(n, m)``."""
    device = _check(kind, xs, ys, v2)
    n, width = xs.shape
    n_cols, m = v2.shape
    if ys.shape != (n_cols, width) or width not in WIDTHS:
        msg = f"shape mismatch: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, v {tuple(v2.shape)}"
        raise ValueError(msg)
    if device.type == "cpu":
        return gram_matvec_plain(kind, xs, ys, v2)
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        GRAM_MATVEC.launch(
            _KIND_ID[kind], xs.data_ptr(), ys.data_ptr(), v2.data_ptr(),
            out.data_ptr(), n, n_cols, m, width, native.stream(device),
        )
    return out


def gram_grads_rows(kind, xs, ys, v2, u2):
    """K2 on prepared rows -> the (1 + D,) totals (see ``gram_grads_plain``).

    On the card the kernel writes one partial row per block of 64 rows;
    they are summed here by one fixed-order reduction, so the result does
    not change from run to run.
    """
    device = _check(kind, xs, ys, v2, u2)
    n, width = xs.shape
    n_cols, m = v2.shape
    if ys.shape != (n_cols, width) or u2.shape != (n, m) or width not in WIDTHS:
        msg = (
            f"shape mismatch: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, "
            f"v {tuple(v2.shape)}, u {tuple(u2.shape)}"
        )
        raise ValueError(msg)
    if device.type == "cpu":
        return gram_grads_plain(kind, xs, ys, v2, u2)
    blocks = -(-n // _GRADS_BLOCK_ROWS)
    partials = torch.empty((blocks, 1 + width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        GRAM_GRADS.launch(
            _KIND_ID[kind], xs.data_ptr(), ys.data_ptr(), v2.data_ptr(),
            u2.data_ptr(), partials.data_ptr(), n, n_cols, m, width,
            native.stream(device),
        )
    return partials.sum(dim=0)


def param_grads(kind, x, y, v2, u2, lengthscale, outputscale):
    """(d_lengthscale, d_outputscale) of ``sum_k u_k^T K(x, y) v_k``."""
    total = gram_grads_rows(
        kind,
        kernel_rows(x, lengthscale, kind),
        kernel_rows(y, lengthscale, kind),
        v2.contiguous(),
        u2.contiguous(),
    )
    d = x.shape[-1]
    d_out = total[0]
    # The kernel sums w * (x - y)_scaled^2 = w * pscale * sq_d; unscale,
    # then d sq_d / d ell_d = -2 sq_d / ell_d (w carries dg/dsq).
    dsq_sums = total[1 : 1 + d] / PSCALE[kind]
    d_ell_vec = outputscale * (-2.0 / lengthscale) * dsq_sums
    d_ell = d_ell_vec if lengthscale.ndim else torch.sum(d_ell_vec)
    return d_ell, d_out


@contextlib.contextmanager
def values_unused():
    """Inside, the fused matvec's forward pass skips K1 and returns NaNs.

    For a vector-Jacobian product taken only for the kernel parameters
    (the deferred parameter gradient of the Lanczos adjoint, the CG
    backward pass), where the forward values are never read: the JAX
    package gets the same saving from XLA dropping the unused output.
    The backward pass does not read them either, and a NaN makes any
    other use visible.
    """
    token = _VALUES_UNUSED.set(True)
    try:
        yield
    finally:
        _VALUES_UNUSED.reset(token)


class _FusedGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, x, y, v, lengthscale, outputscale):
        ctx.kind = kind
        ctx.save_for_backward(x, y, v, lengthscale, outputscale)
        if _VALUES_UNUSED.get():
            return torch.full((x.shape[0], *v.shape[1:]), math.nan, dtype=v.dtype, device=v.device)
        v2 = v[:, None] if v.ndim == 1 else v
        out = outputscale * gram_matvec_rows(
            kind,
            kernel_rows(x, lengthscale, kind),
            kernel_rows(y, lengthscale, kind),
            v2.contiguous(),
        )
        return out[:, 0] if v.ndim == 1 else out

    @staticmethod
    def backward(ctx, u):
        x, y, v, lengthscale, outputscale = ctx.saved_tensors
        kind = ctx.kind
        u2 = u[:, None] if u.ndim == 1 else u
        v2 = v[:, None] if v.ndim == 1 else v
        dv = d_ell = d_out = None
        if ctx.needs_input_grad[3]:  # K^T u, the transposed operator
            dv = outputscale * gram_matvec_rows(
                kind,
                kernel_rows(y, lengthscale, kind),
                kernel_rows(x, lengthscale, kind),
                u2.contiguous(),
            )
            dv = dv[:, 0] if v.ndim == 1 else dv
        if ctx.needs_input_grad[4] or ctx.needs_input_grad[5]:
            d_ell, d_out = param_grads(kind, x, y, v2, u2, lengthscale, outputscale)
        return None, None, None, dv, d_ell, d_out


def gram_matvec_fused(kind: str):
    """Return ``matvec(x, y, v, lengthscale, outputscale) -> outputscale * K(x, y) @ v``.

    ``v`` is ``(M,)`` or ``(M, m)``; ``lengthscale`` a scalar tensor or a
    ``(d,)`` ARD vector; ``outputscale`` a scalar tensor; all float32.
    Differentiable with respect to ``v``, ``lengthscale`` and
    ``outputscale``; ``x`` and ``y`` get no gradient.
    """
    if kind not in _KIND_ID:
        msg = f"kind={kind!r} not supported"
        raise ValueError(msg)

    def matvec(x, y, v, lengthscale, outputscale):
        return _FusedGram.apply(kind, x, y, v, lengthscale, outputscale)

    return matvec
