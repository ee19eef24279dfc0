"""Fused streaming Gram matvec: the CUDA kernels K1 and K2 and their plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_gram.py``. For the
distance kernels ``rbf``, ``matern12`` and ``matern32`` (GPyTorch
parametrisation, ``models.gp``):

- K1 (``csrc/gram_matvec.cu``) computes ``K(x, y) @ v`` without forming
  the N x M matrix, for ``v`` of shape ``(M,)`` or ``(M, m)``;
- K2 (``csrc/gram_grads.cu``) computes the lengthscale and outputscale
  gradients of ``sum_k u_k^T K(x, y) v_k`` in one more streamed pass;
- K3 (``csrc/gram_dgrads.cu``) computes the per-row moments of the
  gradient of the same sum with respect to ``x`` (and, with the roles
  swapped, ``y``) in one more streamed pass.

All take rows scaled by ``sqrt(pscale) / lengthscale`` (``PSCALE`` folds
the family's distance factor into the data) and zero-padded to a width
(``padded_width``: 8, 16, 32 or 64, or a multiple of 64 above 64, which
the kernels take in chunks of 64 columns); ``outputscale`` multiplies
the O(N) output. A wrapper
launches its kernel for CUDA tensors and runs the plain PyTorch version
of the same arithmetic for CPU tensors; there is no other path.

``gram_matvec_fused(kind)`` wraps both in a ``torch.autograd.Function``:
the forward pass runs K1, the backward pass runs K1 on the transposed
operator for ``dv`` (only when ``v`` needs a gradient) and K2 for the
lengthscale and outputscale. ``x`` and ``y`` get no gradient unless
``data_grads=True``, as in the JAX package; then K3 runs once for each of
them that needs one.
"""

import contextlib
import contextvars
import math

import torch

from lanczos_adjoints_tpu_torch.ops import native
from lanczos_adjoints_tpu_torch.utils import spans

PSCALE = {"rbf": 0.5, "matern12": 1.0, "matern32": 3.0}
_KIND_ID = {"rbf": 0, "matern12": 1, "matern32": 2}
WIDTHS = (8, 16, 32, 64)  # the narrow widths; wider rows pad to a multiple of CHUNK
CHUNK = 64
_EPS = float(torch.finfo(torch.float32).eps)
# Cells per row chunk of the plain versions (bounds their memory).
_PLAIN_CELLS = 1 << 26
_VALUES_UNUSED = contextvars.ContextVar("fused_gram_values_unused", default=False)


GRAM_MATVEC = native.Kernel("gram_matvec", "gram_matvec", "lat_gram_matvec",
                            device_symbol="gram_matvec_kernel")
GRAM_GRADS = native.Kernel("gram_grads", "gram_grads", "lat_gram_grads",
                           device_symbol="gram_grads_kernel")
GRAM_DGRADS = native.Kernel("gram_dgrads", "gram_dgrads", "lat_gram_dgrads",
                            device_symbol="gram_dgrads_kernel")
_GRADS_BLOCK_ROWS = 128  # rows per K2 block: kRows in csrc/gram_grads.cu
# K1 (csrc/gram_matvec.cu): rows a block, and blocks an SM holds at once.
K1_ROWS = 128
K1_BLOCKS_PER_SM = 4
# The column split takes at most this many segments, each at least this
# many columns long.
_SPLIT_MAX = 8
_SPLIT_MIN_COLS = 2048


def padded_width(d: int) -> int:
    """The kernel width for ``d`` input dimensions: 8, 16, 32 or 64, or the
    next multiple of 64 above 64 (as the JAX package pads any d)."""
    for width in WIDTHS:
        if d <= width:
            return width
    return -(-d // CHUNK) * CHUNK


def _width_ok(width: int) -> bool:
    return width in WIDTHS or (width > CHUNK and width % CHUNK == 0)


def column_splits(n_rows: int, n_cols: int, sms: int) -> int:
    """Column segments S of one K1 launch, so that its blocks fill the card.

    The card holds ``K1_BLOCKS_PER_SM * sms`` blocks at once; a launch of
    B row blocks runs in waves of that many, and a short last wave leaves
    SMs idle. With fewer than four waves, S is the smallest count of
    segments (at most ``_SPLIT_MAX``, each at least ``_SPLIT_MIN_COLS``
    columns) whose B * S blocks fill their last wave best. The segments'
    partial products are summed in a fixed order in the same launch.
    1 means no split.
    """
    blocks = -(-n_rows // K1_ROWS)
    slots = K1_BLOCKS_PER_SM * sms
    if blocks >= 4 * slots:
        return 1

    def fill(s):
        waves = blocks * s / slots
        return waves / math.ceil(waves)

    most = max(1, min(_SPLIT_MAX, n_cols // _SPLIT_MIN_COLS))
    best = max(fill(s) for s in range(1, most + 1))
    return min(s for s in range(1, most + 1) if fill(s) >= best - 1e-9)


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


def gram_dgrads_plain(kind, xs, ys, v2, u2):
    """Plain K3: the (n, 1 + D) moments ``[S_i, T_i]`` per row of ``xs``.

    ``S_i = sum_j w_ij`` and ``T_id = sum_j w_ij ys_jd`` (scaled
    coordinates), with ``w_ij = (u_i . v_j) * dg/dsq``.
    """
    starts, step = _chunks(xs.shape[0], ys.shape[0])
    moments = []
    for i in starts:
        xc = xs[i : i + step]
        _, dg = kernel_value_dsq(kind, _scaled_sq(xc, ys))
        w = (u2[i : i + step] @ v2.T) * dg
        moments.append(torch.cat([torch.sum(w, dim=1, keepdim=True), w @ ys], dim=1))
    return torch.cat(moments)


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def gram_matvec_rows(kind, xs, ys, v2):
    """K1 on prepared rows: ``xs (n, D)``, ``ys (M, D)``, ``v2 (M, m)`` -> ``(n, m)``."""
    device = _check(kind, xs, ys, v2)
    n, width = xs.shape
    n_cols, m = v2.shape
    if ys.shape != (n_cols, width) or not _width_ok(width):
        msg = f"shape mismatch: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, v {tuple(v2.shape)}"
        raise ValueError(msg)
    if device.type == "cpu":
        return gram_matvec_plain(kind, xs, ys, v2)
    # The kernel stages rows by 16-byte copies.
    xs, ys = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (xs, ys))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = column_splits(n, n_cols, sms)
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    partials = counters = None
    if splits > 1:
        partials = torch.empty((splits, n, m), dtype=torch.float32, device=device)
        counters = torch.zeros(-(-n // K1_ROWS), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        GRAM_MATVEC.launch(
            _KIND_ID[kind], xs.data_ptr(), ys.data_ptr(), v2.data_ptr(), out.data_ptr(),
            0 if partials is None else partials.data_ptr(),
            0 if counters is None else counters.data_ptr(),
            n, n_cols, m, width, splits, native.stream(device),
        )
    return out


def grads_operands(v2, u2):
    """``v2``, ``u2`` as K2 and K3 take them: for m > 1, m in multiples of
    4, so they get zero columns, which add uv = 0."""
    m = v2.shape[1]
    if m == 1 or m % 4 == 0:
        return v2, u2
    pad = (0, -m % 4)
    return torch.nn.functional.pad(v2, pad), torch.nn.functional.pad(u2, pad)


def gram_grads_rows(kind, xs, ys, v2, u2):
    """K2 on prepared rows -> the (1 + D,) totals (see ``gram_grads_plain``).

    On the card the kernel writes one partial row per block of 128 rows;
    they are summed here by one fixed-order reduction, so the result does
    not change from run to run.
    """
    device = _check(kind, xs, ys, v2, u2)
    n, width = xs.shape
    n_cols, m = v2.shape
    if ys.shape != (n_cols, width) or u2.shape != (n, m) or not _width_ok(width):
        msg = (
            f"shape mismatch: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, "
            f"v {tuple(v2.shape)}, u {tuple(u2.shape)}"
        )
        raise ValueError(msg)
    if device.type == "cpu":
        return gram_grads_plain(kind, xs, ys, v2, u2)
    # The kernel stages rows and u, v by 16-byte copies.
    v2, u2 = grads_operands(v2, u2)
    m = v2.shape[1]
    xs, ys, v2, u2 = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (xs, ys, v2, u2))
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


def gram_dgrads_rows(kind, xs, ys, v2, u2):
    """K3 on prepared rows -> the (n, 1 + D) moments (see ``gram_dgrads_plain``).

    Every row's moments are summed in one fixed order on the card, so the
    result does not change from run to run.
    """
    device = _check(kind, xs, ys, v2, u2)
    n, width = xs.shape
    n_cols, m = v2.shape
    if ys.shape != (n_cols, width) or u2.shape != (n, m) or not _width_ok(width):
        msg = (
            f"shape mismatch: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, "
            f"v {tuple(v2.shape)}, u {tuple(u2.shape)}"
        )
        raise ValueError(msg)
    if device.type == "cpu":
        return gram_dgrads_plain(kind, xs, ys, v2, u2)
    # The kernel stages rows and u, v by 16-byte copies.
    v2, u2 = grads_operands(v2, u2)
    m = v2.shape[1]
    xs, ys, v2, u2 = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (xs, ys, v2, u2))
    moments = torch.empty((n, 1 + width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        GRAM_DGRADS.launch(
            _KIND_ID[kind], xs.data_ptr(), ys.data_ptr(), v2.data_ptr(),
            u2.data_ptr(), moments.data_ptr(), n, n_cols, m, width,
            native.stream(device),
        )
    return moments


def data_grad(kind, x, y, v2, u2, lengthscale, outputscale):
    """d/dx of ``sum_k u_k^T K(x, y) v_k``, shape of ``x``.

    ``dx_id = outputscale * 2 / ell_d^2 * (x_id S_i - T_id / scale_d)``
    from K3's moments; ``T`` is in the scaled coordinates of
    ``kernel_rows``, so its first ``d`` columns are unscaled by
    ``scale = sqrt(pscale) / ell``. ``d/dy`` is ``data_grad(kind, y, x,
    u2, v2, ...)``.
    """
    moments = gram_dgrads_rows(
        kind,
        kernel_rows(x, lengthscale, kind),
        kernel_rows(y, lengthscale, kind),
        v2.contiguous(),
        u2.contiguous(),
    )
    d = x.shape[-1]
    row_sum, t = moments[:, :1], moments[:, 1 : 1 + d]
    scale = math.sqrt(PSCALE[kind]) / lengthscale
    return outputscale * (2.0 / lengthscale**2) * (x * row_sum - t / scale)


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
    def forward(ctx, kind, data_grads, x, y, v, lengthscale, outputscale):
        ctx.kind = kind
        ctx.data_grads = data_grads
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
    @spans.spanned("gram.vjp")
    def backward(ctx, u):
        x, y, v, lengthscale, outputscale = ctx.saved_tensors
        kind = ctx.kind
        u2 = u[:, None] if u.ndim == 1 else u
        v2 = v[:, None] if v.ndim == 1 else v
        needs = ctx.needs_input_grad
        dx = dy = dv = d_ell = d_out = None
        if needs[4]:  # K^T u, the transposed operator
            dv = outputscale * gram_matvec_rows(
                kind,
                kernel_rows(y, lengthscale, kind),
                kernel_rows(x, lengthscale, kind),
                u2.contiguous(),
            )
            dv = dv[:, 0] if v.ndim == 1 else dv
        if needs[5] or needs[6]:
            d_ell, d_out = param_grads(kind, x, y, v2, u2, lengthscale, outputscale)
        if ctx.data_grads and needs[2]:
            dx = data_grad(kind, x, y, v2, u2, lengthscale, outputscale)
        if ctx.data_grads and needs[3]:  # rows and columns, v and u swapped
            dy = data_grad(kind, y, x, u2, v2, lengthscale, outputscale)
        return None, None, dx, dy, dv, d_ell, d_out


def gram_matvec_fused(kind: str, *, data_grads: bool = False):
    """Return ``matvec(x, y, v, lengthscale, outputscale) -> outputscale * K(x, y) @ v``.

    ``v`` is ``(M,)`` or ``(M, m)``; ``lengthscale`` a scalar tensor or a
    ``(d,)`` ARD vector; ``outputscale`` a scalar tensor; all float32.
    Differentiable with respect to ``v``, ``lengthscale`` and
    ``outputscale``; ``x`` and ``y`` get no gradient unless
    ``data_grads=True`` (deep-kernel and inducing-point training), which
    runs K3 in the backward pass for each of them that needs one.
    """
    if kind not in _KIND_ID:
        msg = f"kind={kind!r} not supported"
        raise ValueError(msg)

    def matvec(x, y, v, lengthscale, outputscale):
        return _FusedGram.apply(kind, data_grads, x, y, v, lengthscale, outputscale)

    return matvec
