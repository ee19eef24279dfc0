"""Single-pass DIA matvec: the CUDA kernels K4 and K5 and their plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_dia.py``. For a DIA
operator with offsets ``d_k`` and packed values ``vals (D, n)``:

- K4 (``csrc/dia.cu`` ``lat_dia_matvec``) computes
  ``out[i] = sum_k vals[k, i] * x[(i + d_k) mod n]``;
- K5 (``csrc/dia.cu`` ``lat_dia_dvals``) computes the value gradient
  ``dvals[k, i] = u[i] * x[(i + d_k) mod n]``.

The wrap is circular, as in the JAX package's ``jnp.roll`` form, so
results and gradients match for any values, the wrapped slots included.
A wrapper launches its kernel for CUDA tensors and runs the plain
``torch.roll`` version of the same arithmetic for CPU tensors; there is
no other path.

K12 (``csrc/dia_ceiling.cu`` ``lat_dia_ceiling``, ``dia_ceiling_rows``)
is K4's speed-of-light probe, the counterpart of the TPU script
``experiments/benchmarks/spmv_formats/dia_roofline.py``'s
``speed_of_light``: ``out = x + vals[0] + ... + vals[D-1]``, the traffic
of one DIA matvec without its shifted reads (``studies.dia_roofline``).

``dia_matvec_fused(dia)`` wraps K4 and K5 in a ``torch.autograd.Function``:
the forward pass runs K4; the backward pass runs K4 on the transpose
(offsets ``-d_k``, each diagonal rolled by ``d_k``) only when ``v`` needs
a gradient, and K5 only when the values do. The Lanczos adjoint's
per-step parameter VJP needs only the values' gradient; the JAX package
gets the same saving from XLA dropping the unused transposed product.
"""

import torch

from lanczos_adjoints_tpu_torch.ops import native

DIA_MATVEC = native.Kernel("dia_matvec", "dia", "lat_dia_matvec", device_symbol="dia_matvec_kernel")
# The same C entry point, launched on the transposed operator: counted
# apart so that a run can show when the cotangent of v was computed.
DIA_MATVEC_T = native.Kernel("dia_matvec_transposed", "dia", "lat_dia_matvec",
                            device_symbol="dia_matvec_kernel")
DIA_DVALS = native.Kernel("dia_dvals", "dia", "lat_dia_dvals", device_symbol="dia_dvals_kernel")
DIA_CEILING = native.Kernel("dia_ceiling", "dia_ceiling", "lat_dia_ceiling", device_symbol="dia_ceiling_kernel")
# K12's block sizes: the counterpart of the TPU script's block ``chunk``.
CEILING_THREADS = (128, 256, 512, 1024)
LANES, SUBLANES = 128, 8  # the JAX kernel's tiling, kept for its n % 1024 rule


def check_operands(*arrays):
    """The operands' common device; raises on what the DIA kernels do not take."""
    device = arrays[0].device
    for a in arrays:
        if a.device != device:
            msg = f"all operands must lie on one device, got {a.device} and {device}"
            raise ValueError(msg)
        if a.dtype != torch.float32:
            msg = f"the DIA kernels take float32, got {a.dtype}"
            raise TypeError(msg)
        if not a.is_contiguous():
            raise ValueError("the DIA kernels take contiguous operands")
    if device.type not in ("cpu", "cuda"):
        msg = f"no DIA kernel for device {device}"
        raise ValueError(msg)
    return device


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def dia_matvec_plain(offsets, x, vals):
    """Plain K4: ``sum_k vals[k] * roll(x, -d_k)``, any dtype."""
    out = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        out = out + vals[k] * torch.roll(x, -d)
    return out


def dia_dvals_plain(offsets, x, u):
    """Plain K5: ``stack_k(u * roll(x, -d_k))``, any dtype."""
    return torch.stack([u * torch.roll(x, -d) for d in offsets])


def dia_ceiling_plain(x, vals):
    """Plain K12: ``x + vals[0] + ... + vals[D-1]``, summed in that order, any dtype."""
    out = x
    for k in range(vals.shape[0]):
        out = out + vals[k]
    return out


def transposed(offsets, vals):
    """The transpose's offsets and values: ``-d_k`` and ``roll(vals[k], d_k)``."""
    vals_t = torch.stack([torch.roll(vals[k], d) for k, d in enumerate(offsets)])
    return tuple(-d for d in offsets), vals_t.contiguous()


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def dia_matvec_rows(offsets, x, vals, *, kernel=DIA_MATVEC):
    """K4: ``x (n,)``, ``vals (D, n)`` -> ``(n,)``."""
    device = check_operands(x, vals)
    n = x.shape[0]
    if x.ndim != 1 or vals.shape != (len(offsets), n):
        msg = f"shape mismatch: x {tuple(x.shape)}, vals {tuple(vals.shape)}, {len(offsets)} offsets"
        raise ValueError(msg)
    if device.type == "cpu":
        return dia_matvec_plain(offsets, x, vals)
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        kernel.launch(
            x.data_ptr(), vals.data_ptr(), out.data_ptr(), n, len(offsets),
            native.offsets_arg(offsets, n, device).data_ptr(), native.stream(device),
        )
    return out


def dia_dvals_rows(offsets, x, u):
    """K5: ``x (n,)``, ``u (n,)`` -> ``dvals (D, n)``."""
    device = check_operands(x, u)
    n = x.shape[0]
    if x.ndim != 1 or u.shape != x.shape:
        msg = f"shape mismatch: x {tuple(x.shape)}, u {tuple(u.shape)}"
        raise ValueError(msg)
    if device.type == "cpu":
        return dia_dvals_plain(offsets, x, u)
    dvals = torch.empty((len(offsets), n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        DIA_DVALS.launch(
            x.data_ptr(), u.data_ptr(), dvals.data_ptr(), n, len(offsets),
            native.offsets_arg(offsets, n, device).data_ptr(), native.stream(device),
        )
    return dvals


def dia_ceiling_rows(x, vals, *, threads=256):
    """K12: ``x (n,)``, ``vals (D, n)`` -> ``x + sum_k vals[k]`` ``(n,)``, bit for
    bit ``dia_ceiling_plain``; ``threads`` a block, one of ``CEILING_THREADS``."""
    device = check_operands(x, vals)
    if x.ndim != 1 or vals.ndim != 2 or vals.shape[1] != x.shape[0] or vals.shape[0] < 1:
        msg = f"shape mismatch: x {tuple(x.shape)}, vals {tuple(vals.shape)}"
        raise ValueError(msg)
    if threads not in CEILING_THREADS:
        msg = f"threads={threads} not in {CEILING_THREADS}"
        raise ValueError(msg)
    if device.type == "cpu":
        return dia_ceiling_plain(x, vals)
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        DIA_CEILING.launch(x.data_ptr(), vals.data_ptr(), out.data_ptr(), x.shape[0], vals.shape[0],
                           threads, native.stream(device))
    return out


class _DiaMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, offsets, v, vals):
        ctx.offsets = offsets
        ctx.save_for_backward(v, vals)
        return dia_matvec_rows(offsets, v.contiguous(), vals.contiguous())

    @staticmethod
    def backward(ctx, u):
        v, vals = ctx.saved_tensors
        offsets = ctx.offsets
        u = u.contiguous()
        dv = dvals = None
        if ctx.needs_input_grad[1]:
            neg_offsets, vals_t = transposed(offsets, vals)
            dv = dia_matvec_rows(neg_offsets, u, vals_t, kernel=DIA_MATVEC_T)
        if ctx.needs_input_grad[2]:
            dvals = dia_dvals_rows(offsets, v.contiguous(), u)
        return None, dv, dvals


def dia_matvec_fused(dia, *, check_tiling: bool = True):
    """Differentiable single-pass matvec ``matvec(v, vals) -> A @ v``.

    ``vals`` is the packed ``(num_diags, n)`` tensor of
    ``ops.sparse.dia_values``, float32. With ``check_tiling`` (the
    default) it raises for ``n % 1024 != 0``, the JAX kernel's rule (its
    (8, 128) tiling), so that a direct call fails where the JAX
    package's does. K4 and K5 take any n: ``ops.sparse.sparse_operator``
    builds its matvec on the card with ``check_tiling=False``. The
    closure carries ``.dia_data``.
    """
    offsets = tuple(int(d) for d in dia.offsets)
    n = dia.shape[0]
    if check_tiling and n % (LANES * SUBLANES) != 0:
        msg = f"n={n} must be a multiple of {LANES * SUBLANES}"
        raise ValueError(msg)

    def matvec(v, vals):
        return _DiaMatvec.apply(offsets, v, vals)

    matvec.dia_data = dia
    return matvec
