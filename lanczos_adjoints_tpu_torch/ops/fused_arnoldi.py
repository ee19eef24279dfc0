"""Fused Arnoldi over a DIA operator: the CUDA kernel K9 and its plain version.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_arnoldi.py``. K9
(``csrc/arnoldi_dia.cu`` ``lat_arnoldi_dia_forward``) runs the whole
K-step Arnoldi recurrence in one launch: the DIA matvec, classical
Gram-Schmidt against the basis rows written so far (twice, with the DGKS
truncation, for ``reortho="full"``), the guarded normalisation and the
Hessenberg matrix. Its plain version repeats the same arithmetic in
PyTorch. A wrapper launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no other path.

``hessenberg_dia_fused`` is the drop-in ``krylov.arnoldi.hessenberg`` for
DIA operators: an autograd Function whose forward is K9 and whose
backward is the generic closed-form adjoint (``krylov.arnoldi._adjoint``).
An adjoint step needs ``A^T lam`` and ``d/dvals <lam, A q_i>`` but never
``A q_i`` itself, so the backward calls the DIA matvec's two backward
kernels directly: one transposed K4 and one K5 per step (``ops.fused_dia``),
and no forward K4. The JAX package takes the XLA roll matvec there, which
on the card would be a plain version on CUDA tensors.
"""

import ctypes

import torch

from lanczos_adjoints_tpu_torch.krylov import arnoldi
from lanczos_adjoints_tpu_torch.ops import fused_dia, native
from lanczos_adjoints_tpu_torch.ops.fused_lanczos import guarded_div

ARNOLDI_FORWARD = native.Kernel("arnoldi_dia_forward", "arnoldi_dia", "lat_arnoldi_dia_forward")
LANES = 128  # the JAX kernel's lane width, kept for its n % 128 rule


def hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho):
    """Plain K9: ``(q (K, n) basis rows, H (K, K), res (n,), 1/|v0|)``, any dtype.

    Step i projects against the basis rows written so far, as the JAX
    package's unrolled kernel does.
    """
    n = v0.shape[0]
    norm = torch.sqrt(torch.dot(v0, v0))
    inv_norm = 1.0 / norm
    q = torch.zeros((depth, n), dtype=v0.dtype, device=v0.device)
    h = torch.zeros((depth, depth), dtype=v0.dtype, device=v0.device)
    w = v0
    for i in range(depth):
        q[i] = guarded_div(w, norm)
        w = fused_dia.dia_matvec_plain(offsets, q[i], vals)
        basis = q[: i + 1]
        c = basis @ w
        w = w - basis.T @ c
        norm = torch.sqrt(torch.dot(w, w))
        if reortho == "full":
            norm_pass1 = norm
            w = w - basis.T @ (basis @ w)
            norm = torch.sqrt(torch.dot(w, w))
            keep = norm > 0.5 * norm_pass1  # DGKS: else the residual is noise
            norm = torch.where(keep, norm, 0.0)
            w = torch.where(keep, w, 0.0)
        h[: i + 1, i] = c
        if i + 1 < depth:
            h[i + 1, i] = norm
    return q, h, w, inv_norm


def hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho):
    """K9: ``vals (D, n)``, ``v0 (n,)`` -> ``(q (K, n), H (K, K), res (n,), 1/|v0|)``."""
    device = fused_dia.check_operands(vals, v0)
    n = v0.shape[0]
    if v0.ndim != 1 or vals.shape != (len(offsets), n) or not 0 < depth <= n:
        msg = f"shape mismatch: v0 {tuple(v0.shape)}, vals {tuple(vals.shape)}, depth {depth}"
        raise ValueError(msg)
    arnoldi.check_option(reortho)
    if device.type == "cpu":
        return hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)
    with torch.cuda.device(device):
        blocks = ctypes.c_int(0)
        lib = native.library(ARNOLDI_FORWARD.source)
        native.check(lib.lat_arnoldi_dia_grid(n, ctypes.addressof(blocks)), "lat_arnoldi_dia_grid")
        g = blocks.value

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        q, h, res, inv_norm = empty(depth, n), empty(depth, depth), empty(n), empty(1)
        wbuf, partials, coef = empty(2, n), empty((2 * depth + 2) * g), empty(depth * g)
        ARNOLDI_FORWARD.launch(
            vals.data_ptr(), v0.data_ptr(), q.data_ptr(), h.data_ptr(), res.data_ptr(),
            inv_norm.data_ptr(), wbuf.data_ptr(), partials.data_ptr(), coef.data_ptr(), g, n,
            len(offsets), native.offsets_arg(offsets, n), depth, int(reortho == "full"),
            native.stream(device),
        )
    return q, h, res, inv_norm[0]


def _fused_offsets(dia, krylov_depth, check_tiling):
    n = dia.shape[0]
    if check_tiling and n % LANES != 0:
        msg = f"n={n} must be a multiple of {LANES} for the fused kernel"
        raise ValueError(msg)
    if not 1 <= krylov_depth <= n:
        msg = f"Parameter depth {krylov_depth} is outside the expected range"
        raise ValueError(msg)
    return tuple(int(d) for d in dia.offsets)


def hessenberg_dia_forward(dia, krylov_depth: int, *, reortho: str, check_tiling: bool = True):
    """The fused forward ``(v0, vals) -> (Q (n, K), H, res, 1/|v0|)``, as ``hessenberg``.

    ``check_tiling`` (the default) raises for ``n % 128 != 0`` as the JAX
    kernel does; K9 takes any n.
    """
    offsets = _fused_offsets(dia, krylov_depth, check_tiling)

    def forward(v0, vals):
        q, h, res, inv_norm = hessenberg_dia_forward_rows(
            offsets, vals.contiguous(), v0.contiguous(), krylov_depth, reortho
        )
        return q.T, h, res, inv_norm

    return forward


def dia_vjp(offsets, vals, needs_vals):
    """``vjp(q, lam) -> (A^T lam, [d/dvals <lam, A q>])`` by the DIA kernels.

    One transposed K4 and, if ``needs_vals``, one K5 per call; the
    transposed operator is prepared once.
    """
    neg_offsets, vals_t = fused_dia.transposed(offsets, vals)

    def vjp(q, lam):
        lam = lam.contiguous()
        at_lam = fused_dia.dia_matvec_rows(neg_offsets, lam, vals_t, kernel=fused_dia.DIA_MATVEC_T)
        dvals = fused_dia.dia_dvals_rows(offsets, q.contiguous(), lam) if needs_vals else None
        return at_lam, [dvals]

    return vjp


class _FusedArnoldi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, offsets, depth, reortho, reortho_adjoint, v0, vals):
        v0, vals = v0.contiguous(), vals.contiguous()
        q, h, res, inv_norm = hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)
        ctx.offsets = offsets
        ctx.reortho_adjoint = reortho_adjoint
        ctx.save_for_backward(q, h, res, inv_norm, vals)
        return q.T, h, res, inv_norm

    @staticmethod
    def backward(ctx, dQ, dH, dres, dinv_norm):
        q, h, res, inv_norm, vals = ctx.saved_tensors
        vjp = dia_vjp(ctx.offsets, vals, needs_vals=ctx.needs_input_grad[5])
        dv, (dvals,) = arnoldi._adjoint(
            vjp, Q=q.T, H=h, res=res, inv_norm=inv_norm, dQ=dQ, dH=dH, dres=dres,
            dinv_norm=dinv_norm, reortho=ctx.reortho_adjoint,
        )
        return None, None, None, None, dv, dvals


def hessenberg_dia_fused(
    dia, krylov_depth: int, *, reortho: str, reortho_vjp: str = "match", check_tiling: bool = True
):
    """Drop-in ``krylov.arnoldi.hessenberg`` for DIA operators, fused forward.

    ``estimate(v0, vals) -> (Q, H, res, 1/|v0|)`` with the gradient
    semantics of ``hessenberg(custom_vjp=True)``: the forward pass is one
    K9 launch, the backward pass the closed-form adjoint with one
    transposed K4 and one K5 per step. ``check_tiling`` (the default)
    raises the JAX kernel's errors (``n % 128``, the depth range);
    ``krylov.arnoldi.hessenberg``'s dispatch passes ``check_tiling=False``.
    """
    arnoldi.check_option(reortho)
    reortho_adjoint = reortho if reortho_vjp == "match" else reortho_vjp
    offsets = _fused_offsets(dia, krylov_depth, check_tiling)

    def estimate(v0, vals):
        return _FusedArnoldi.apply(offsets, krylov_depth, reortho, reortho_adjoint, v0, vals)

    return estimate
