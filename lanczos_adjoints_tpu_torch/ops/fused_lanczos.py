"""Fused Lanczos over a DIA operator: the CUDA kernels K6 and K7 and their plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_lanczos.py``:

- K6 (``csrc/lanczos_dia.cu`` ``lat_lanczos_dia_forward``) runs the whole
  K-step three-term recurrence in one launch and writes the basis
  ``(K+1, n)``, the alphas and the betas;
- K7 (``lat_lanczos_dia_adjoint``) runs the whole reverse closed-form
  adjoint in one launch: per step the (xi, mu, nu, lambda) update,
  ``A lambda`` and ``dvals[k] += x * roll(lambda, -d_k)``; then ``dv``.

Divides are guarded as in the JAX package: a zero norm (an exhausted
Krylov space) truncates to zero vectors instead of 0 / 0. A wrapper
launches its kernel for CUDA tensors and runs the plain PyTorch version
(a Python loop over the same recurrence) for CPU tensors; there is no
other path. ``tridiag_dia_fused`` is the drop-in for
``krylov.lanczos.tridiag(..., reortho="none")`` on DIA operators, with
the forward as K6 and the backward as K7.
"""

import torch

from lanczos_adjoints_tpu_torch.ops import fused_dia, native

LANCZOS_FORWARD = native.Kernel("lanczos_dia_forward", "lanczos_dia", "lat_lanczos_dia_forward",
                                device_symbol="lanczos_forward_kernel")
LANCZOS_ADJOINT = native.Kernel("lanczos_dia_adjoint", "lanczos_dia", "lat_lanczos_dia_adjoint",
                                device_symbol="lanczos_adjoint_kernel")
LANES = 128  # the JAX kernel's lane width, kept for its n % 128 rule
# Floats of per-block partials the wrappers allocate: three slots of up
# to 8,192 blocks, well above the co-resident blocks of one card.
_PARTIALS = 3 * 8192


def guarded_div(vec, norm):
    """``vec / norm``, or zeros where ``norm`` is not positive."""
    keep = norm > 0.0
    return torch.where(keep, vec / torch.where(keep, norm, 1.0), torch.zeros_like(vec))


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card); any dtype
# ---------------------------------------------------------------------------


def lanczos_forward_plain(offsets, vals, v0, depth):
    """Plain K6: ``(xs (K+1, n), alphas (K,), betas (K,))``."""
    norm0 = torch.sqrt(torch.dot(v0, v0))
    x = guarded_div(v0, norm0)
    x_prev = torch.zeros_like(x)
    beta = torch.zeros((), dtype=x.dtype, device=x.device)
    xs, alphas, betas = [x], [], []
    for _ in range(depth):
        ax = fused_dia.dia_matvec_plain(offsets, x, vals)
        alpha = torch.dot(x, ax)
        resid = ax - alpha * x - beta * x_prev
        beta = torch.sqrt(torch.dot(resid, resid))
        x_prev, x = x, guarded_div(resid, beta)
        xs.append(x)
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(xs), torch.stack(alphas), torch.stack(betas)


def lanczos_adjoint_plain(offsets, vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas):
    """Plain K7: ``(dv (n,), dvals (D, n))`` of the closed-form adjoint."""
    depth = alphas.shape[0]
    dvals = torch.zeros_like(vals)
    xi = -dxs[depth]
    lam_next = torch.zeros_like(xi)
    for i in reversed(range(depth)):
        x, x_next = xs[i], xs[i + 1]
        alpha, beta = alphas[i], betas[i]
        # A zero beta decouples the truncated trailing block: its adjoint
        # vector is zero, not xi / 0.
        xi = guarded_div(xi, beta)
        mu = dbetas[i] - torch.dot(lam_next, x) + torch.dot(x_next, xi)
        nu = dalphas[i] + torch.dot(x, xi)
        lam = -xi + mu * x_next + nu * x
        at_lam = torch.zeros_like(lam)
        for k, d in enumerate(offsets):
            rolled = torch.roll(lam, -d)
            at_lam = at_lam + vals[k] * rolled
            dvals[k] = dvals[k] + x * rolled
        xi = -dxs[i] - at_lam + alpha * lam + beta * lam_next - beta * nu * x_next
        lam_next = lam
    x0 = xs[0]
    dv = (torch.dot(xi, x0) * x0 - xi) * inv_norm
    return dv, dvals


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def lanczos_forward_rows(offsets, vals, v0, depth):
    """K6: ``vals (D, n)``, ``v0 (n,)`` -> ``(xs (K+1, n), alphas (K,), betas (K,))``."""
    device = fused_dia.check_operands(vals, v0)
    n = v0.shape[0]
    if v0.ndim != 1 or vals.shape != (len(offsets), n) or not 0 < depth <= n:
        msg = f"shape mismatch: v0 {tuple(v0.shape)}, vals {tuple(vals.shape)}, depth {depth}"
        raise ValueError(msg)
    if device.type == "cpu":
        return lanczos_forward_plain(offsets, vals, v0, depth)
    xs = torch.empty((depth + 1, n), dtype=torch.float32, device=device)
    coef = torch.empty((2, depth), dtype=torch.float32, device=device)
    work = torch.empty(n, dtype=torch.float32, device=device)
    partials = torch.empty(_PARTIALS, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        LANCZOS_FORWARD.launch(
            vals.data_ptr(), v0.data_ptr(), xs.data_ptr(), coef[0].data_ptr(),
            coef[1].data_ptr(), work.data_ptr(), partials.data_ptr(), _PARTIALS, n,
            len(offsets), native.offsets_arg(offsets, n), depth, native.stream(device),
        )
    return xs, coef[0], coef[1]


def lanczos_adjoint_rows(offsets, vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas):
    """K7: the adjoint's ``(dv (n,), dvals (D, n))``; ``inv_norm`` is a 0-d tensor."""
    inv_norm = inv_norm.reshape(1)
    device = fused_dia.check_operands(vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas)
    depth = alphas.shape[0]
    n = xs.shape[1]
    shapes_ok = (
        vals.shape == (len(offsets), n)
        and xs.shape == dxs.shape == (depth + 1, n)
        and alphas.shape == betas.shape == dalphas.shape == dbetas.shape == (depth,)
    )
    if not shapes_ok or depth < 1:
        msg = (
            f"shape mismatch: vals {tuple(vals.shape)}, xs {tuple(xs.shape)}, "
            f"dxs {tuple(dxs.shape)}, alphas {tuple(alphas.shape)}, betas {tuple(betas.shape)}"
        )
        raise ValueError(msg)
    if device.type == "cpu":
        return lanczos_adjoint_plain(
            offsets, vals, xs, alphas, betas, inv_norm[0], dxs, dalphas, dbetas
        )
    dv = torch.empty(n, dtype=torch.float32, device=device)
    dvals = torch.empty_like(vals)
    xi = torch.empty(n, dtype=torch.float32, device=device)
    lam = torch.empty((2, n), dtype=torch.float32, device=device)
    partials = torch.empty(_PARTIALS, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        LANCZOS_ADJOINT.launch(
            vals.data_ptr(), xs.data_ptr(), dxs.data_ptr(), alphas.data_ptr(),
            betas.data_ptr(), dalphas.data_ptr(), dbetas.data_ptr(), inv_norm.data_ptr(),
            dv.data_ptr(), dvals.data_ptr(), xi.data_ptr(), lam.data_ptr(),
            partials.data_ptr(), _PARTIALS, n, len(offsets),
            native.offsets_arg(offsets, n), depth, native.stream(device),
        )
    return dv, dvals


def _fused_offsets(dia, check_tiling=True):
    n = dia.shape[0]
    if check_tiling and n % LANES != 0:
        msg = f"n={n} must be a multiple of {LANES} for the fused kernel"
        raise ValueError(msg)
    return tuple(int(d) for d in dia.offsets)


def lanczos_forward_dia(dia, krylov_depth: int):
    """The fused forward: ``(v0, vals) -> (decomposition, remainder)``.

    ``dia`` is an ``ops.sparse.DIAData``; ``vals`` the packed
    ``(num_diags, n)`` float32 values. Output layout of ``krylov.tridiag``.
    """
    offsets = _fused_offsets(dia)

    def forward(v0, vals):
        xs, alphas, betas = lanczos_forward_rows(offsets, vals.contiguous(), v0.contiguous(), krylov_depth)
        return (xs[:-1], (alphas, betas[:-1])), (xs[-1], betas[-1])

    return forward


def lanczos_adjoint_dia(dia, krylov_depth: int):
    """The fused adjoint: ``(vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas) -> (dv, dvals)``.

    ``xs``, ``dxs`` are ``(K+1, n)`` and ``betas``, ``dbetas`` ``(K,)``:
    the residual entries stacked onto the decomposition's.
    """
    offsets = _fused_offsets(dia)

    def adjoint(vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas):
        args = (vals, xs, alphas, betas, inv_norm, dxs, dalphas, dbetas)
        return lanczos_adjoint_rows(offsets, *(a.contiguous() for a in args))

    return adjoint


class _FusedLanczos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, offsets, depth, v0, vals):
        v0, vals = v0.contiguous(), vals.contiguous()
        xs, alphas, betas = lanczos_forward_rows(offsets, vals, v0, depth)
        ctx.offsets = offsets
        # The whole basis and all betas are saved: they are the
        # concatenation of the decomposition with its residual entries.
        ctx.save_for_backward(xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0), vals)
        return xs[:-1], alphas, betas[:-1], xs[-1], betas[-1]

    @staticmethod
    def backward(ctx, dxs_head, dalphas, dbetas_head, dx_res, dbeta_res):
        xs, alphas, betas, inv_norm, vals = ctx.saved_tensors
        dxs = torch.cat([dxs_head, dx_res[None]])
        dbetas = torch.cat([dbetas_head, dbeta_res[None]])
        dv, dvals = lanczos_adjoint_rows(
            ctx.offsets, vals, xs, alphas.contiguous(), betas, inv_norm, dxs,
            dalphas.contiguous(), dbetas,
        )
        return None, None, dv, dvals


def tridiag_dia_fused(
    dia, krylov_depth: int, *, stream: bool | None = None, check_tiling: bool = True
):
    """Drop-in ``krylov.lanczos.tridiag(..., reortho="none")`` for DIA operators.

    Returns ``estimate(v0, vals) -> ((xs, (alphas, betas)), (x_res, beta_res))``
    with the gradient semantics of ``tridiag``'s closed-form adjoint: the
    forward pass is one K6 launch, the backward pass one K7 launch.

    ``stream`` is accepted with the JAX package's meaning (``None`` picks,
    ``True`` streams the basis through HBM, ``False`` keeps it resident in
    VMEM). The card has no VMEM to run out of: the basis always lives in
    device memory, so every value calls the same code and runs the same
    two kernels. ``check_tiling`` (the default) raises for
    ``n % 128 != 0`` as the JAX kernel does; K6 and K7 take any n, and
    ``krylov.lanczos.tridiag``'s dispatch passes ``check_tiling=False``.
    """
    del stream
    offsets = _fused_offsets(dia, check_tiling)

    def estimate(v0, vals):
        xs, alphas, betas, x_res, beta_res = _FusedLanczos.apply(offsets, krylov_depth, v0, vals)
        return (xs, (alphas, betas)), (x_res, beta_res)

    return estimate
