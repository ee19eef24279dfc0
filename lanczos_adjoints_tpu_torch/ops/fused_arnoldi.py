"""Fused Arnoldi over a DIA operator: the CUDA kernel K9 and its plain version.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_arnoldi.py``. K9
(``csrc/arnoldi_dia.cu`` ``lat_arnoldi_dia_forward``) runs the whole
K-step Arnoldi recurrence in one launch: the DIA matvec, classical
Gram-Schmidt against the basis rows written so far (twice, with the DGKS
truncation, for ``reortho="full"``), the guarded normalisation and the
Hessenberg matrix. Its plain version repeats the same arithmetic in
PyTorch. A wrapper launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no other path.

K9's launch is planned here, by ``launch_plan`` from the card's SM count
and shared memory, and only validated by the kernel: one block an SM,
contiguous rows a block, and either the block's slice of the basis
resident in shared memory (small n) or the basis streamed through staged
tiles, three sweeps a step with re-orthogonalisation and two without, or,
where the deepest staged tile would be shallower than ``MIN_TILE`` rows,
the same sweeps reading the basis from device memory a row a thread (the
direct path), so that any depth runs; where even the direct path's 2 x
depth coefficients do not fit in a block's shared memory, it keeps them
in device memory (``coef_floats`` of scratch the wrapper allocates).

``hessenberg_dia_fused`` is the drop-in ``krylov.arnoldi.hessenberg`` for
DIA operators: an autograd Function whose forward is K9 and whose
backward is the generic closed-form adjoint (``krylov.arnoldi._adjoint``).
An adjoint step needs ``A^T lam`` and ``d/dvals <lam, A q_i>`` but never
``A q_i`` itself, so the backward calls the DIA matvec's two backward
kernels directly: one transposed K4 and one K5 per step (``ops.fused_dia``),
and no forward K4. The JAX package takes the XLA roll matvec there, which
on the card would be a plain version on CUDA tensors.
"""

import dataclasses

import torch

from lanczos_adjoints_tpu_torch.krylov import arnoldi
from lanczos_adjoints_tpu_torch.ops import fused_dia, native
from lanczos_adjoints_tpu_torch.ops.fused_lanczos import guarded_div

ARNOLDI_FORWARD = native.Kernel("arnoldi_dia_forward", "arnoldi_dia", "lat_arnoldi_dia_forward",
                                device_symbol="arnoldi_forward_kernel")
LANES = 128  # the JAX kernel's lane width, kept for its n % 128 rule

THREADS = 512  # a K9 block's computing threads (the streamed path adds a producer warp)
MAX_BLOCK_THREADS = 544  # kMaxThreads in csrc/arnoldi_dia.cu
STAGES = 2  # K9's staging buffers on the streamed path (kStages)
SMEM_RESERVE = 1024  # bytes of a block's shared memory the plan leaves free
MIN_TILE = 32  # kMinTile: the fewest rows of a staged tile
PATHS = ("resident", "streamed", "direct")  # the kernel's path argument, by index


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """K9's launch: ``blocks`` of ``threads`` computing threads, block b
    owning rows ``[b rows, (b + 1) rows)``. ``path`` is ``"resident"`` (the
    block's slice of the basis in shared memory), ``"streamed"`` (the
    basis staged in tiles through ``STAGES`` buffers of ``stage_floats`` by
    one more warp, the producer) or ``"direct"`` (the basis read from
    device memory, a row a thread)."""

    path: str
    blocks: int
    threads: int
    rows: int
    stage_floats: int
    smem_bytes: int
    partial_floats: int
    depth: int
    num_diags: int
    sweeps: int
    coef_floats: int = 0  # the direct path's coefficients in device memory, else 0

    @property
    def block_threads(self) -> int:
        return self.threads + (32 if self.path == "streamed" else 0)

    def tile_rows(self, step: int, sweep: str = "B") -> int:
        """Rows of a tile at step ``step`` (the kernel's ``Stream::tile``):
        on the streamed path the largest multiple of 4 such that a buffer
        holds the tile, at most ``rows`` and ``threads``; the block's rows
        on the resident path, ``min(rows, threads)`` on the direct one. A B
        or C tile is Q[:step+1] and w; an A tile Q[:step], the D rows of the
        values and D + 1 windows of T + 4 floats of the previous residual."""
        if self.path != "streamed":
            return self.rows if self.path == "resident" else min(self.rows, self.threads)
        return _staged_rows(self.stage_floats, step, self.num_diags, sweep == "A", self.rows, self.threads)


def _staged_rows(stage, step, num_diags, a, rows, threads):
    """The kernel's ``tile_rows``."""
    if a:
        t = (stage - 4 * (num_diags + 1)) // (step + 2 * num_diags + 1)
    else:
        t = stage // (step + 2)
    return min(rows, threads, t // 4 * 4)


def head_floats(num_diags):
    """Shared memory of a K9 block ahead of its coefficients (``head_floats``
    in csrc/arnoldi_dia.cu): the staged offsets (a multiple of 4), one float
    per warp and eight mbarriers."""
    return -(-num_diags // 4) * 4 + 32 + 16


def _padded_depth(depth):
    return (depth + 4) // 4 * 4


def _smem_bytes(depth, threads, rows, path, stage_floats, num_diags, coefs_on_chip=True):
    """The kernel's ``smem_floats`` in bytes."""
    head = head_floats(num_diags) + (2 * _padded_depth(depth) if coefs_on_chip else 0) + threads
    if path == "resident":
        return 4 * (head + (depth + 1) * rows)
    return 4 * (head + 2 * threads + (STAGES * stage_floats if path == "streamed" else 0))


def stage_floats(depth, threads, rows, budget, num_diags):
    """Floats of each of the streamed path's ``STAGES`` buffers: as large as
    the ``budget`` bytes of shared memory left by the rest of its layout
    allow, a multiple of 4."""
    free = (budget - _smem_bytes(depth, threads, rows, "streamed", 0, num_diags)) // 4
    return max(0, free // STAGES // 4 * 4)


def launch_plan(n, depth, reortho, sms, smem_per_block, *, num_diags):
    """K9's launch on a card of ``sms`` SMs and ``smem_per_block`` bytes of
    opt-in shared memory a block.

    ``num_diags`` is the operator's number of diagonals (an A tile stages
    the values and the windows of the previous residual they multiply).
    One block an SM at most, each owning ``rows`` contiguous rows (n / sms
    rounded up to a multiple of 4), of ``THREADS`` computing threads. The
    resident path where the block's (depth + 1) x rows floats (basis slice
    and w) fit beside the coefficients, else the streamed path with the
    staging buffers as large as the rest of the shared memory allows, else
    (its deepest A tile would hold fewer than ``MIN_TILE`` rows, or than
    the block's rows where those are fewer) the direct path; any depth
    runs: where the direct path's coefficients do not fit beside the rest
    of its layout, they go to device memory (``coef_floats``, 2 x depth
    rounded up a block). A card whose shared memory cannot hold even that
    layout raises ``ValueError``.
    """
    arnoldi.check_option(reortho)
    if not 0 < depth <= n:
        msg = f"no K9 plan for n={n}, depth={depth}"
        raise ValueError(msg)
    rows = -(-(-(-n // sms)) // 4) * 4
    blocks = -(-n // rows)
    budget = smem_per_block - SMEM_RESERVE
    path, stage, coefs = "resident", 0, True
    if _smem_bytes(depth, THREADS, rows, path, 0, num_diags) > budget:
        path, stage = "streamed", stage_floats(depth, THREADS, rows, budget, num_diags)
        if _staged_rows(stage, depth - 1, num_diags, True, rows, THREADS) < min(MIN_TILE, rows):
            path, stage = "direct", 0
            coefs = _smem_bytes(depth, THREADS, rows, path, 0, num_diags) <= budget
    smem = _smem_bytes(depth, THREADS, rows, path, stage, num_diags, coefs)
    if smem > budget:
        msg = f"K9 needs {smem} bytes of shared memory a block at depth {depth}; the card has {budget}"
        raise ValueError(msg)
    return LaunchPlan(path=path, blocks=blocks, threads=THREADS, rows=rows, stage_floats=stage,
                      smem_bytes=smem, partial_floats=(2 * depth + 3) * -(-blocks // 4) * 4, depth=depth,
                      num_diags=num_diags, sweeps=3 if reortho == "full" else 2,
                      coef_floats=0 if coefs else 2 * _padded_depth(depth) * blocks)


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
        plan = launch_plan(n, depth, reortho, *native.device_limits(device), num_diags=len(offsets))
        return launch_forward(offsets, vals, v0, reortho, plan)


def launch_forward(offsets, vals, v0, reortho, plan):
    """K9 on CUDA tensors with the given ``plan`` (``launch_plan``'s, or one
    made for another card's limits); the kernel validates it."""
    device, n, depth = v0.device, v0.shape[0], plan.depth
    with torch.cuda.device(device):
        # The streamed path's bulk copies read 16-byte aligned rows.
        vals, v0 = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (vals, v0))

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        q, h, res, inv_norm = empty(depth, n), empty(depth, depth), empty(n), empty(1)
        wbuf, partials = empty(2, n), empty(plan.partial_floats)
        coefs = empty(plan.coef_floats) if plan.coef_floats else None
        counter = torch.zeros(1, dtype=torch.int32, device=device)  # the grid barrier's
        ARNOLDI_FORWARD.launch(
            vals.data_ptr(), v0.data_ptr(), q.data_ptr(), h.data_ptr(), res.data_ptr(),
            inv_norm.data_ptr(), wbuf.data_ptr(), partials.data_ptr(), counter.data_ptr(),
            None if coefs is None else coefs.data_ptr(), n,
            len(offsets), native.offsets_arg(offsets, n, device).data_ptr(), depth, int(reortho == "full"),
            plan.blocks, plan.threads, plan.rows, PATHS.index(plan.path),
            plan.stage_floats, plan.smem_bytes, native.stream(device),
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
