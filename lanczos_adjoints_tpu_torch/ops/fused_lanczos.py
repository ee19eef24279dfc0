"""Fused Lanczos over a DIA operator: the CUDA kernels K6 and K7 and their plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_lanczos.py``:

- K6 (``csrc/lanczos_dia.cu`` ``lat_lanczos_dia_forward``) runs the whole
  K-step three-term recurrence in one launch and writes the basis
  ``(K+1, n)``, the alphas and the betas;
- K7 (``lat_lanczos_dia_adjoint``) runs the whole reverse closed-form
  adjoint in one launch: per step the (xi, mu, nu, lambda) update,
  ``A lambda`` and ``dvals[k] += x * roll(lambda, -d_k)``; then ``dv``.

Both launches are planned here, by ``forward_plan`` and ``adjoint_plan``
from the card's SM count and shared memory, and only validated by the
kernels. K6 takes one of two paths. On the ``grid`` path at most one
block an SM owns contiguous rows, with its rows of the values in shared
memory for all K steps (all D diagonals, or as many as fit), and two grid
barriers a step; where it fits beside the values, a block's matvec reads
x from a window in shared memory (``window_table``), else from device
memory. On the ``cluster`` path, for n up to ``CLUSTER_MAX_N``, one
thread block cluster of ``CLUSTER_BLOCKS`` blocks runs the whole
recurrence in shared memory, the window of x included, with the
cluster's barriers. K7 likewise puts
at most one block on an SM, each owning contiguous rows, with the block's
slice of ``dvals`` in shared memory for all K steps: all of it
(``resident``) or, where it does not fit, as many of its diagonals as do,
the others read-modify-written in device memory (``streamed``). Both keep
the block's rows of their state in registers where a thread owns at most
``SLOTS`` rows.

Divides are guarded as in the JAX package: a zero norm (an exhausted
Krylov space) truncates to zero vectors instead of 0 / 0. A wrapper
launches its kernel for CUDA tensors and runs the plain PyTorch version
(a Python loop over the same recurrence) for CPU tensors; there is no
other path. ``tridiag_dia_fused`` is the drop-in for
``krylov.lanczos.tridiag(..., reortho="none")`` on DIA operators, with
the forward as K6 and the backward as K7.
"""

import dataclasses
import functools

import torch

from lanczos_adjoints_tpu_torch.ops import fused_dia, native
from lanczos_adjoints_tpu_torch.utils import spans

LANCZOS_FORWARD = native.Kernel("lanczos_dia_forward", "lanczos_dia", "lat_lanczos_dia_forward",
                                device_symbol="lanczos_forward_kernel")
LANCZOS_ADJOINT = native.Kernel("lanczos_dia_adjoint", "lanczos_dia", "lat_lanczos_dia_adjoint",
                                device_symbol="lanczos_adjoint_kernel")
LANES = 128  # the JAX kernel's lane width, kept for its n % 128 rule

ADJOINT_THREADS = 512  # kAdjThreads in csrc/lanczos_dia.cu: K7's threads a block at most
SLOTS = 16  # kSlots and kFwdSlots: rows a K6 or K7 thread keeps in registers
WARP_SUMS = 3 * ADJOINT_THREADS // 32  # floats of K7's block sums
SMEM_RESERVE = 1024  # bytes of a block's shared memory the plan leaves free

FORWARD_THREADS = 512  # kFwdThreads: K6's threads a block at most
# kFwdSums: floats of K6's block sums, one a warp, two totals (padded to
# 4), and two slots of warp sums from each of up to 16 (kMaxCluster)
# blocks of a cluster.
FORWARD_SUMS = FORWARD_THREADS // 32 * (1 + 2 * 16) + 4
FEW_SLOTS = 4  # kFwdFewSlots: K6's instantiations for a thread of at most 4 rows
# K6's cluster path: one cluster of this many blocks (kMaxCluster, the
# non-portable size), taken for n up to CLUSTER_MAX_N where the values, r
# and the window of x fit the cluster's shared memory and a thread owns
# at most FEW_SLOTS rows. On an H100 (scripts/torch_kernel_variants.py
# --only k6, the 2-D Laplacian at K = 90) 16 blocks read 0.416 ms at
# n = 16,384 against 0.425 on 8 and 0.453 on the grid path; at 65,536 the
# grid path leads (0.516 against 0.814 ms), so the cluster stops at 16,384.
CLUSTER_BLOCKS = 16
CLUSTER_MAX_N = 16_384


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """K6's launch: ``blocks`` of ``threads`` threads, block b owning rows
    ``[b rows, (b + 1) rows)``, the first ``resident_diags`` diagonals of the
    block's rows of the values in shared memory for all steps and the others
    read from device memory each step. ``path`` is ``"grid"`` (one block an
    SM at most, r in device memory, grid barriers) or ``"cluster"`` (the
    blocks are one thread block cluster, r in their shared memory, cluster
    barriers). ``window`` is the floats of the block's window of x in shared
    memory, 0 where the matvec reads x from device memory instead.
    ``values`` is ``"resident"`` where all diagonals stay in shared memory,
    else ``"streamed"``; ``slots`` is the rows a thread keeps in registers
    (``FEW_SLOTS`` or ``SLOTS``, the kernel's instantiation), 0 where it
    owns more than ``SLOTS`` and ``state`` is ``"device"``, not
    ``"registers"``."""

    path: str
    resident_diags: int
    window: int
    blocks: int
    threads: int
    rows: int
    smem_bytes: int
    partial_floats: int
    depth: int
    num_diags: int

    @property
    def values(self) -> str:
        return "resident" if self.resident_diags == self.num_diags else "streamed"

    @property
    def slots(self) -> int:
        per_thread = -(-self.rows // self.threads)
        return FEW_SLOTS if per_thread <= FEW_SLOTS else SLOTS if per_thread <= SLOTS else 0

    @property
    def state(self) -> str:
        return "registers" if self.slots else "device"


@dataclasses.dataclass(frozen=True)
class AdjointPlan:
    """K7's launch: ``blocks`` of ``threads`` threads, block b owning rows
    ``[b rows, (b + 1) rows)``, the first ``resident_diags`` diagonals of
    the block's slice of dvals in shared memory for all steps and the
    others accumulated in device memory. ``path`` is ``"resident"`` where
    that is all of them, else ``"streamed"``; ``state`` is ``"registers"``
    where a thread owns at most ``SLOTS`` rows, else ``"device"``."""

    resident_diags: int
    blocks: int
    threads: int
    rows: int
    smem_bytes: int
    partial_floats: int
    depth: int
    num_diags: int

    @property
    def path(self) -> str:
        return "resident" if self.resident_diags == self.num_diags else "streamed"

    @property
    def slots(self) -> int:
        per_thread = -(-self.rows // self.threads)
        return FEW_SLOTS if per_thread <= FEW_SLOTS else SLOTS if per_thread <= SLOTS else 0

    @property
    def state(self) -> str:
        return "registers" if self.slots else "device"


def _round4(count):
    return -(-count // 4) * 4


def adjoint_smem_bytes(num_diags, rows, resident_diags):
    """The kernel's ``adjoint_smem_floats`` in bytes: the offsets, the block
    sums and the ``resident_diags x rows`` slice of dvals."""
    return 4 * (_round4(num_diags) + WARP_SUMS + resident_diags * rows)


def adjoint_plan(n, depth, sms, smem_per_block, *, num_diags):
    """K7's launch on a card of ``sms`` SMs and ``smem_per_block`` bytes of
    opt-in shared memory a block.

    One block an SM at most, each owning ``rows`` contiguous rows (n / sms
    rounded up to a multiple of 4), of ``ADJOINT_THREADS`` threads (fewer,
    a multiple of 32, where the rows are fewer). As many of the block's
    diagonals of dvals in shared memory as fit, up to all of them; any n
    and depth run.
    """
    if not 0 < depth <= n or num_diags < 1:
        msg = f"no K7 plan for n={n}, depth={depth}, {num_diags} diagonals"
        raise ValueError(msg)
    rows = _round4(-(-n // sms))
    blocks = -(-n // rows)
    threads = min(ADJOINT_THREADS, -(-rows // 32) * 32)
    budget = smem_per_block - SMEM_RESERVE
    base = adjoint_smem_bytes(num_diags, rows, 0)
    if base > budget:
        msg = f"K7 needs {base} bytes of shared memory a block for {num_diags} diagonals; the card has {budget}"
        raise ValueError(msg)
    resident = min(num_diags, (budget - base) // (4 * rows))
    smem = adjoint_smem_bytes(num_diags, rows, resident)
    return AdjointPlan(resident_diags=resident, blocks=blocks, threads=threads, rows=rows, smem_bytes=smem,
                       partial_floats=3 * _round4(blocks), depth=depth, num_diags=num_diags)


def forward_smem_bytes(num_diags, rows, resident_diags, path, window=0):
    """The kernel's ``forward_smem_floats`` in bytes: the offsets and the
    window table (3 D + 4 ints), the block sums, the ``resident_diags x rows``
    slice of the values, on the cluster path the block's rows of r, and the
    window of x."""
    return 4 * (_round4(num_diags) + _round4(3 * num_diags + 4) + FORWARD_SUMS
                + (resident_diags + (path == "cluster")) * rows + window)


def _signed(offset, n):
    offset %= n
    return offset - n if offset > n // 2 else offset


def window_table(offsets, n, rows):
    """K6's window of x for a block of ``rows`` rows: ``(floats, table)``.

    The window holds the rows a block's matvec reads, as the merged spans
    ``[d, d + rows)`` of its offsets (taken into (-n/2, n/2]) and its own
    rows ``[0, rows)``, relative to the block's first row. The table (the
    kernel's ``stage_halo``): the window index of the block's first row,
    the number of spans, each span's (window index, first row relative to
    the block's), then each diagonal's window index of row ``d_k``; padded
    to 3 D + 4 ints.
    """
    spans = []
    for lo, hi in sorted({(_signed(d, n), _signed(d, n) + rows) for d in offsets} | {(0, rows)}):
        if spans and lo <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], hi)
        else:
            spans.append([lo, hi])
    starts = [0]
    for lo, hi in spans:
        starts.append(starts[-1] + hi - lo)

    def index(rel):
        return next(start + rel - lo for (lo, hi), start in zip(spans, starts) if lo <= rel < hi)

    table = [index(0), len(spans), *(v for (lo, _hi), start in zip(spans, starts) for v in (start, lo)),
             *(index(_signed(d, n)) for d in offsets)]
    return starts[-1], table + [0] * (3 * len(offsets) + 4 - len(table))


def forward_plan(n, depth, sms, smem_per_block, *, offsets):
    """K6's launch for the DIA operator of ``offsets`` on a card of ``sms``
    SMs and ``smem_per_block`` bytes of opt-in shared memory a block.

    For n up to ``CLUSTER_MAX_N`` the cluster path, where each of
    ``CLUSTER_BLOCKS`` blocks holds its rows of the values, of r and its
    window of x (``window_table``) and a thread owns at most ``FEW_SLOTS``
    rows; else the grid path: one block an SM at most, each owning ``rows``
    contiguous rows (n / sms rounded up to a multiple of 4), of
    ``FORWARD_THREADS`` threads (fewer, a multiple of 32, where the rows
    are fewer), with as many of the block's diagonals of the values in
    shared memory as fit, up to all of them, and the block's window of x
    in the shared memory they leave where it fits (else the matvec reads x
    from device memory). Any n and depth run.
    """
    num_diags = len(offsets)
    if not 0 < depth <= n or num_diags < 1:
        msg = f"no K6 plan for n={n}, depth={depth}, {num_diags} diagonals"
        raise ValueError(msg)
    budget = smem_per_block - SMEM_RESERVE
    if n <= CLUSTER_MAX_N:
        rows = _round4(-(-n // CLUSTER_BLOCKS))
        threads = min(FORWARD_THREADS, -(-rows // 32) * 32)
        window = window_table(offsets, n, rows)[0]
        smem = forward_smem_bytes(num_diags, rows, num_diags, "cluster", window)
        if smem <= budget and -(-rows // threads) <= FEW_SLOTS:
            return ForwardPlan(path="cluster", resident_diags=num_diags, window=window, blocks=CLUSTER_BLOCKS,
                               threads=threads, rows=rows, smem_bytes=smem, partial_floats=0, depth=depth,
                               num_diags=num_diags)
    rows = _round4(-(-n // sms))
    blocks = -(-n // rows)
    threads = min(FORWARD_THREADS, -(-rows // 32) * 32)
    base = forward_smem_bytes(num_diags, rows, 0, "grid")
    if base > budget:
        msg = f"K6 needs {base} bytes of shared memory a block for {num_diags} diagonals; the card has {budget}"
        raise ValueError(msg)
    resident = min(num_diags, (budget - base) // (4 * rows))
    window = window_table(offsets, n, rows)[0]
    if forward_smem_bytes(num_diags, rows, resident, "grid", window) > budget:
        window = 0
    return ForwardPlan(path="grid", resident_diags=resident, window=window, blocks=blocks, threads=threads, rows=rows,
                       smem_bytes=forward_smem_bytes(num_diags, rows, resident, "grid", window),
                       partial_floats=2 * _round4(blocks), depth=depth, num_diags=num_diags)


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
    with torch.cuda.device(device):
        operator = tuple(int(d) for d in offsets)
        plan = _forward_plan(n, depth, operator, device)

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        xs, coef = empty(depth + 1, n), empty(2, depth)
        grid = plan.path == "grid"
        # r, and w where the state is in device memory; the partials and
        # the barrier's counter: the grid path's alone.
        scratch = empty(1 if plan.state == "registers" else 2, n) if grid else None
        partials = empty(plan.partial_floats) if grid else None
        counter = torch.zeros(1, dtype=torch.int32, device=device) if grid else None
        table = _window_arg(operator, n, plan.rows, xs.device) if plan.window else None
        LANCZOS_FORWARD.launch(
            vals.data_ptr(), v0.data_ptr(), xs.data_ptr(), coef[0].data_ptr(), coef[1].data_ptr(),
            *(None if t is None else t.data_ptr() for t in (scratch, partials, counter)),
            n, len(offsets), native.offsets_arg(offsets, n, device).data_ptr(),
            None if table is None else table.data_ptr(), depth, int(not grid), plan.blocks,
            plan.threads, plan.rows, plan.resident_diags, plan.window, plan.smem_bytes, native.stream(device),
        )
    return xs, coef[0], coef[1]


@functools.lru_cache(maxsize=64)
def _forward_plan(n, depth, offsets, device):
    """``forward_plan`` on ``device``, made once for each operator and depth."""
    return forward_plan(n, depth, *native.device_limits(device), offsets=offsets)


@functools.lru_cache(maxsize=64)
def _window_arg(offsets, n, rows, device):
    """``window_table``'s table as an int32 tensor on ``device``, built once
    for each operator and block size."""
    return torch.tensor(window_table(offsets, n, rows)[1], dtype=torch.int32, device=device)


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
    with torch.cuda.device(device):
        plan = adjoint_plan(n, depth, *native.device_limits(device), num_diags=len(offsets))

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        dv, dvals, xi, lam, partials = empty(n), empty(*vals.shape), empty(n), empty(2, n), empty(
            plan.partial_floats)
        counter = torch.zeros(1, dtype=torch.int32, device=device)  # the grid barrier's
        LANCZOS_ADJOINT.launch(
            vals.data_ptr(), xs.data_ptr(), dxs.data_ptr(), alphas.data_ptr(),
            betas.data_ptr(), dalphas.data_ptr(), dbetas.data_ptr(), inv_norm.data_ptr(),
            dv.data_ptr(), dvals.data_ptr(), xi.data_ptr(), lam.data_ptr(),
            partials.data_ptr(), counter.data_ptr(), n, len(offsets),
            native.offsets_arg(offsets, n, device).data_ptr(), depth, plan.blocks, plan.threads,
            plan.rows, plan.resident_diags, plan.smem_bytes, native.stream(device),
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
    @spans.spanned("lanczos.dia_forward")
    def forward(ctx, offsets, depth, v0, vals):
        v0, vals = v0.contiguous(), vals.contiguous()
        xs, alphas, betas = lanczos_forward_rows(offsets, vals, v0, depth)
        ctx.offsets = offsets
        # The whole basis and all betas are saved: they are the
        # concatenation of the decomposition with its residual entries.
        ctx.save_for_backward(xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0), vals)
        return xs[:-1], alphas, betas[:-1], xs[-1], betas[-1]

    @staticmethod
    @spans.spanned("lanczos.dia_adjoint")
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
