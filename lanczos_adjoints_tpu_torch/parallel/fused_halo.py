"""The row-partitioned DIA matvec with its halo exchange: the CUDA kernel K11.

Counterpart of ``lanczos_adjoints_tpu/parallel/pallas_halo.py``. The
operator's n rows are split into P contiguous partitions of
``local_n = n / P`` rows on a ring; with ``halo = max(1, max |d_k|)``,
partition p extends its segment of ``v`` by the last ``halo`` entries of
its left neighbour and the first ``halo`` of its right one,
``ext_p = [v_l[-halo:], v_p, v_r[:halo]]``, and computes

    out_p[i] = sum_k vals_p[k, i] * ext_p[halo + i + d_k],

which is K4's circular product ``out[i] = sum_k vals[k, i] *
v[(i + d_k) mod n]`` on the whole vector, for any values.

- ``halo_dia_plain`` is the PyTorch halo body (the JAX package's
  ``ppermute`` operator): all partitions' extended segments as one
  ``(P, local_n + 2 halo)`` tensor, summed in K4's order.
- ``halo_dia_rows`` (global tensors) and ``halo_dia_parts`` (one tensor
  per partition) launch K11 (``csrc/halo_dia.cu``
  ``lat_halo_dia_matvec``) for CUDA tensors and run the plain version for
  CPU tensors; there is no other path. K11 computes every partition's
  rows in one plain launch, each partition reading its neighbours'
  halos where they lie: nothing is sent, flagged or waited on.
  ``halo_plan`` (made once for each operator and card) picks 4 rows a
  thread with float4 loads where the local rows allow it; a launch whose
  values or output are not 16-byte aligned takes 1 row a thread.
- ``sharded_dia_operator_fused`` wraps them in an autograd Function with
  the JAX Pallas operator's symmetric VJP: ``dv`` is K11 on the
  cotangent, ``dvals[k, i] = u[i] ext[halo + d_k + i]`` is PyTorch ops,
  as the JAX package leaves it to XLA.
"""

import contextlib
import ctypes
import dataclasses
import functools

import torch

from lanczos_adjoints_tpu_torch.ops import fused_dia, native

HALO_DIA = native.Kernel("halo_dia_matvec", "halo_dia", "lat_halo_dia_matvec",
                         device_symbol="halo_dia_kernel")
# The same C entry point on the transposed operator (the non-symmetric
# VJP of ``parallel.sharded.sharded_dia_operator``): counted apart.
HALO_DIA_T = native.Kernel("halo_dia_matvec_transposed", "halo_dia", "lat_halo_dia_matvec",
                           device_symbol="halo_dia_kernel")
LANES, SUBLANES = 128, 8  # the JAX kernel's tiling, kept for its errors


def halo_width(offsets) -> int:
    return max(1, max(abs(int(d)) for d in offsets))


def _halo_rows(halo: int) -> int:
    """The JAX kernel's halo rows: ceil(halo / 128) rounded up to 8."""
    rows = -(-halo // LANES)
    return -(-rows // SUBLANES) * SUBLANES


def _extended(v, n_partitions, halo):
    """``(P, local_n + 2 halo)``: each partition's segment between its
    left neighbour's tail and its right neighbour's head."""
    parts = v.reshape(n_partitions, -1)
    from_left = torch.roll(parts, 1, dims=0)[:, parts.shape[1] - halo :]
    from_right = torch.roll(parts, -1, dims=0)[:, :halo]
    return torch.cat([from_left, parts, from_right], dim=1)


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernel's oracle on the card)
# ---------------------------------------------------------------------------


def halo_dia_plain(offsets, v, vals, n_partitions: int, *, fused: bool = False):
    """Plain K11: ``v (n,)``, ``vals (D, n)`` -> ``(n,)``, any dtype.

    ``halo`` may reach ``local_n``, as in the JAX ``ppermute`` operator.
    The terms are summed in K4's order; each product and sum are rounded
    apart, as ``fused_dia.dia_matvec_plain`` rounds them, or with
    ``fused`` each term is added by ``torch.addcmul``, which rounds once
    where the device fuses the multiply and the add, as K4's and K11's
    ``fmaf`` does.
    """
    n = v.shape[0]
    halo = halo_width(offsets)
    local_n = n // n_partitions
    ext = _extended(v, n_partitions, halo)
    out = torch.zeros((n_partitions, local_n), dtype=v.dtype, device=v.device)
    for k, d in enumerate(offsets):
        start = halo + d
        w, x = vals[k].reshape(n_partitions, local_n), ext[:, start : start + local_n]
        out = torch.addcmul(out, w, x) if fused else out + w * x
    return out.reshape(n)


def halo_dvals_plain(offsets, v, u, n_partitions: int):
    """The value gradient ``dvals[k, i] = u[i] * ext[halo + d_k + i]`` -> ``(D, n)``."""
    n = v.shape[0]
    halo = halo_width(offsets)
    local_n = n // n_partitions
    ext = _extended(v, n_partitions, halo)
    u_parts = u.reshape(n_partitions, local_n)
    rows = [u_parts * ext[:, halo + d : halo + d + local_n] for d in offsets]
    return torch.stack(rows).reshape(len(offsets), n)


# ---------------------------------------------------------------------------
# The launch plan and the wrappers
# ---------------------------------------------------------------------------

VECTOR_ROWS = 4  # rows a thread on the vector path (float4 values and output)
BLOCKS_PER_SM = 8  # 2,048 resident threads an SM in blocks of 256 (kThreads of csrc/halo_dia.cu)
# K11's launches by rows a thread (both kernels), for a run to show which
# path its launches took.
LAUNCHES_BY_ROWS = {1: 0, VECTOR_ROWS: 0}


def check_ring(offsets, n: int, n_partitions: int) -> int:
    """``local_n``; raises ``ValueError`` on what K11 does not take."""
    if not offsets:
        raise ValueError("a DIA operator needs at least one diagonal")
    if not 0 < n_partitions <= native.MAX_PARTITIONS:
        msg = f"{n_partitions} partitions; the halo kernel takes 1 to {native.MAX_PARTITIONS}"
        raise ValueError(msg)
    if n % n_partitions != 0:
        msg = f"n={n} must divide evenly over {n_partitions} partitions"
        raise ValueError(msg)
    local_n, halo = n // n_partitions, halo_width(offsets)
    if halo > local_n:
        msg = f"halo {halo} exceeds local rows {local_n}"
        raise ValueError(msg)
    return local_n


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """K11's launch for one operator on one card (``halo_plan``).

    ``vector``: 4 rows a thread, with float4 loads of the values and
    float4 stores of the output, where ``local_n % 4 == 0`` (each launch
    then also needs the pointers aligned: ``rows``); else 1 row a thread.
    ``max_blocks``: blocks a partition at most, one wave of the card's
    ``BLOCKS_PER_SM`` blocks an SM split over the partitions; the
    kernel's grid-stride loop covers what they do not. The vector path
    needs fewer blocks than that at n = 2^20 (1,024 over all partitions);
    the scalar path (28 registers, 8 blocks an SM) runs as one wave.
    """

    n_partitions: int
    local_n: int
    halo: int
    vector: bool
    max_blocks: int

    def rows(self, ld: int, *pointers: int) -> int:
        """Rows a thread for one launch: ``VECTOR_ROWS`` on the vector path
        where the values' row stride ``ld`` is a multiple of 4 and every
        pointer the kernel reads or writes by float4 (each partition's
        values and output) is 16-byte aligned, else 1."""
        aligned = ld % VECTOR_ROWS == 0 and all(p % 16 == 0 for p in pointers)
        return VECTOR_ROWS if self.vector and aligned else 1


def halo_plan(offsets, n: int, n_partitions: int, sms: int) -> HaloPlan:
    """K11's plan for ``n`` rows over ``n_partitions`` on a card of ``sms``
    SMs; raises ``ValueError`` where ``check_ring`` does."""
    local_n = check_ring(offsets, n, n_partitions)
    return HaloPlan(n_partitions=n_partitions, local_n=local_n, halo=halo_width(offsets),
                    vector=local_n % VECTOR_ROWS == 0,
                    max_blocks=max(1, BLOCKS_PER_SM * sms // n_partitions))


@functools.lru_cache(maxsize=64)
def _launch_args(offsets, n, n_partitions, device):
    """``(plan, host offsets, device offsets)``, made once for each operator
    and device."""
    plan = halo_plan(offsets, n, n_partitions, native.device_limits(device)[0])
    return plan, (ctypes.c_int * len(offsets))(*offsets), native.offsets_arg(offsets, None, device)


def _device(device):
    """``torch.cuda.device(device)`` where it is not the current device already."""
    return contextlib.nullcontext() if device.index == torch.cuda.current_device() else torch.cuda.device(device)


def _stream(device) -> int:
    """PyTorch's current stream on ``device``: ``native.stream``'s handle,
    read without building a ``torch.cuda.Stream`` (0.2 against 3-6 us a
    call on the card's host, ``k11_host``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def halo_dia_parts(offsets, v_parts, vals_parts):
    """K11 on one tensor per partition: ``v_parts[p] (local_n,)``,
    ``vals_parts[p] (D, local_n)`` (rows contiguous, one row stride for
    all) -> ``out_parts``, a list of ``(local_n,)`` tensors."""
    n_partitions = len(v_parts)
    if len(vals_parts) != n_partitions:
        msg = f"{len(v_parts)} segments, {len(vals_parts)} value blocks"
        raise ValueError(msg)
    device = fused_dia.check_operands(*v_parts, *(w[0] for w in vals_parts))
    local_n = v_parts[0].shape[0]
    for v_p, w in zip(v_parts, vals_parts):
        if v_p.shape != (local_n,) or w.shape != (len(offsets), local_n):
            msg = f"shape mismatch: v {tuple(v_p.shape)}, vals {tuple(w.shape)}, {len(offsets)} offsets"
            raise ValueError(msg)
    check_ring(offsets, local_n * n_partitions, n_partitions)
    if device.type == "cpu":
        out = halo_dia_plain(offsets, torch.cat(v_parts), torch.cat(vals_parts, dim=1), n_partitions)
        return list(out.reshape(n_partitions, local_n))
    ld = vals_parts[0].stride(0)
    if any(w.stride() != (ld, 1) for w in vals_parts):
        raise ValueError("the value blocks must share one row stride and have contiguous rows")
    out_parts = [torch.empty_like(v_p) for v_p in v_parts]
    offsets = tuple(int(d) for d in offsets)
    plan, offsets_host, offsets_dev = _launch_args(offsets, local_n * n_partitions, n_partitions, device)
    tables = [_pointers(ts) for ts in (v_parts, vals_parts, out_parts)]
    rows = plan.rows(ld, *tables[1], *tables[2])
    with _device(device):
        HALO_DIA.launch(*tables, 1, n_partitions, local_n, ld, plan.halo, len(offsets), offsets_host,
                        offsets_dev.data_ptr(), rows, plan.max_blocks, _stream(device))
    LAUNCHES_BY_ROWS[rows] += 1
    return out_parts


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def halo_dia_rows(offsets, v, vals, n_partitions: int, *, kernel=HALO_DIA):
    """K11 on global tensors: ``v (n,)``, ``vals (D, n)`` -> ``(n,)``.

    Partition p's segment, value columns and output are rows
    ``[p local_n, (p + 1) local_n)`` of the tensors, which the kernel
    finds from their base pointers; the output is one tensor.
    """
    device = fused_dia.check_operands(v, vals)
    n = v.shape[0]
    if v.ndim != 1 or vals.shape != (len(offsets), n):
        msg = f"shape mismatch: v {tuple(v.shape)}, vals {tuple(vals.shape)}, {len(offsets)} offsets"
        raise ValueError(msg)
    if device.type == "cpu":
        check_ring(offsets, n, n_partitions)
        return halo_dia_plain(offsets, v, vals, n_partitions)
    plan, offsets_host, offsets_dev = _launch_args(tuple(offsets), n, n_partitions, device)
    out = torch.empty_like(v)
    vals_ptr, out_ptr = vals.data_ptr(), out.data_ptr()
    rows = plan.rows(n, vals_ptr, out_ptr)
    with _device(device):
        kernel.launch(v.data_ptr(), vals_ptr, out_ptr, 0, n_partitions, plan.local_n, n, plan.halo,
                      len(offsets), offsets_host, offsets_dev.data_ptr(), rows, plan.max_blocks, _stream(device))
    LAUNCHES_BY_ROWS[rows] += 1
    return out


# ---------------------------------------------------------------------------
# The differentiable operator
# ---------------------------------------------------------------------------


class _HaloDiaMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, offsets, n_partitions, symmetric, v, vals):
        ctx.offsets, ctx.n_partitions, ctx.symmetric = offsets, n_partitions, symmetric
        ctx.save_for_backward(v, vals)
        return halo_dia_rows(offsets, v.contiguous(), vals.contiguous(), n_partitions)

    @staticmethod
    def backward(ctx, u):
        v, vals = ctx.saved_tensors
        offsets, n_partitions = ctx.offsets, ctx.n_partitions
        u = u.contiguous()
        dv = dvals = None
        if ctx.needs_input_grad[3]:
            if ctx.symmetric:
                dv = halo_dia_rows(offsets, u, vals.contiguous(), n_partitions)
            else:
                neg_offsets, vals_t = fused_dia.transposed(offsets, vals)
                dv = halo_dia_rows(neg_offsets, u, vals_t, n_partitions, kernel=HALO_DIA_T)
        if ctx.needs_input_grad[4]:
            dvals = halo_dvals_plain(offsets, v, u, n_partitions)
        return None, None, None, dv, dvals


def sharded_dia_operator_fused(dia, mesh, *, axis: str = "rows", check_tiling: bool = True,
                               symmetric: bool = True):
    """Halo-exchange DIA matvec ``matvec(v, vals)`` over the mesh's ``axis``.

    The calling convention of ``parallel.sharded.sharded_dia_operator``:
    ``v (n,)`` and ``vals (D, n)`` sharded along positions, the output
    sharded like ``v``. With ``check_tiling`` (the default) it raises
    where the JAX kernel does (``n % (P x 1024)``, local rows fewer than
    twice the halo rows); K11 itself takes any ``n % P == 0`` with
    ``halo <= local_n``. ``symmetric`` keeps the JAX Pallas operator's
    VJP, which assumes a symmetric operator (``dv = A u``);
    ``sharded_dia_operator`` builds it with ``symmetric=False``. The
    closure carries no ``.dia_data`` tag: ``tridiag`` runs its generic
    recursion over it, as over the JAX ``shard_map``.
    """
    offsets = tuple(int(d) for d in dia.offsets)
    n, n_partitions = dia.shape[0], mesh.shape[axis]
    if check_tiling:
        if n % (n_partitions * LANES * SUBLANES) != 0:
            msg = (
                f"n={n} must divide into {n_partitions} x {LANES * SUBLANES}-element"
                " row tiles for the fused halo kernel"
            )
            raise ValueError(msg)
        rows, hr = n // n_partitions // LANES, _halo_rows(halo_width(offsets))
        if rows < 2 * hr:
            msg = f"halo rows {hr} need local rows >= {2 * hr}, got {rows}"
            raise ValueError(msg)
    check_ring(offsets, n, n_partitions)

    def matvec(v, vals):
        return _HaloDiaMatvec.apply(offsets, n_partitions, symmetric, v, vals)

    return matvec
