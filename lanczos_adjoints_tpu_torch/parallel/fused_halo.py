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
  CPU tensors; there is no other path. K11 sends, sweeps, waits and fixes
  up the edges of every partition in one launch; ``HaloExchange`` holds
  the receive buffers, flags and epoch count it needs.
- ``sharded_dia_operator_fused`` wraps them in an autograd Function with
  the JAX Pallas operator's symmetric VJP: ``dv`` is K11 on the
  cotangent, ``dvals[k, i] = u[i] ext[halo + d_k + i]`` is PyTorch ops,
  as the JAX package leaves it to XLA.
"""

import ctypes
import math

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


def halo_dia_plain(offsets, v, vals, n_partitions: int):
    """Plain K11: ``v (n,)``, ``vals (D, n)`` -> ``(n,)``, any dtype.

    ``halo`` may reach ``local_n``, as in the JAX ``ppermute`` operator.
    """
    n = v.shape[0]
    halo = halo_width(offsets)
    local_n = n // n_partitions
    ext = _extended(v, n_partitions, halo)
    out = torch.zeros((n_partitions, local_n), dtype=v.dtype, device=v.device)
    for k, d in enumerate(offsets):
        start = halo + d
        out = out + vals[k].reshape(n_partitions, local_n) * ext[:, start : start + local_n]
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
# The kernel's state and wrappers
# ---------------------------------------------------------------------------


class HaloExchange:
    """Receive buffers, flags and the epoch count of one ring of partitions.

    Each partition owns its buffers: ``recv[p]`` ``(2, 2, halo)`` (epoch
    parity x side x entries; NaN until a neighbour writes them) and
    ``flags[p]`` ``(2,)`` (one per side, never reset). K11 reaches them
    through device tables of P pointers, built once per device. Every
    launch takes the next epoch.
    """

    def __init__(self, n_partitions: int, halo: int):
        if not 0 < n_partitions <= native.MAX_PARTITIONS:
            msg = f"{n_partitions} partitions; the halo kernel takes 1 to {native.MAX_PARTITIONS}"
            raise ValueError(msg)
        self.n_partitions = n_partitions
        self.halo = halo
        self.epoch = 0
        self._on = {}

    def buffers(self, device):
        """``(recv, flags, recv_table, flag_table)`` on ``device``, made at first use."""
        device = torch.device(device)
        if device not in self._on:
            recv = [torch.full((2, 2, self.halo), math.nan, device=device)
                    for _ in range(self.n_partitions)]
            flags = [torch.zeros(2, dtype=torch.int32, device=device)
                     for _ in range(self.n_partitions)]
            tables = [torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64, device=device)
                      for ts in (recv, flags)]
            self._on[device] = (recv, flags, *tables)
        return self._on[device]

    def next_epoch(self) -> int:
        self.epoch = (self.epoch + 1) % 2**32
        return self.epoch


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_ring(offsets, n: int, exchange: HaloExchange) -> int:
    """``local_n``; raises on what K11 does not take."""
    if not offsets:
        raise ValueError("a DIA operator needs at least one diagonal")
    if n % exchange.n_partitions != 0:
        msg = f"n={n} must divide evenly over {exchange.n_partitions} partitions"
        raise ValueError(msg)
    local_n, halo = n // exchange.n_partitions, halo_width(offsets)
    if halo != exchange.halo:
        msg = f"halo {halo} of the offsets, {exchange.halo} of the exchange"
        raise ValueError(msg)
    if halo > local_n:
        msg = f"halo {halo} exceeds local rows {local_n}"
        raise ValueError(msg)
    return local_n


def halo_dia_parts(offsets, v_parts, vals_parts, exchange: HaloExchange):
    """K11 on one tensor per partition: ``v_parts[p] (local_n,)``,
    ``vals_parts[p] (D, local_n)`` (rows contiguous, one row stride for
    all) -> ``out_parts``, a list of ``(local_n,)`` tensors."""
    n_partitions = len(v_parts)
    if len(vals_parts) != n_partitions or n_partitions != exchange.n_partitions:
        msg = f"{len(v_parts)} segments, {len(vals_parts)} value blocks, a ring of {exchange.n_partitions}"
        raise ValueError(msg)
    device = fused_dia.check_operands(*v_parts, *(w[0] for w in vals_parts))
    local_n = v_parts[0].shape[0]
    for v_p, w in zip(v_parts, vals_parts):
        if v_p.shape != (local_n,) or w.shape != (len(offsets), local_n):
            msg = f"shape mismatch: v {tuple(v_p.shape)}, vals {tuple(w.shape)}, {len(offsets)} offsets"
            raise ValueError(msg)
    _check_ring(offsets, local_n * n_partitions, exchange)
    if device.type == "cpu":
        out = halo_dia_plain(offsets, torch.cat(v_parts), torch.cat(vals_parts, dim=1), n_partitions)
        return list(out.reshape(n_partitions, local_n))
    ld = vals_parts[0].stride(0)
    if any(w.stride() != (ld, 1) for w in vals_parts):
        raise ValueError("the value blocks must share one row stride and have contiguous rows")
    out_parts = [torch.empty_like(v_p) for v_p in v_parts]
    _launch(HALO_DIA, offsets, v_parts, vals_parts, out_parts, exchange, local_n, ld, device)
    return out_parts


def _launch(kernel, offsets, v_parts, vals_parts, out_parts, exchange, local_n, ld, device):
    _recv, _flags, recv_table, flag_table = exchange.buffers(device)
    with torch.cuda.device(device):
        kernel.launch(
            _pointers(v_parts), _pointers(vals_parts), _pointers(out_parts),
            recv_table.data_ptr(), flag_table.data_ptr(), exchange.n_partitions, local_n, ld,
            exchange.halo, len(offsets), (ctypes.c_int * len(offsets))(*offsets),
            native.offsets_arg(offsets, None, device).data_ptr(), exchange.next_epoch(),
            native.stream(device),
        )


def halo_dia_rows(offsets, v, vals, exchange: HaloExchange, *, kernel=HALO_DIA):
    """K11 on global tensors: ``v (n,)``, ``vals (D, n)`` -> ``(n,)``.

    Partition p's segment, value columns and output are views of rows
    ``[p local_n, (p + 1) local_n)``; the output is one tensor.
    """
    device = fused_dia.check_operands(v, vals)
    n, n_partitions = v.shape[0], exchange.n_partitions
    if v.ndim != 1 or vals.shape != (len(offsets), n):
        msg = f"shape mismatch: v {tuple(v.shape)}, vals {tuple(vals.shape)}, {len(offsets)} offsets"
        raise ValueError(msg)
    local_n = _check_ring(offsets, n, exchange)
    if device.type == "cpu":
        return halo_dia_plain(offsets, v, vals, n_partitions)
    out = torch.empty_like(v)
    cut = [slice(p * local_n, (p + 1) * local_n) for p in range(n_partitions)]
    _launch(kernel, offsets, [v[s] for s in cut], [vals[:, s] for s in cut],
            [out[s] for s in cut], exchange, local_n, n, device)
    return out


# ---------------------------------------------------------------------------
# The differentiable operator
# ---------------------------------------------------------------------------


class _HaloDiaMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, offsets, exchange, symmetric, v, vals):
        ctx.offsets, ctx.exchange, ctx.symmetric = offsets, exchange, symmetric
        ctx.save_for_backward(v, vals)
        return halo_dia_rows(offsets, v.contiguous(), vals.contiguous(), exchange)

    @staticmethod
    def backward(ctx, u):
        v, vals = ctx.saved_tensors
        offsets, exchange = ctx.offsets, ctx.exchange
        u = u.contiguous()
        dv = dvals = None
        if ctx.needs_input_grad[3]:
            if ctx.symmetric:
                dv = halo_dia_rows(offsets, u, vals.contiguous(), exchange)
            else:
                neg_offsets, vals_t = fused_dia.transposed(offsets, vals)
                dv = halo_dia_rows(neg_offsets, u, vals_t, exchange, kernel=HALO_DIA_T)
        if ctx.needs_input_grad[4]:
            dvals = halo_dvals_plain(offsets, v, u, exchange.n_partitions)
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
    exchange = HaloExchange(n_partitions, halo_width(offsets))
    _check_ring(offsets, n, exchange)

    def matvec(v, vals):
        return _HaloDiaMatvec.apply(offsets, exchange, symmetric, v, vals)

    return matvec
