"""Row-partitioned operators over a mesh of partitions.

Counterpart of ``lanczos_adjoints_tpu/parallel/sharded.py``. The JAX
package runs its mesh as one program over devices (``jax.shard_map``);
the port's mesh is a single controller over P partitions that all lie on
one card, each with its own row block: ``Mesh`` names the axes, their
sizes and that card. Placing partitions on distinct cards waits for a
machine with several (ROADMAP.md A13), and ``device_mesh`` refuses it.

A sharded tensor is the global tensor on the mesh's card
(``shard_rows``, ``replicate``); partition p's block is the p-th of
``P`` equal contiguous row blocks. Each factory returns a matvec with
the JAX package's calling convention: the dense and Gram operators
compute each row block and concatenate the blocks in partition order
(the closing all-gather of ``shard_map``), and the DIA operator
exchanges halos between ring neighbours (``parallel.fused_halo``, K11 on
the card).
"""

import math
from dataclasses import dataclass
from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.ops import gram, native
from lanczos_adjoints_tpu_torch.parallel import fused_halo


@dataclass(frozen=True)
class Mesh:
    """Named axes of partitions, all on ``device``; ``shape`` as in JAX."""

    axis_names: tuple
    axis_sizes: tuple
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclass(frozen=True)
class NamedSharding:
    """The leading axis of an array split over one mesh axis (JAX's
    ``NamedSharding(mesh, PartitionSpec(axis))``), for probe sharding."""

    mesh: Mesh
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]


def _one_card(device):
    """The single card of ``device`` (a device, or one per partition)."""
    if isinstance(device, (str, torch.device)):
        return torch.device(device)
    cards = {torch.device(d) for d in device}
    if len(cards) > 1:
        msg = (
            f"partitions on distinct cards {sorted(map(str, cards))} are not supported yet "
            "(ROADMAP.md A13: peer pointers in K11's tables, one launch per card)"
        )
        raise NotImplementedError(msg)
    return cards.pop()


def make_mesh(axis_sizes: dict, *, device="cuda") -> Mesh:
    """A mesh of ``prod(axis_sizes)`` partitions, axes in the dict's order."""
    if any(int(s) < 1 for s in axis_sizes.values()):
        msg = f"mesh axes must be positive, got {axis_sizes}"
        raise ValueError(msg)
    return Mesh(tuple(axis_sizes), tuple(int(s) for s in axis_sizes.values()), _one_card(device))


def device_mesh(n_partitions: int, *, axis: str = "rows", device="cuda") -> Mesh:
    """A 1-D mesh of ``n_partitions`` partitions on ``device``.

    ``device`` may also list one device per partition; more than one
    distinct card raises ``NotImplementedError``.
    """
    return make_mesh({axis: n_partitions}, device=device)


def _blocks(size: int, mesh: Mesh, axis: str, what: str) -> int:
    parts = mesh.shape[axis]
    if size % parts != 0:
        msg = f"{what} of size {size} must divide evenly over the {parts} partitions of {axis!r}"
        raise ValueError(msg)
    return parts


def shard_rows(array, mesh: Mesh, *, axis: str = "rows", dim: int = 0):
    """``array`` on the mesh's card, its ``dim`` axis split over ``axis``."""
    _blocks(array.shape[dim], mesh, axis, f"dimension {dim}")
    return array.to(mesh.device).contiguous()


def replicate(array, mesh: Mesh):
    """``array`` on the mesh's card, whole in every partition."""
    return array.to(mesh.device).contiguous()


def sharded_dense_operator(mesh: Mesh, *, axis: str = "rows") -> Callable:
    """Row-partitioned dense matvec ``matvec(v, matrix)``: each partition
    multiplies its row block by the replicated ``v``."""

    def matvec(v, matrix):
        parts = _blocks(matrix.shape[0], mesh, axis, "the matrix's rows")
        return torch.cat([block @ v for block in matrix.chunk(parts)])

    return matvec


def sharded_dia_operator(dia, mesh: Mesh, *, axis: str = "rows") -> Callable:
    """Row-partitioned DIA matvec ``matvec(v, vals)`` with a ring halo exchange.

    ``v (n,)`` and ``vals (D, n)`` are sharded along positions; each
    partition takes ``halo = max(1, max |d_k|)`` entries from each ring
    neighbour, so the product is K4's circular one. On the card the
    matvec is K11 (``fused_halo.sharded_dia_operator_fused`` with
    ``check_tiling=False``), whose backward runs K11 on the transposed
    operator for ``dv``, the true transpose as the JAX operator's
    autodiff gives it. Off the card it is the plain halo body,
    differentiated by autograd. The closure carries no ``.dia_data``.
    """
    offsets = tuple(int(d) for d in dia.offsets)
    halo = fused_halo.halo_width(offsets)
    n = dia.shape[0]
    parts = mesh.shape[axis]
    if n % parts != 0:
        msg = f"n={n} must divide evenly over {parts} devices"
        raise ValueError(msg)
    local_n = n // parts
    if halo > local_n:
        msg = f"halo {halo} exceeds local rows {local_n}; use fewer devices"
        raise ValueError(msg)
    if native.on_card(mesh.device):
        return fused_halo.sharded_dia_operator_fused(
            dia, mesh, axis=axis, check_tiling=False, symmetric=False
        )

    def matvec(v, vals):
        return fused_halo.halo_dia_plain(offsets, v, vals, parts)

    return matvec


def sharded_gram_policy(base_policy: Callable, mesh: Mesh, *, axis: str = "rows") -> Callable:
    """Lift a Gram-matvec policy onto the mesh's row partitions.

    ``policy(fun)(i, j, v, *params)``: each partition runs the base
    policy (the fused kernels K1/K2, say) on its block of the row data
    ``i`` against the replicated ``j`` and ``v``, which may be ``(n,)``
    or ``(n, m)``; the row blocks concatenate in partition order. Row
    counts that do not divide by the axis run the base policy unsharded,
    the JAX package's static shape rule.
    """
    parts = mesh.shape[axis]

    def policy(fun: Callable) -> Callable:
        apply_inner = base_policy(fun)

        def matvec_y(i, j, v, *params):
            if i.shape[0] % parts != 0:
                return apply_inner(i, j, v, *params)
            return torch.cat([apply_inner(block, j, v, *params) for block in i.chunk(parts)])

        return matvec_y

    return policy


def sharded_gram_matvec(kernel_fun: Callable, mesh: Mesh, *, axis: str = "rows"):
    """Row-partitioned kernel-Gram matvec ``matvec(x_rows, y, v, *params)``
    through the dense policy, one row block per partition."""
    dense = gram.gram_matvec()(kernel_fun)

    def matvec(x_rows, y, v, *params):
        parts = _blocks(x_rows.shape[0], mesh, axis, "the row data")
        return torch.cat([dense(block, y, v, *params) for block in x_rows.chunk(parts)])

    return matvec
