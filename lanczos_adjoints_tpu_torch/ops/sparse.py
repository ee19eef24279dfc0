"""Sparse operators: CSR assembly on the host, the DIA layout on the device.

Counterpart of the CSR and DIA half of ``lanczos_adjoints_tpu/ops/sparse.py``.
CSR is the host-side assembly format (numpy); the device layout is DIA
(diagonal storage), the one the sparse Lanczos path runs on. Its matvec
is circular, ``out[i] = sum_k vals[k, i] * v[(i + d_k) mod n]``: packed
value slots outside the matrix are zero, so the wrapped terms vanish.

``matvec(v, values)`` takes the packed ``(num_diags, n)`` value tensor as
its differentiable parameter, with the pattern closed over, as in the
JAX package. For tensors on the card ``sparse_operator`` always builds
the DIA kernel matvec (``ops.fused_dia``, CUDA kernels K4 and K5); off
the card, the ``torch.roll`` form. The
BSR, ELL and HYB layouts and RCM reordering are not ported yet
(``ROADMAP.md`` A9).
"""

from typing import NamedTuple

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import native


class CSRMatrix(NamedTuple):
    """Host-side CSR container (numpy); build device operators from it."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(out, (self.rows, self.indices), self.data)
        return out

    def is_symmetric(self) -> bool:
        if self.shape[0] != self.shape[1]:
            return False
        a = np.lexsort((self.indices, self.rows))
        b = np.lexsort((self.rows, self.indices))
        return (
            np.array_equal(self.rows[a], self.indices[b])
            and np.array_equal(self.indices[a], self.rows[b])
            and np.allclose(self.data[a], self.data[b])
        )


def csr_from_coo(rows, cols, vals, *, shape) -> CSRMatrix:
    """Assemble CSR from COO triplets (duplicates are summed).

    With scipy, through ``coo_matrix.tocsr``; without it, a single-key
    argsort, ``np.add.reduceat`` and ``np.bincount``. Both give the JAX
    package's arrays bit for bit.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)

    try:
        from scipy.sparse import coo_matrix
    except ImportError:
        pass
    else:
        csr = coo_matrix((vals, (rows, cols)), shape=tuple(shape)).tocsr()
        csr.sort_indices()
        return CSRMatrix(
            indptr=csr.indptr.astype(np.int64),
            indices=csr.indices.astype(np.int64),
            data=csr.data,
            shape=tuple(shape),
        )

    keys = rows * shape[1] + cols
    order = np.argsort(keys, kind="stable")
    keys, rows, cols, vals = keys[order], rows[order], cols[order], vals[order]

    if len(rows) > 1:
        uniq_mask = np.concatenate([[True], keys[1:] != keys[:-1]])
        starts = np.flatnonzero(uniq_mask)
        vals = np.add.reduceat(vals, starts)
        rows, cols = rows[uniq_mask], cols[uniq_mask]

    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=shape[0]))
    return CSRMatrix(indptr=indptr, indices=cols, data=vals, shape=tuple(shape))


def csr_from_dense(matrix) -> CSRMatrix:
    matrix = np.asarray(matrix)
    rows, cols = np.nonzero(matrix)
    return csr_from_coo(rows, cols, matrix[rows, cols], shape=matrix.shape)


# ---------------------------------------------------------------------------
# DIA layout
# ---------------------------------------------------------------------------


class DIAData(NamedTuple):
    offsets: tuple  # python ints, sorted
    shape: tuple
    nnz: int
    # maps CSR entry -> (diag_index, position) for value packing
    diag_of_entry: np.ndarray
    pos_of_entry: np.ndarray

    @property
    def num_slots(self) -> int:
        return len(self.offsets) * self.shape[0]


def dia_analyze(mat: CSRMatrix):
    """Distinct diagonal offsets of the pattern."""
    return np.unique(mat.indices - mat.rows)


def dia_pack(mat: CSRMatrix) -> DIAData:
    rows = mat.rows
    entry_offsets = mat.indices - rows
    offsets = np.unique(entry_offsets)
    lookup = {int(d): i for i, d in enumerate(offsets)}
    diag_of_entry = np.asarray([lookup[int(d)] for d in entry_offsets])
    return DIAData(
        offsets=tuple(int(d) for d in offsets),
        shape=mat.shape,
        nnz=mat.nnz,
        diag_of_entry=diag_of_entry,
        pos_of_entry=rows,
    )


def dia_values(dia: DIAData, csr_data, *, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Pack CSR-ordered values into the (num_diags, n) DIA layout.

    Diagonal d stored row-aligned: slot [k, i] is entry A[i, i + offsets[k]].
    """
    data = np.asarray(csr_data)
    vals = np.zeros((len(dia.offsets), dia.shape[0]), dtype=data.dtype)
    vals[dia.diag_of_entry, dia.pos_of_entry] = data
    return torch.tensor(vals, dtype=dtype, device=device)


def dia_from_jax(dia, values, *, device="cuda"):
    """The port's ``(DIAData, values)`` from the JAX package's pair.

    ``dia`` is the JAX package's ``DIAData`` (read field by field: its
    tuples and numpy arrays, no JAX needed) and ``values`` its packed
    value array as numpy. The values keep their dtype.
    """
    port = DIAData(
        offsets=tuple(int(d) for d in dia.offsets),
        shape=tuple(int(s) for s in dia.shape),
        nnz=int(dia.nnz),
        diag_of_entry=np.asarray(dia.diag_of_entry),
        pos_of_entry=np.asarray(dia.pos_of_entry),
    )
    return port, torch.tensor(np.asarray(values), device=device)


def dia_matvec_fn(dia: DIAData):
    """Roll-and-FMA matvec ``matvec(v, vals)``, the plain form.

    ``out[i] = sum_k vals[k, i] * v[(i + d_k) mod n]`` by one
    ``torch.roll`` per diagonal; autograd's transpose is again rolls.
    The closure carries ``.dia_data`` so that ``krylov.lanczos.tridiag``
    can recognise the operator and dispatch to the fused Lanczos kernels.
    """
    offsets = dia.offsets

    def matvec(v, vals):
        out = torch.zeros_like(v)
        for k, d in enumerate(offsets):
            out = out + vals[k] * torch.roll(v, -d)
        return out

    matvec.dia_data = dia
    return matvec


# ---------------------------------------------------------------------------
# Format selection
# ---------------------------------------------------------------------------


class OperatorInfo(NamedTuple):
    format: str
    stored_slots: int
    nnz: int
    bytes_per_matvec: int

    @property
    def fill_efficiency(self) -> float:
        return self.nnz / max(1, self.stored_slots)


def sparse_operator(
    mat: CSRMatrix,
    *,
    dtype=torch.float32,
    format: str = "auto",
    dia_max_diags: int = 64,
    with_info: bool = False,
    device="cuda",
):
    """Build ``(matvec, values)`` (+ ``OperatorInfo``) for a CSR matrix.

    ``matvec(v, values)`` computes ``A(values) @ v`` with the sparsity
    pattern closed over; ``values`` is the differentiable parameter in
    the DIA layout, on ``device``. On the card the matvec is the kernel
    one (``ops.fused_dia``), which takes float32 only; on the CPU it is
    the roll form, any dtype. ``format="auto"`` takes DIA for a
    square matrix with at most ``dia_max_diags`` diagonals, as the JAX
    package does; its other layouts are not ported yet and raise
    ``NotImplementedError``.
    """
    if format == "auto":
        if len(dia_analyze(mat)) > dia_max_diags or mat.shape[0] != mat.shape[1]:
            msg = (
                "this matrix needs the BSR or HYB layout, which is not ported "
                "yet (ROADMAP.md A9); only 'dia' is"
            )
            raise NotImplementedError(msg)
    elif format in ("bsr", "ell", "hyb"):
        msg = f"format {format!r} is not ported yet (ROADMAP.md A9); only 'dia' is"
        raise NotImplementedError(msg)
    elif format != "dia":
        msg = f"format={format!r} not in ('auto', 'dia', 'bsr', 'ell', 'hyb')"
        raise ValueError(msg)

    dia = dia_pack(mat)
    n = mat.shape[0]
    if native.on_card(device):
        # On the card the matvec is always the kernel one (K4, K5): they
        # take any n and up to 64 diagonals, so the JAX package's TPU
        # limits for its Pallas matvec (n % 1024, a VMEM budget) do not
        # apply. What the kernels cannot take raises; the roll form never
        # runs on the card.
        if dtype != torch.float32:
            msg = f"on the card the DIA operator runs the float32 kernels; got dtype {dtype}"
            raise TypeError(msg)
        from lanczos_adjoints_tpu_torch.ops import fused_dia

        matvec = fused_dia.dia_matvec_fused(dia, check_tiling=False)
    else:
        matvec = dia_matvec_fn(dia)
    values = dia_values(dia, mat.data, dtype=dtype, device=device)

    if with_info:
        itemsize = values.element_size()
        info = OperatorInfo(
            format="dia",
            stored_slots=dia.num_slots,
            nnz=mat.nnz,
            bytes_per_matvec=dia.num_slots * itemsize + 2 * n * itemsize,
        )
        return matvec, values, info
    return matvec, values


def coo_matvec_fn(mat: CSRMatrix, *, dtype=torch.float32, device="cuda"):
    """COO matvec by ``index_add_``: the reference-style correctness baseline."""
    row_ids = torch.as_tensor(mat.rows, dtype=torch.long, device=device)
    cols = torch.as_tensor(mat.indices, dtype=torch.long, device=device)
    n_rows = mat.shape[0]

    def matvec(v, vals):
        prods = vals * v[cols]
        out = torch.zeros(n_rows, dtype=prods.dtype, device=prods.device)
        return out.index_add_(0, row_ids, prods)

    return matvec, torch.tensor(mat.data, dtype=dtype, device=device)
