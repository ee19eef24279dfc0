"""Sparse operators: CSR assembly on the host, DIA, BSR, ELL and HYB on the device.

Counterpart of ``lanczos_adjoints_tpu/ops/sparse.py``. CSR is the
host-side assembly format (numpy); the device layouts are

- DIA (diagonal storage), for banded matrices. Its matvec is circular,
  ``out[i] = sum_k vals[k, i] * v[(i + d_k) mod n]``: packed value slots
  outside the matrix are zero, so the wrapped terms vanish;
- BSR, block-ELL rows of ``(8, 128)`` tiles, for clustered (FEM-type)
  matrices, optionally after reverse Cuthill-McKee reordering;
- ELL (padded rows) and HYB (ELL for the light rows, a dense block for
  the few heavy ones) for scattered patterns.

``matvec(v, *values)`` takes the packed value tensors as its
differentiable parameters, with the pattern closed over, as in the JAX
package; for every layout but HYB that is one tensor, HYB's is the pair
``(ell_values, heavy_dense)``, passed as two. For tensors on the card
``sparse_operator`` builds the kernel matvec of DIA (``ops.fused_dia``,
CUDA kernels K4 and K5) and BSR (``ops.fused_bsr``, K10); off the card,
their plain PyTorch forms. ELL and HYB have no TPU kernel in the JAX
package and run PyTorch ops everywhere.
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


def reverse_cuthill_mckee(mat: CSRMatrix) -> np.ndarray:
    """RCM permutation (numpy BFS) to cluster a matrix towards a band.

    The JAX package's code line for line: ``np.argsort`` on the degrees
    is not stable, so only the same calls give the same permutation.
    """
    n = mat.shape[0]
    degrees = np.diff(mat.indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for start_candidate in np.argsort(degrees):
        if visited[start_candidate]:
            continue
        queue = [int(start_candidate)]
        visited[start_candidate] = True
        while queue:
            node = queue.pop(0)
            order[pos] = node
            pos += 1
            lo, hi = mat.indptr[node], mat.indptr[node + 1]
            nbrs = mat.indices[lo:hi]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = np.unique(nbrs)
            nbrs = nbrs[np.argsort(degrees[nbrs])]
            visited[nbrs] = True
            queue.extend(int(x) for x in nbrs)
    return order[::-1].copy()


def permute_symmetric(mat: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Apply P A P^T for a permutation vector (new[i] = old[perm[i]])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return csr_from_coo(inv[mat.rows], inv[mat.indices], mat.data, shape=mat.shape)


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
    diag_of_entry = np.searchsorted(offsets, entry_offsets)  # each entry's index in the sorted offsets
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
# BSR layout ((8, 128) tiles, block-ELL padded)
# ---------------------------------------------------------------------------

BSR_TILE = 128  # column tile length
BSR_TILE_ROWS = 8  # row tile length


class BSRData(NamedTuple):
    """Block-ELL storage of ``(tile_rows, 128)`` tiles.

    The JAX package's layout (the TPU's register tile), kept so that
    packed values carry across unchanged; a tile row is 512 contiguous
    bytes, a coalesced warp load on the card.
    """

    block_cols: torch.Tensor  # (num_row_blocks, width) int32, on the device
    scatter_idx: np.ndarray  # CSR entry -> flat index into tile storage
    width: int
    shape: tuple  # original (possibly unpadded) shape
    padded_n: int  # padded row count
    padded_cols: int  # padded column count
    nnz: int
    tile_rows: int

    @property
    def num_slots(self) -> int:
        return int(self.block_cols.shape[0]) * self.width * self.tile_rows * BSR_TILE


def bsr_pack(mat: CSRMatrix, *, tile_rows: int = BSR_TILE_ROWS, device="cuda") -> BSRData:
    n_r, n_c = mat.shape
    padded_n = -(-n_r // tile_rows) * tile_rows
    padded_cols = -(-n_c // BSR_TILE) * BSR_TILE
    nbr = padded_n // tile_rows
    ncb = padded_cols // BSR_TILE

    rows, cols = mat.rows, mat.indices
    brow, bcol = rows // tile_rows, cols // BSR_TILE

    # Unique (brow, bcol) tiles, block-ELL padded to uniform width.
    keys = brow * ncb + bcol
    uniq, entry_tile = np.unique(keys, return_inverse=True)
    tile_brow, tile_bcol = uniq // ncb, uniq % ncb
    counts = np.bincount(tile_brow, minlength=nbr)
    width = max(1, int(counts.max()))

    # slot of each unique tile within its row block
    tile_slot = np.zeros(len(uniq), dtype=np.int64)
    seen = np.zeros(nbr, dtype=np.int64)
    order = np.argsort(tile_brow, kind="stable")
    for t in order:
        tile_slot[t] = seen[tile_brow[t]]
        seen[tile_brow[t]] += 1

    block_cols = np.zeros((nbr, width), dtype=np.int32)
    block_cols[tile_brow, tile_slot] = tile_bcol

    flat_tile = tile_brow * width + tile_slot  # flat tile id per unique tile
    r_in, c_in = rows % tile_rows, cols % BSR_TILE
    scatter_idx = flat_tile[entry_tile] * tile_rows * BSR_TILE + r_in * BSR_TILE + c_in
    return BSRData(
        block_cols=torch.tensor(block_cols, device=device),
        scatter_idx=scatter_idx,
        width=width,
        shape=mat.shape,
        padded_n=padded_n,
        padded_cols=padded_cols,
        nnz=mat.nnz,
        tile_rows=tile_rows,
    )


def bsr_values(bsr: BSRData, csr_data, *, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """CSR-ordered values as the ``(num_row_blocks, width, tile_rows, 128)`` tiles."""
    data = np.asarray(csr_data)
    nbr = bsr.padded_n // bsr.tile_rows
    flat = np.zeros(nbr * bsr.width * bsr.tile_rows * BSR_TILE, data.dtype)
    flat[bsr.scatter_idx] = data
    return torch.tensor(
        flat.reshape(nbr, bsr.width, bsr.tile_rows, BSR_TILE), dtype=dtype, device=device
    )


def bsr_gather_vblocks(bsr: BSRData, v):
    """(num_row_blocks, width, 128) source blocks of ``v`` for each tile."""
    n_c = bsr.shape[1]
    vpad = torch.nn.functional.pad(v, (0, bsr.padded_cols - n_c)) if bsr.padded_cols != n_c else v
    gathered = vpad.reshape(-1, BSR_TILE).index_select(0, bsr.block_cols.reshape(-1))
    return gathered.reshape(*bsr.block_cols.shape, BSR_TILE)


def bsr_matvec_fn(bsr: BSRData):
    """Gather-and-contract matvec ``matvec(v, tiles)``, the plain form."""
    n = bsr.shape[0]

    def matvec(v, tiles):
        gathered = bsr_gather_vblocks(bsr, v)
        out = torch.einsum("nwrc,nwc->nr", tiles, gathered)
        return out.reshape(-1)[:n]

    return matvec


def bsr_from_jax(bsr, tiles, *, device="cuda"):
    """The port's ``(BSRData, tiles)`` from the JAX package's pair.

    ``bsr`` is the JAX package's ``BSRData`` (read field by field, its
    ``block_cols`` as numpy) and ``tiles`` its packed values as numpy.
    """
    port = BSRData(
        block_cols=torch.tensor(np.asarray(bsr.block_cols, dtype=np.int32), device=device),
        scatter_idx=np.asarray(bsr.scatter_idx),
        width=int(bsr.width),
        shape=tuple(int(s) for s in bsr.shape),
        padded_n=int(bsr.padded_n),
        padded_cols=int(bsr.padded_cols),
        nnz=int(bsr.nnz),
        tile_rows=int(bsr.tile_rows),
    )
    return port, torch.tensor(np.asarray(tiles), device=device)


# ---------------------------------------------------------------------------
# ELL and HYB layouts
# ---------------------------------------------------------------------------


class ELLData(NamedTuple):
    cols: torch.Tensor  # (n_rows, width) int64, on the device
    perm: np.ndarray  # CSR entry -> flat ELL slot
    width: int
    shape: tuple
    nnz: int

    @property
    def num_slots(self) -> int:
        return int(self.cols.shape[0]) * self.width


def ell_pack(mat: CSRMatrix, *, width_multiple: int = 8, device="cuda") -> ELLData:
    n_rows, _ = mat.shape
    counts = np.diff(mat.indptr)
    width = int(max(1, counts.max()))
    width = -(-width // width_multiple) * width_multiple

    cols = np.zeros((n_rows, width), dtype=np.int64)
    row_of = np.repeat(np.arange(n_rows), counts)
    pos_in_row = np.arange(mat.nnz) - np.repeat(mat.indptr[:-1], counts)
    cols[row_of, pos_in_row] = mat.indices
    perm = row_of * width + pos_in_row
    return ELLData(
        cols=torch.tensor(cols, device=device), perm=perm, width=width, shape=mat.shape,
        nnz=mat.nnz,
    )


def ell_values(ell: ELLData, csr_data, *, dtype=torch.float32, device="cuda") -> torch.Tensor:
    data = np.asarray(csr_data)
    flat = np.zeros(ell.shape[0] * ell.width, dtype=data.dtype)
    flat[ell.perm] = data
    return torch.tensor(flat.reshape(ell.shape[0], ell.width), dtype=dtype, device=device)


def ell_matvec_fn(ell: ELLData):
    """ELL matvec by an index gather: ``out[i] = sum_w vals[i, w] * v[cols[i, w]]``.

    The JAX package's 128-lane window gather with a one-hot lane select
    works around the TPU's slow element gathers; it computes this same
    function, and the card gathers elements directly.
    """
    cols = ell.cols

    def matvec(v, vals):
        return torch.sum(vals * v[cols], dim=1)

    return matvec


# The JAX package keeps its element-gather matvec beside the window one
# for benchmarks; here the two are the same.
ell_matvec_fn_gather = ell_matvec_fn


class HYBData(NamedTuple):
    """Hybrid ELL: light rows in ELL, heavy rows as a dense ``(k, n_cols)`` block.

    Rows longer than ``heavy_factor * max(8, median)`` are peeled off, so
    that a few (near-)dense rows do not pad every ELL row to their length.
    """

    ell: ELLData
    heavy_rows: torch.Tensor  # (k,) int64 row indices (possibly k = 0), on the device
    heavy_scatter: np.ndarray  # heavy CSR entry -> flat (k, n_cols) slot
    light_mask: np.ndarray  # bool per CSR entry: in the light part
    shape: tuple
    nnz: int

    @property
    def num_slots(self) -> int:
        return self.ell.num_slots + int(self.heavy_rows.shape[0]) * self.shape[1]


def hyb_pack(mat: CSRMatrix, *, heavy_factor: int = 4, device="cuda") -> HYBData:
    # The light_mask <-> ELL slot correspondence below assumes CSR
    # entries are (row, col)-sorted (csr_from_coo guarantees it).
    if np.any(np.diff(mat.indices) <= 0):
        starts = mat.indptr[:-1]
        boundary = np.zeros(mat.nnz, dtype=bool)
        boundary[starts[starts < mat.nnz]] = True
        unsorted_inside_row = (np.diff(mat.indices) <= 0) & ~boundary[1:]
        if np.any(unsorted_inside_row):
            msg = (
                "hyb_pack requires column indices sorted within each row "
                "(duplicates included); build the matrix via csr_from_coo"
            )
            raise ValueError(msg)
    counts = np.diff(mat.indptr)
    threshold = heavy_factor * max(8, int(np.median(counts)))
    heavy = np.flatnonzero(counts > threshold)
    is_heavy_entry = np.isin(mat.rows, heavy)

    light_mask = ~is_heavy_entry
    light = csr_from_coo(
        mat.rows[light_mask], mat.indices[light_mask], mat.data[light_mask], shape=mat.shape
    )
    heavy_pos = np.searchsorted(heavy, mat.rows[is_heavy_entry])
    heavy_scatter = heavy_pos * mat.shape[1] + mat.indices[is_heavy_entry]
    return HYBData(
        ell=ell_pack(light, device=device),
        heavy_rows=torch.tensor(heavy, dtype=torch.long, device=device),
        heavy_scatter=heavy_scatter,
        light_mask=light_mask,
        shape=mat.shape,
        nnz=mat.nnz,
    )


def hyb_values(hyb: HYBData, csr_data, *, dtype=torch.float32, device="cuda"):
    """``(ell_values, heavy_dense)``: the two differentiable parameters."""
    data = np.asarray(csr_data)
    ell_vals = ell_values(hyb.ell, data[hyb.light_mask], dtype=dtype, device=device)
    k = int(hyb.heavy_rows.shape[0])
    dense = np.zeros(k * hyb.shape[1], dtype=data.dtype)
    dense[hyb.heavy_scatter] = data[~hyb.light_mask]
    return ell_vals, torch.tensor(dense.reshape(k, hyb.shape[1]), dtype=dtype, device=device)


def hyb_matvec_fn(hyb: HYBData):
    """``matvec(v, ell_values, heavy_dense)``: the two parameters travel apart,
    so that an autograd Function over ``(v, *params)`` sees both."""
    light_matvec = ell_matvec_fn(hyb.ell)
    heavy_rows = hyb.heavy_rows
    k = int(heavy_rows.shape[0])

    def matvec(v, ell_vals, dense):
        out = light_matvec(v, ell_vals)
        if k == 0:
            return out
        return out.index_copy(0, heavy_rows, dense @ v)

    return matvec


def ell_from_jax(ell, values, *, device="cuda"):
    """The port's ``(ELLData, values)`` from the JAX package's pair (numpy fields)."""
    port = ELLData(
        cols=torch.tensor(np.asarray(ell.cols, dtype=np.int64), device=device),
        perm=np.asarray(ell.perm), width=int(ell.width),
        shape=tuple(int(s) for s in ell.shape), nnz=int(ell.nnz),
    )
    return port, torch.tensor(np.asarray(values), device=device)


def hyb_from_jax(hyb, values, *, device="cuda"):
    """The port's ``(HYBData, (ell_values, heavy_dense))`` from the JAX package's pair."""
    ell, ell_vals = ell_from_jax(hyb.ell, values[0], device=device)
    port = HYBData(
        ell=ell,
        heavy_rows=torch.tensor(np.asarray(hyb.heavy_rows, dtype=np.int64), device=device),
        heavy_scatter=np.asarray(hyb.heavy_scatter),
        light_mask=np.asarray(hyb.light_mask),
        shape=tuple(int(s) for s in hyb.shape), nnz=int(hyb.nnz),
    )
    return port, (ell_vals, torch.tensor(np.asarray(values[1]), device=device))


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
    bsr_min_fill: float = 0.02,
    with_info: bool = False,
    device="cuda",
):
    """Build ``(matvec, values)`` (+ ``OperatorInfo``) for a CSR matrix.

    ``matvec(v, values)`` computes ``A(values) @ v`` with the sparsity
    pattern closed over; ``values`` is the differentiable parameter in
    the chosen layout, on ``device`` (for ``"hyb"`` the pair
    ``(ell_values, heavy_dense)``, and ``matvec(v, ell_values,
    heavy_dense)``). ``format="auto"`` picks as the JAX package does: DIA
    for a square matrix with at most ``dia_max_diags`` diagonals, else BSR
    if its fill reaches ``bsr_min_fill``, else HYB.

    On the card DIA and BSR run their kernels (``ops.fused_dia``,
    ``ops.fused_bsr``), which take float32 only; their plain forms never
    run there. The JAX package leaves its Pallas BSR kernel to
    benchmarks; the port dispatches it, as it does the DIA kernels.
    """
    fmt = format
    bsr = None
    if fmt == "auto":
        if len(dia_analyze(mat)) <= dia_max_diags and mat.shape[0] == mat.shape[1]:
            fmt = "dia"
        else:
            bsr = bsr_pack(mat, device=device)
            fmt = "bsr" if mat.nnz / bsr.num_slots >= bsr_min_fill else "hyb"
    if fmt not in ("dia", "bsr", "ell", "hyb"):
        msg = f"format={format!r} not in ('auto', 'dia', 'bsr', 'ell', 'hyb')"
        raise ValueError(msg)
    on_card = native.on_card(device)
    if on_card and fmt in ("dia", "bsr") and dtype != torch.float32:
        msg = f"on the card the {fmt.upper()} operator runs the float32 kernels; got dtype {dtype}"
        raise TypeError(msg)

    if fmt == "dia":
        dia = dia_pack(mat)
        if on_card:
            # K4 and K5 take any n and any number of diagonals, so the JAX
            # package's TPU limits for its Pallas matvec (n % 1024, a VMEM
            # budget) do not apply.
            from lanczos_adjoints_tpu_torch.ops import fused_dia

            matvec = fused_dia.dia_matvec_fused(dia, check_tiling=False)
        else:
            matvec = dia_matvec_fn(dia)
        values = dia_values(dia, mat.data, dtype=dtype, device=device)
        slots = dia.num_slots
    elif fmt == "bsr":
        bsr = bsr or bsr_pack(mat, device=device)
        if on_card:
            from lanczos_adjoints_tpu_torch.ops import fused_bsr

            matvec = fused_bsr.bsr_matvec_fused(bsr, symmetric=mat.is_symmetric())
        else:
            matvec = bsr_matvec_fn(bsr)
        values = bsr_values(bsr, mat.data, dtype=dtype, device=device)
        slots = bsr.num_slots
    elif fmt == "ell":
        ell = ell_pack(mat, device=device)
        matvec = ell_matvec_fn(ell)
        values = ell_values(ell, mat.data, dtype=dtype, device=device)
        slots = ell.num_slots
    else:
        hyb = hyb_pack(mat, device=device)
        matvec = hyb_matvec_fn(hyb)
        values = hyb_values(hyb, mat.data, dtype=dtype, device=device)
        slots = hyb.num_slots

    if with_info:
        itemsize = torch.finfo(dtype).bits // 8
        info = OperatorInfo(
            format=fmt,
            stored_slots=slots,
            nnz=mat.nnz,
            bytes_per_matvec=slots * itemsize + 2 * mat.shape[0] * itemsize,
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
