"""BSR sparse matvec: the CUDA kernel K10 over a packed CSR view, and its plain versions.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_bsr.py``. A BSR operator
(``ops.sparse.BSRData``: ``(8, 128)`` tiles, block-ELL padded) keeps its
tiles as the parameter: they are the values that carry across from the
JAX package, and what ``dtiles`` is taken with respect to. Its product is

    out[b * 8 + r] = sum_w sum_c tiles[b, w, r, c] * v[block_cols[b, w] * 128 + c]

(``bsr_spmv_plain``, the JAX semantics). K10 does not stream the padded
tiles (13.7x the nonzeros of the FEM test matrix): ``BsrPacker`` gathers
them once for each distinct values tensor into a CSR view (``PackedCSR``:
values, int32 columns and row pointers) holding exactly their nonzero
pattern, and K10 (``csrc/bsr.cu`` ``lat_bsr_spmv``) is a CSR product over
it. ``bsr_spmv_packed`` launches K10 for CUDA tensors and runs its plain
version (``bsr_spmv_packed_plain``, ``index_add_`` over the row segments)
for CPU tensors; there is no other path. ``PACKS`` counts the packs.

``bsr_matvec_fused(bsr, symmetric=...)`` wraps it in a
``torch.autograd.Function`` that packs through the operator's own
``BsrPacker``: the cotangent matvec is K10 again for a symmetric
operator and the JAX package's block scatter-add transpose (PyTorch ops,
as it is XLA there) otherwise; the value gradient
``dtiles[n, w, r, c] = u[n, r] * v_blocks[n, w, c]`` is a broadcast, as
in the JAX package. Each runs only when its input needs a gradient.
"""

from typing import NamedTuple

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import native, sparse

BSR_SPMV = native.Kernel("bsr_spmv", "bsr", "lat_bsr_spmv", device_symbol="bsr_csr_spmv_kernel")
# Packs made by every BsrPacker: one for each distinct values tensor.
PACKS = 0


class PackedCSR(NamedTuple):
    """The CSR view of a tiles tensor that K10 reads."""

    vals: torch.Tensor  # (nnz,) float32, row by row
    cols: torch.Tensor  # (nnz,) int32
    row_ptr: torch.Tensor  # (n_rows + 1,) int32
    n_cols: int
    structural: bool  # the BSR structure's entries, in its CSR order (else from the values)

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


def _slot_coords(bsr, slots):
    """(row, column) of flat tile slots, as int64 tensors."""
    tile_size = bsr.tile_rows * sparse.BSR_TILE
    tile, within = slots // tile_size, slots % tile_size
    brow, w = tile // bsr.width, tile % bsr.width
    rows = brow * bsr.tile_rows + within // sparse.BSR_TILE
    block_cols = bsr.block_cols.to(slots.device)
    cols = block_cols[brow, w].long() * sparse.BSR_TILE + within % sparse.BSR_TILE
    return rows, cols


def _row_ptr(rows, n_rows):
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)
    return row_ptr.to(torch.int32)


def bsr_structure(bsr, device):
    """``(slots, cols, row_ptr)``: the flat tile slot, column and row pointers
    of every entry of the BSR structure, in its CSR order."""
    slots = torch.as_tensor(np.asarray(bsr.scatter_idx), dtype=torch.int64, device=device)
    rows, cols = _slot_coords(bsr, slots)
    return slots, cols.to(torch.int32), _row_ptr(rows, bsr.shape[0])


@torch.no_grad()
def pack_tiles(bsr, tiles, structure=None) -> PackedCSR:
    """The CSR view of ``tiles``, exact for any tiles tensor of the operator.

    The structural part is one gather. The whole tile stream is read once
    more to count the nonzero entries off the structure (a dense update of
    the tiles puts values there); when there are any, the pattern comes
    from the values instead, exactly-zero entries skipped. Entries past
    the operator's rows and columns, which the tile product drops or
    multiplies by zero padding, are dropped.
    """
    n_rows, n_cols = bsr.shape
    flat = tiles.reshape(-1)
    slots, cols, row_ptr = structure if structure is not None else bsr_structure(bsr, tiles.device)
    vals = flat.index_select(0, slots)
    total, on = torch.stack([torch.count_nonzero(flat), torch.count_nonzero(vals)]).tolist()
    if total == on:
        return PackedCSR(vals, cols, row_ptr, n_cols, True)
    slots = torch.nonzero(flat).squeeze(1)
    rows, cols = _slot_coords(bsr, slots)
    keep = (rows < n_rows) & (cols < n_cols)
    slots, rows, cols = slots[keep], rows[keep], cols[keep]
    order = torch.argsort(rows, stable=True)
    return PackedCSR(flat[slots[order]], cols[order].to(torch.int32),
                     _row_ptr(rows[order], n_rows), n_cols, False)


class BsrPacker:
    """An operator's packed CSR view, cached for the last tiles tensor it saw.

    The key is the tiles' storage pointer, offset, shape, strides and
    version counter: the saved tensor that autograd hands back (another
    Python object over the same storage) finds the entry; an in-place
    update (a new version) or another tensor packs again. The entry keeps
    a reference to the tensor it was made from, so that tensor's memory
    cannot be freed and reused by another under the same key.
    """

    def __init__(self, bsr):
        self.bsr = bsr
        self._structure = None
        self._entry = None  # (key, tiles, pack)

    def __call__(self, tiles) -> PackedCSR:
        global PACKS
        key = (tiles.device, tiles.untyped_storage().data_ptr(), tiles.storage_offset(),
               tuple(tiles.shape), tiles.stride(), tiles._version)
        if self._entry is not None and self._entry[0] == key:
            return self._entry[2]
        if self._structure is None or self._structure[0].device != tiles.device:
            self._structure = bsr_structure(self.bsr, tiles.device)
        pack = pack_tiles(self.bsr, tiles, self._structure)
        self._entry = (key, tiles, pack)
        PACKS += 1
        return pack


def bsr_spmv_plain(bsr, v, tiles):
    """Plain tile product (the JAX semantics): gather the source blocks,
    contract each tile against its block."""
    return sparse.bsr_matvec_fn(bsr)(v, tiles)


def bsr_spmv_packed_plain(pack: PackedCSR, v):
    """Plain K10: ``index_add_`` of the products over the row segments."""
    rows = torch.repeat_interleave(
        torch.arange(pack.n_rows, device=v.device), pack.row_ptr.diff().long())
    out = torch.zeros(pack.n_rows, dtype=v.dtype, device=v.device)
    return out.index_add_(0, rows, pack.vals * v[pack.cols.long()])


def lanes_per_row(nnz: int, n_rows: int) -> int:
    """K10's lanes a row, from the mean row length: a lane takes 8 entries
    a trip (two float4 loads), so 4 lanes for the ~74 entries of an FEM
    row, which measured fastest there (NVIDIA H100, 4 against 8 and 16)."""
    mean = nnz / max(1, n_rows)
    return 4 if mean <= 96 else 8 if mean <= 192 else 16 if mean <= 384 else 32


def bsr_spmv_packed(pack: PackedCSR, v):
    """K10: ``A @ v`` over the packed view, ``v (n_cols,)`` -> ``(n_rows,)``."""
    if v.device != pack.vals.device:
        msg = f"all operands must lie on one device, got {v.device} and {pack.vals.device}"
        raise ValueError(msg)
    if v.dtype != torch.float32 or pack.vals.dtype != torch.float32:
        msg = f"the BSR kernel takes float32, got {v.dtype} and {pack.vals.dtype}"
        raise TypeError(msg)
    if v.shape != (pack.n_cols,):
        msg = f"shape mismatch: v {tuple(v.shape)}, operator with {pack.n_cols} columns"
        raise ValueError(msg)
    device = v.device
    if device.type == "cpu":
        return bsr_spmv_packed_plain(pack, v)
    if device.type != "cuda":
        msg = f"no BSR kernel for device {device}"
        raise ValueError(msg)
    if pack.vals.data_ptr() % 16 or pack.cols.data_ptr() % 16:
        raise ValueError("the BSR kernel takes a 16-byte aligned packed view")
    v = v.contiguous()
    out = torch.empty(pack.n_rows, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        BSR_SPMV.launch(
            pack.vals.data_ptr(), pack.cols.data_ptr(), pack.row_ptr.data_ptr(), v.data_ptr(),
            out.data_ptr(), pack.n_rows, lanes_per_row(pack.nnz, pack.n_rows),
            native.stream(device),
        )
    return out


def bsr_spmv_rows(bsr, v, tiles, packer=None):
    """K10 on the operator's tiles: ``v (n_cols,)``, ``tiles (nbr, width,
    tile_rows, 128)`` -> ``(n_rows,)``, packing through ``packer`` (a new
    one, so a new pack, if None)."""
    device = v.device
    for a in (v, tiles):
        if a.device != device:
            msg = f"all operands must lie on one device, got {a.device} and {device}"
            raise ValueError(msg)
        if a.dtype != torch.float32:
            msg = f"the BSR kernel takes float32, got {a.dtype}"
            raise TypeError(msg)
    nbr = bsr.padded_n // bsr.tile_rows
    want = (nbr, bsr.width, bsr.tile_rows, sparse.BSR_TILE)
    if v.shape != (bsr.shape[1],) or tuple(tiles.shape) != want:
        msg = f"shape mismatch: v {tuple(v.shape)}, tiles {tuple(tiles.shape)}, expected {want}"
        raise ValueError(msg)
    if device.type not in ("cpu", "cuda"):
        msg = f"no BSR kernel for device {device}"
        raise ValueError(msg)
    return bsr_spmv_packed((packer or BsrPacker(bsr))(tiles), v)


def bsr_spmv_fused(bsr):
    """Raw matvec ``(v, tiles) -> A @ v`` through K10 (not differentiable),
    with its own packer as ``.packer``."""
    packer = BsrPacker(bsr)

    def matvec(v, tiles):
        return bsr_spmv_rows(bsr, v, tiles, packer)

    matvec.packer = packer
    return matvec


def _padded_rows(bsr, u):
    """``u (n_rows,)`` as ``(nbr, tile_rows)``, zero-padded."""
    pad = bsr.padded_n - bsr.shape[0]
    upad = torch.nn.functional.pad(u, (0, pad)) if pad else u
    return upad.reshape(-1, bsr.tile_rows)


def bsr_transpose_matvec(bsr, u, tiles):
    """``A^T u`` by per-tile contraction and a block row scatter-add."""
    contrib = torch.einsum("nwrc,nr->nwc", tiles, _padded_rows(bsr, u))
    acc = torch.zeros((bsr.padded_cols // sparse.BSR_TILE, sparse.BSR_TILE),
                      dtype=contrib.dtype, device=contrib.device)
    acc.index_add_(0, bsr.block_cols.reshape(-1), contrib.reshape(-1, sparse.BSR_TILE))
    return acc.reshape(-1)[: bsr.shape[1]]


class _BsrMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bsr, packer, symmetric, v, tiles):
        ctx.bsr = bsr
        ctx.packer = packer
        ctx.symmetric = symmetric
        ctx.save_for_backward(v, tiles)
        return bsr_spmv_rows(bsr, v.contiguous(), tiles, packer)

    @staticmethod
    def backward(ctx, u):
        v, tiles = ctx.saved_tensors
        bsr = ctx.bsr
        u = u.contiguous()
        dv = dtiles = None
        if ctx.needs_input_grad[3]:
            if ctx.symmetric:
                dv = bsr_spmv_rows(bsr, u, tiles, ctx.packer)
            else:
                dv = bsr_transpose_matvec(bsr, u, tiles)
        if ctx.needs_input_grad[4]:
            u2 = _padded_rows(bsr, u)
            vg = sparse.bsr_gather_vblocks(bsr, v)
            dtiles = u2[:, None, :, None] * vg[:, :, None, :]
        return None, None, None, dv, dtiles


def bsr_matvec_fused(bsr, *, symmetric: bool):
    """Differentiable matvec ``matvec(v, tiles) -> A @ v`` through K10.

    ``symmetric=True`` (the Krylov use) runs K10 for the cotangent
    matvec too; otherwise the transpose is a scatter-add. The operator's
    packer is ``matvec.packer``: one pack serves every call with the same
    tiles tensor (a Lanczos VJP's forward and adjoint).
    """
    packer = BsrPacker(bsr)

    def matvec(v, tiles):
        return _BsrMatvec.apply(bsr, packer, symmetric, v, tiles)

    matvec.packer = packer
    return matvec


def fem_test_matrix(n_grid: int, *, dofs: int = 3, seed: int = 0):
    """Synthetic bcsstk-class stiffness pattern: 3-D hexahedral mesh,
    ``dofs`` unknowns per node, 27-point vertex coupling (~81 nnz/row at
    dofs=3, the density class of bcsstk17/18).

    The JAX package's generator, call for call, so that the two give the
    same matrix bit for bit. Returns a ``CSRMatrix`` (symmetric,
    diagonally dominant SPD).
    """
    rng = np.random.default_rng(seed)
    g = n_grid
    nodes = g * g * g
    idx = np.arange(nodes).reshape(g, g, g)
    rows, cols = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                src = idx[
                    max(0, -di) : g - max(0, di),
                    max(0, -dj) : g - max(0, dj),
                    max(0, -dk) : g - max(0, dk),
                ].ravel()
                dst = idx[
                    max(0, di) : g - max(0, -di),
                    max(0, dj) : g - max(0, -dj),
                    max(0, dk) : g - max(0, -dk),
                ].ravel()
                rows.append(src)
                cols.append(dst)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    # Expand to dofs x dofs node blocks.
    r = np.repeat(rows * dofs, dofs * dofs) + np.tile(np.repeat(np.arange(dofs), dofs), len(rows))
    c = np.repeat(cols * dofs, dofs * dofs) + np.tile(np.tile(np.arange(dofs), dofs), len(cols))
    n = nodes * dofs
    vals = rng.standard_normal(len(r)).astype(np.float32)
    # Symmetrise and make diagonally dominant (SPD).
    key = r * n + c
    key_t = c * n + r
    order = np.argsort(key)
    order_t = np.argsort(key_t)
    vals_sym = 0.5 * (vals[order] + vals[order_t])
    r, c = r[order], c[order]
    mat = sparse.csr_from_coo(r, c, vals_sym, shape=(n, n))
    # Add 100 * I for diagonal dominance.
    diag = np.isclose(mat.rows, mat.indices).astype(np.float32) * 100.0
    return mat._replace(data=mat.data + diag)
