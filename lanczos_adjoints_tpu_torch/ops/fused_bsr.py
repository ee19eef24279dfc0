"""Block-ELL sparse matvec: the CUDA kernel K10 and its plain version.

Counterpart of ``lanczos_adjoints_tpu/ops/pallas_bsr.py``. For a BSR
operator (``ops.sparse.BSRData``: ``(8, 128)`` tiles, block-ELL padded)
K10 (``csrc/bsr.cu`` ``lat_bsr_spmv``) computes

    out[b * 8 + r] = sum_w sum_c tiles[b, w, r, c] * v[block_cols[b, w] * 128 + c]

gathering ``v`` inside the kernel. A wrapper launches it for CUDA tensors
and runs the plain gather-and-einsum version (``ops.sparse.bsr_matvec_fn``)
for CPU tensors; there is no other path.

``bsr_matvec_fused(bsr, symmetric=...)`` wraps it in a
``torch.autograd.Function``: the cotangent matvec is K10 again for a
symmetric operator and the JAX package's block scatter-add transpose
(PyTorch ops, as it is XLA there) otherwise; the value gradient
``dtiles[n, w, r, c] = u[n, r] * v_blocks[n, w, c]`` is a broadcast, as
in the JAX package. Each runs only when its input needs a gradient.
"""

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import native, sparse

BSR_SPMV = native.Kernel("bsr_spmv", "bsr", "lat_bsr_spmv")
_KERNEL_TILE_ROWS = 8  # kRows in csrc/bsr.cu


def bsr_spmv_plain(bsr, v, tiles):
    """Plain K10: gather the source blocks, contract each tile against its block."""
    return sparse.bsr_matvec_fn(bsr)(v, tiles)


def bsr_spmv_rows(bsr, v, tiles):
    """K10: ``v (n_cols,)``, ``tiles (nbr, width, tile_rows, 128)`` -> ``(n_rows,)``."""
    device = v.device
    for a in (v, tiles):
        if a.device != device:
            msg = f"all operands must lie on one device, got {a.device} and {device}"
            raise ValueError(msg)
        if a.dtype != torch.float32:
            msg = f"the BSR kernel takes float32, got {a.dtype}"
            raise TypeError(msg)
        if not a.is_contiguous():
            raise ValueError("the BSR kernel takes contiguous operands")
    nbr = bsr.padded_n // bsr.tile_rows
    want = (nbr, bsr.width, bsr.tile_rows, sparse.BSR_TILE)
    if v.shape != (bsr.shape[1],) or tuple(tiles.shape) != want:
        msg = f"shape mismatch: v {tuple(v.shape)}, tiles {tuple(tiles.shape)}, expected {want}"
        raise ValueError(msg)
    if device.type == "cpu":
        return bsr_spmv_plain(bsr, v, tiles)
    if device.type != "cuda":
        msg = f"no BSR kernel for device {device}"
        raise ValueError(msg)
    if bsr.tile_rows != _KERNEL_TILE_ROWS:
        msg = f"the BSR kernel takes tile_rows={_KERNEL_TILE_ROWS}, got {bsr.tile_rows}"
        raise ValueError(msg)
    if tiles.data_ptr() % 16:
        raise ValueError("the BSR kernel takes 16-byte aligned tiles")
    if v.data_ptr() % 16:  # a view into a row of odd length: a fresh, aligned copy
        v = v.clone()
    out = torch.empty(bsr.shape[0], dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        BSR_SPMV.launch(
            tiles.data_ptr(), bsr.block_cols.data_ptr(), v.data_ptr(), out.data_ptr(),
            nbr, bsr.width, bsr.shape[0], bsr.shape[1], native.stream(device),
        )
    return out


def bsr_spmv_fused(bsr):
    """Raw matvec ``(v, tiles) -> A @ v`` through K10 (not differentiable)."""
    return lambda v, tiles: bsr_spmv_rows(bsr, v.contiguous(), tiles.contiguous())


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
    def forward(ctx, bsr, symmetric, v, tiles):
        ctx.bsr = bsr
        ctx.symmetric = symmetric
        ctx.save_for_backward(v, tiles)
        return bsr_spmv_rows(bsr, v.contiguous(), tiles.contiguous())

    @staticmethod
    def backward(ctx, u):
        v, tiles = ctx.saved_tensors
        bsr = ctx.bsr
        u = u.contiguous()
        dv = dtiles = None
        if ctx.needs_input_grad[2]:
            if ctx.symmetric:
                dv = bsr_spmv_rows(bsr, u, tiles.contiguous())
            else:
                dv = bsr_transpose_matvec(bsr, u, tiles)
        if ctx.needs_input_grad[3]:
            u2 = _padded_rows(bsr, u)
            vg = sparse.bsr_gather_vblocks(bsr, v)
            dtiles = u2[:, None, :, None] * vg[:, :, None, :]
        return None, None, dv, dtiles


def bsr_matvec_fused(bsr, *, symmetric: bool):
    """Differentiable matvec ``matvec(v, tiles) -> A @ v`` through K10.

    ``symmetric=True`` (the Krylov use) runs K10 for the cotangent
    matvec too; otherwise the transpose is a scatter-add.
    """

    def matvec(v, tiles):
        return _BsrMatvec.apply(bsr, symmetric, v, tiles)

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
