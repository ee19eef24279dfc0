"""Operators built in the repository, for tests, smoke runs and benchmarks."""

import numpy as np

from lanczos_adjoints_tpu_torch.ops import sparse


def laplacian_2d(m: int) -> sparse.CSRMatrix:
    """The 5-point Laplacian on an m x m grid (Dirichlet), as CSR.

    ``4`` on the diagonal and ``-1`` for each grid neighbour: n = m^2
    rows, offsets ``{-m, -1, 0, 1, m}``. Bit for bit the operator of the
    headline benchmark (``bench.py``); m = 128 gives n = 16,384 and
    nnz = 81,408.
    """
    n = m * m
    idx = np.arange(n)
    rows, cols, vals = [idx], [idx], [4.0 * np.ones(n)]
    i, j = idx // m, idx % m
    for di, dj in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        ni, nj = i + di, j + dj
        ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
        rows.append(idx[ok])
        cols.append((ni * m + nj)[ok])
        vals.append(-1.0 * np.ones(ok.sum()))
    return sparse.csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), shape=(n, n)
    )
