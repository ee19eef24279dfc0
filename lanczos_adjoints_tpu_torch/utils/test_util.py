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


def banded_symmetric(n: int, offsets, *, seed: int = 3) -> sparse.CSRMatrix:
    """A symmetric banded operator on the ``offsets`` (closed under negation).

    ``4 + U(0, 1)`` on the diagonal and ``N(0, 0.3^2)`` off it, with
    ``A[i, i + d] = A[i + d, i]``: the operator of the JAX package's halo
    kernel tests, bit for bit for the same ``seed``.
    """
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    sym_vals = {}
    for d in offsets:
        ok = (idx + d >= 0) & (idx + d < n)
        rows.append(idx[ok])
        cols.append((idx + d)[ok])
        if d == 0:
            vals.append(4.0 + rng.random(ok.sum()))
        else:
            if abs(d) not in sym_vals:
                sym_vals[abs(d)] = rng.normal(size=n, scale=0.3)
            vals.append(sym_vals[abs(d)][np.minimum(idx[ok], (idx + d)[ok])])
    return sparse.csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), shape=(n, n)
    )


def five_diagonal(n: int, bandwidth: int) -> sparse.CSRMatrix:
    """``4`` on the diagonal, ``-1`` on offsets ``+-1`` and ``+-bandwidth``.

    The operator of the JAX package's multi-device scaling benchmark
    (``experiments/benchmarks/multihost_scaling``), whose defaults are
    n = 2^20 and bandwidth 1024.
    """
    idx = np.arange(n)
    rows, cols, vals = [], [], []
    for d in (-bandwidth, -1, 0, 1, bandwidth):
        lo, hi = max(0, -d), min(n, n - d)
        rows.append(idx[lo:hi])
        cols.append(idx[lo:hi] + d)
        vals.append((4.0 if d == 0 else -1.0) * np.ones(hi - lo))
    return sparse.csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), shape=(n, n)
    )
