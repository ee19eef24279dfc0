"""Test matrices and assertions, and operators built in the repository, for tests,
smoke runs and benchmarks.

The first four functions are the counterparts of
``lanczos_adjoints_tpu/utils/test_util.py``. Their draws come from the
``torch.Generator`` the caller passes, so the matrices have the JAX
package's spectra, not its bases.
"""

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import sparse


def symmetric_matrix_from_eigenvalues(eigvals, /, *, generator: torch.Generator):
    """A symmetric matrix with the eigenvalues ``eigvals``, on a random orthogonal basis."""
    (n,) = eigvals.shape
    draw = torch.randn((n, n), generator=generator, dtype=eigvals.dtype, device=generator.device)
    basis, _ = torch.linalg.qr(draw.to(eigvals.device))
    return (basis * eigvals[None, :]) @ basis.T


def asymmetric_matrix_from_eigenvalues(eigvals, /, *, generator: torch.Generator):
    """A diagonalisable nonsymmetric matrix with the spectrum ``eigvals``."""
    (n,) = eigvals.shape
    draw = torch.randn((n, n), generator=generator, dtype=eigvals.dtype, device=generator.device)
    basis = draw.to(eigvals.device) + n * torch.eye(n, dtype=eigvals.dtype, device=eigvals.device)
    return basis @ torch.diag(eigvals) @ torch.linalg.inv(basis)


def assert_columns_orthonormal(Q, /, *, atol=1e-5):
    """Assert that the columns of ``Q`` are orthonormal."""
    _, k = Q.shape
    gram = Q.T.conj() @ Q
    assert torch.allclose(gram, torch.eye(k, dtype=gram.dtype, device=gram.device), atol=atol), gram


def assert_allclose(a, b, /, *, atol=None, rtol=None):
    """``torch.allclose`` with the square root of the common dtype's eps as default tolerances."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    tol = float(torch.finfo(torch.result_type(a, b)).eps) ** 0.5
    atol = tol if atol is None else atol
    rtol = tol if rtol is None else rtol
    assert torch.allclose(a, b.to(a.dtype), atol=atol, rtol=rtol), (a, b)


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
