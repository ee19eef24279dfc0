"""Experiment utilities: test matrices, random trees, directories, MatrixMarket
reading and SuiteSparse loading for the sparse operators, spy plots.

Counterpart of ``lanczos_adjoints_tpu/utils/exp_util.py``: ``hilbert``,
``tree_random_like`` (its draws from a ``torch.Generator``),
``matching_directory``, ``mtx_read``, ``suite_sparse_load`` and
``plt_spy_coo``. ``mtx_read`` uses ``scipy.io.mmread`` when scipy is
installed, a numpy body parser otherwise (the JAX package's C parser
belongs to that package and is not used). Symmetric files are expanded to
full storage; ``.gz`` and ``.tar.gz`` containers are read transparently.
``suite_sparse_download`` and ``uci_dataset_mlrepo`` need the network and
are not ported.
"""

import gzip
import os
import tarfile

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import sparse


def hilbert(ndim: int, /, *, dtype=None, device=None):
    """The Hilbert matrix ``1 / (1 + i + j)``: an ill-conditioned SPD test
    matrix, computed in ``dtype`` (default: torch's default float dtype)."""
    a = torch.arange(ndim, dtype=dtype or torch.get_default_dtype(), device=device)
    return 1.0 / (1.0 + a[:, None] + a[None, :])


def _flatten(tree):
    """``(leaves, rebuild)`` of a tensor or a nested dict, list or tuple of them,
    dict keys sorted, as ``jax.flatten_util.ravel_pytree`` orders them."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[key]) for key in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(item) for item in tree]
    else:
        msg = f"a tree of tensors, not {type(tree).__name__}"
        raise TypeError(msg)
    counts = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        items, start = [], 0
        for (_, sub), count in zip(parts, counts):
            items.append(sub(leaves[start : start + count]))
            start += count
        return dict(zip(keys, items)) if keys is not None else type(tree)(items)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def tree_random_like(generator: torch.Generator, tree, /):
    """A tree shaped like ``tree`` of standard-normal values, drawn from ``generator``
    as one flat vector in ``ravel_pytree``'s order."""
    leaves, rebuild = _flatten(tree)
    size = sum(leaf.numel() for leaf in leaves)
    dtype = leaves[0].dtype if leaves else torch.float32
    flat = torch.randn((size,), generator=generator, dtype=dtype, device=generator.device)
    out, start = [], 0
    for leaf in leaves:
        out.append(flat[start : start + leaf.numel()].reshape(leaf.shape).to(leaf.device))
        start += leaf.numel()
    return rebuild(out)


def matching_directory(file: str, where: str, /, *, replace: str = "experiments/"):
    """Mirror an experiment script's path into ``results/``, ``figures/`` or ``data/``.

    ``matching_directory(__file__, "results/")`` maps
    ``.../experiments/foo/bar.py`` to ``.../results/foo/bar/``.
    """
    if where not in ("results/", "figures/", "data/"):
        msg = f"where={where!r} not in ('results/', 'figures/', 'data/')"
        raise ValueError(msg)
    directory = os.path.dirname(os.path.abspath(file))
    basename = os.path.splitext(os.path.basename(file))[0]
    if replace not in directory:
        msg = f"{replace!r} not part of {directory!r}"
        raise ValueError(msg)
    return directory.replace(replace, where) + f"/{basename}/"


def plt_spy_coo(ax, rows, cols, /, *, shape, markersize=1.0, color="black"):
    """Sparsity ("spy") plot of a COO pattern onto a matplotlib axis."""
    ax.scatter(cols, rows, s=markersize, c=color, marker="s", linewidths=0)
    ax.set_xlim(-0.5, shape[1] - 0.5)
    ax.set_ylim(shape[0] - 0.5, -0.5)
    ax.set_aspect("equal")
    return ax


def mtx_read(path: str, /):
    """Parse a MatrixMarket coordinate file -> ``(rows, cols, vals, shape)``.

    General, symmetric, skew-symmetric and hermitian coordinate files with
    real, integer or pattern values; zero-based indices.
    """
    coo = _mmread_scipy(path)
    if coo is not None:
        rows = coo.row.astype(np.int64)
        cols = coo.col.astype(np.int64)
        vals = np.asarray(coo.data, dtype=np.float64)
        return rows, cols, vals, coo.shape
    return _mtx_read_builtin(path)


def _tar_member(tar, path):
    members = [m for m in tar.getmembers() if m.name.endswith(".mtx")]
    if not members:
        msg = f"No .mtx member inside {path}"
        raise FileNotFoundError(msg)
    return tar.extractfile(members[0])


def _mmread_scipy(path: str):
    """``scipy.io.mmread`` as a COO matrix, or None without scipy."""
    try:
        from scipy.io import mmread
        from scipy.sparse import coo_matrix
    except ImportError:
        return None
    if path.endswith(".tar.gz"):
        with tarfile.open(path, "r:gz") as tar:
            mat = mmread(_tar_member(tar, path))
    else:
        mat = mmread(path)
    if not hasattr(mat, "tocoo"):  # dense array format
        mat = coo_matrix(mat)
    return mat.tocoo()


def _mtx_read_builtin(path: str, /):
    if path.endswith(".tar.gz"):
        with tarfile.open(path, "r:gz") as tar:
            data = _tar_member(tar, path).read().decode()
    elif path.endswith(".gz"):
        with gzip.open(path, "rt") as fp:
            data = fp.read()
    else:
        with open(path) as fp:
            data = fp.read()

    lines = data.splitlines()
    header = lines[0].lower().split()
    if len(header) < 5 or header[0] != "%%matrixmarket":
        msg = f"Not a MatrixMarket file: {path}"
        raise ValueError(msg)
    _, obj, fmt, field, symmetry = header[:5]
    if obj != "matrix" or fmt != "coordinate":
        msg = f"Only coordinate matrices supported, got {obj}/{fmt}"
        raise ValueError(msg)

    # The size line: the first non-comment line after the header.
    pos = 1
    while lines[pos].strip() == "" or lines[pos].startswith("%"):
        pos += 1
    nrows, ncols, nnz = (int(t) for t in lines[pos].split()[:3])

    body = [ln for ln in lines[pos + 1 :] if ln.strip() and not ln.startswith("%")]
    entries = body[:nnz]
    if field == "pattern":
        arr = np.loadtxt(entries, dtype=np.int64, ndmin=2)
        rows, cols = arr[:, 0] - 1, arr[:, 1] - 1
        vals = np.ones(len(rows), dtype=np.float64)
    else:
        arr = np.loadtxt(entries, dtype=np.float64, ndmin=2)
        rows = arr[:, 0].astype(np.int64) - 1
        cols = arr[:, 1].astype(np.int64) - 1
        vals = arr[:, 2] if arr.shape[1] > 2 else np.ones(len(rows))

    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols = np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, sign * vals[off]])

    return rows, cols, vals, (nrows, ncols)


def suite_sparse_load(which: str, /, path: str = "./data/matrices/") -> sparse.CSRMatrix:
    """Load a SuiteSparse matrix from ``path`` as the port's ``CSRMatrix``.

    Tries ``path/<which>/<which>.mtx``, ``path/<which>.mtx`` and
    ``path/<which>.tar.gz``; raises ``FileNotFoundError`` if none exists.
    """
    candidates = [
        os.path.join(path, which, f"{which}.mtx"),
        os.path.join(path, f"{which}.mtx"),
        os.path.join(path, f"{which}.tar.gz"),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            rows, cols, vals, shape = mtx_read(cand)
            return sparse.csr_from_coo(rows, cols, vals, shape=shape)
    msg = f"Matrix {which!r} not found under {path!r} (tried {candidates})"
    raise FileNotFoundError(msg)
