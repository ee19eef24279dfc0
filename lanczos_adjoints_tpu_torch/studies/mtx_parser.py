"""The MatrixMarket loader's three parsers, timed from file to CSR.

Counterpart of ``experiments/benchmarks/mtx_parser/benchmark.py``: a
synthetic ``.mtx`` file of ``--n`` rows with ``--nnz_per_row`` entries
each (``synth_mtx``, the JAX script's draws and lines, so the same
bytes), loaded by ``utils.exp_util.suite_sparse_load`` three ways:

- ``scipy``: ``scipy.io.mmread`` (the loader's first choice), best of 3;
- ``native``: the port's C++ body parser (``native/mtxparse.cc``), with
  scipy switched off inside the study, once;
- ``numpy``: the numpy body parser, with ``native.DISABLE`` set, once.

Each switch is restored in a ``finally``. The three must give the same
CSR (the same ``indptr`` and ``indices``, the values bit for bit), or
the study raises. Host work only: no tensor, no card. ``python -m
lanczos_adjoints_tpu_torch.studies.mtx_parser [--n 1000000]
[--nnz_per_row 8] [--out FILE]`` prints each path's seconds and MB/s
as the JAX script does, and writes them with the file size and the
nnz into ``FILE`` as JSON.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from lanczos_adjoints_tpu_torch import native
from lanczos_adjoints_tpu_torch.utils import exp_util

PATHS = ("scipy", "native", "numpy")


def synth_mtx(path, n, nnz_per_row, seed=0):
    """Write a general real ``n x n`` MatrixMarket file; return its size in bytes."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n + 1), nnz_per_row)
    cols = rng.integers(1, n + 1, len(rows))
    vals = rng.normal(size=len(rows))
    with open(path, "w") as fp:
        fp.write("%%MatrixMarket matrix coordinate real general\n")
        fp.write(f"{n} {n} {len(rows)}\n")
        np.savetxt(fp, np.column_stack([rows, cols, vals]), fmt="%d %d %.9g")
    return os.path.getsize(path)


def time_load(name, directory, repeats=3):
    """``(best seconds, CSR)`` of ``repeats`` loads of ``name`` from ``directory``."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        mat = exp_util.suite_sparse_load(name, path=directory)
        ts.append(time.perf_counter() - t0)
    return min(ts), mat


def _same_csr(a, b) -> bool:
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and a.data.dtype == b.data.dtype and a.data.tobytes() == b.data.tobytes())


def run(n, nnz_per_row, *, seed=0) -> dict:
    """Time the three paths on a synthetic file; raise unless their CSRs agree."""
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/synth")
        size = synth_mtx(f"{tmp}/synth/synth.mtx", n, nnz_per_row, seed=seed)
        print(f"synthetic mtx: {size / 1e6:.0f} MB, {n * nnz_per_row} nnz", flush=True)
        seconds, mats = {}, {}
        seconds["scipy"], mats["scipy"] = time_load("synth", tmp + "/")
        scipy_path, exp_util._mmread_scipy = exp_util._mmread_scipy, lambda _p: None
        try:
            native.get_mtxparse()  # built before the clock starts
            seconds["native"], mats["native"] = time_load("synth", tmp + "/", repeats=1)
            native.DISABLE = True
            try:
                seconds["numpy"], mats["numpy"] = time_load("synth", tmp + "/", repeats=1)
            finally:
                native.DISABLE = False
        finally:
            exp_util._mmread_scipy = scipy_path
    labels = {"scipy": "scipy fast path:  ", "native": "native C++ parser:", "numpy": "numpy fallback:   "}
    for path in PATHS:
        print(f"{labels[path]} {seconds[path]:.2f} s ({size / seconds[path] / 1e6:.0f} MB/s)", flush=True)
    differ = [path for path in PATHS[1:] if not _same_csr(mats[path], mats["scipy"])]
    if differ:
        msg = f"the {', '.join(differ)} path(s) gave another CSR than scipy's"
        raise RuntimeError(msg)
    return {
        "n": n, "nnz_per_row": nnz_per_row, "nnz": mats["scipy"].nnz, "file_bytes": size,
        "seconds": seconds, "mb_per_s": {path: size / seconds[path] / 1e6 for path in PATHS},
        "csr": mats["scipy"],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--nnz_per_row", type=int, default=8)
    parser.add_argument("--out", type=str, default=None, help="a JSON file for the sizes and rates")
    args = parser.parse_args(argv)
    result = run(args.n, args.nnz_per_row)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({k: v for k, v in result.items() if k != "csr"}, fp, indent=2)
    return result


if __name__ == "__main__":
    main()
