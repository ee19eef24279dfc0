"""SpMV time across the sparse formats (DIA, BSR, ELL) on the card.

Counterpart of ``experiments/benchmarks/spmv_formats/benchmark.py``: the
matvec and the VJP in x (``grad`` of ``sum(matvec(x, values)**2)``) of
each layout of ``ops.sparse`` on stencil, FEM and scattered patterns, at
the TPU script's cases and defaults:

- ``laplacian_2d`` (``--grid``, 1024): ``dia`` and ``dia_kernel``;
- ``laplacian_2d_small`` (``--grid // 4``): ``dia``, ``dia_kernel``, ``ell``;
- ``fem_3dof`` and ``fem_3dof_rcm`` (``ops.fused_bsr.fem_test_matrix(
  --fem_grid, dofs=3)``, 24, and its reverse Cuthill-McKee permutation):
  ``bsr`` and ``bsr_kernel``;
- ``random`` (``--random_n`` rows, 65,536, ``--random_nnz_per_row``
  nonzeros each, 8): ``ell`` and ``ell_gather``;
- ``bloweybq``: ``hyb`` and ``coo``, once ``data/matrices/bloweybq.mtx``
  is in the repository; until then one line names the missing file.

``dia`` and ``bsr`` are the plain PyTorch matvecs (``dia_matvec_fn``,
``bsr_matvec_fn``); ``dia_kernel`` is K4 with K4 on the transpose for the
VJP (``ops.fused_dia.dia_matvec_fused``), ``bsr_kernel`` K10 both ways
(``ops.fused_bsr.bsr_matvec_fused``, the FEM matrix being symmetric): the
TPU script's ``dia_pallas`` and ``bsr_pallas``. Each is built explicitly,
so that no row measures another's code. On the card both ELL paths are
one element gather (``ops.sparse.ell_matvec_fn_gather`` is
``ell_matvec_fn``): ``ell_gather`` is timed once, as ``ell``, and its row
says so (``"same_as": "ell"``).

A time is the device time per call over ``REPS`` calls on one operand
set (``utils.timing.device_seconds``: CUDA events around calls queued
behind a spin that hides the host's launch time, a host clock off the
card). ``python -m lanczos_adjoints_tpu_torch.studies.
spmv_formats [--grid 1024] [--random_n 65536] [--random_nnz_per_row 8]
[--fem_grid 24] [--device cuda] --out DIR`` writes ``formats.json``: one
row a case and format, ``{"case", "format", "time_s", "time_vjp_s",
"nnz_per_s", "fill"}`` as the TPU script writes them (``"unresolved":
true`` with the times None where a time is not positive, and with the
times kept as upper bounds where the host enqueued the calls more slowly
than the device ran them).
"""

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import fused_bsr, fused_dia, native, sparse
from lanczos_adjoints_tpu_torch.utils import exp_util, test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import device_seconds

REPS = 16  # calls a timed run: a plain VJP queues ~40 kernels a call, and a held stream ~1,000
MATRICES = Path(__file__).resolve().parents[2] / "data" / "matrices"


laplacian_2d = test_util.laplacian_2d  # the TPU script's 5-point grid Laplacian


def random_csr(n, nnz_per_row, seed=0):
    """``nnz_per_row`` standard-normal entries a row at uniform columns (duplicates summed)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, n, len(rows))
    vals = rng.normal(size=len(rows))
    return sparse.csr_from_coo(rows, cols, vals, shape=(n, n))


def cases(grid=1024, random_n=65536, random_nnz_per_row=8, fem_grid=24, *, matrices=MATRICES) -> list:
    """``(case, CSRMatrix, formats)`` in the TPU script's order; a case whose
    matrix file is missing is printed and left out."""
    fem = fused_bsr.fem_test_matrix(fem_grid, dofs=3)
    fem_rcm = sparse.permute_symmetric(fem, sparse.reverse_cuthill_mckee(fem))
    out = [
        ("laplacian_2d", laplacian_2d(grid), ["dia", "dia_kernel"]),
        ("laplacian_2d_small", laplacian_2d(grid // 4), ["dia", "dia_kernel", "ell"]),
        ("fem_3dof", fem, ["bsr", "bsr_kernel"]),
        ("fem_3dof_rcm", fem_rcm, ["bsr", "bsr_kernel"]),
        ("random", random_csr(random_n, random_nnz_per_row), ["ell", "ell_gather"]),
    ]
    try:
        out.append(("bloweybq", exp_util.suite_sparse_load("bloweybq", path=str(matrices)), ["hyb", "coo"]))
    except FileNotFoundError:
        print(f"bloweybq: {matrices.parent.name}/{matrices.name}/bloweybq.mtx is not in the repository; its case "
              "(hyb, coo) waits "
              "for the file", flush=True)
    return out


def operator(mat, fmt, *, device="cuda"):
    """``(matvec, values, OperatorInfo)`` of ``fmt``, built explicitly."""
    n = mat.shape[0]
    if fmt in ("dia", "dia_kernel"):
        dia = sparse.dia_pack(mat)
        values = sparse.dia_values(dia, mat.data, device=device)
        matvec = (fused_dia.dia_matvec_fused(dia, check_tiling=False) if fmt == "dia_kernel"
                  else sparse.dia_matvec_fn(dia))
        stored = dia.num_slots
    elif fmt in ("bsr", "bsr_kernel"):
        bsr = sparse.bsr_pack(mat, device=device)
        values = sparse.bsr_values(bsr, mat.data, device=device)
        matvec = (fused_bsr.bsr_matvec_fused(bsr, symmetric=mat.is_symmetric()) if fmt == "bsr_kernel"
                  else sparse.bsr_matvec_fn(bsr))
        stored = bsr.num_slots
    elif fmt == "coo":
        matvec, values = sparse.coo_matvec_fn(mat, device=device)
        info = sparse.OperatorInfo(format=fmt, stored_slots=mat.nnz, nnz=mat.nnz,
                                   bytes_per_matvec=3 * mat.nnz * 4 + 2 * n * 4)
        return matvec, values, info
    elif fmt in ("ell", "ell_gather", "hyb"):
        matvec, values, info = sparse.sparse_operator(mat, format="hyb" if fmt == "hyb" else "ell",
                                                      with_info=True, device=device)
        if fmt == "ell_gather":
            matvec = sparse.ell_matvec_fn_gather(sparse.ell_pack(mat, device=device))
        return matvec, values, info._replace(format=fmt)
    else:
        msg = f"format {fmt!r} not in ('dia', 'dia_kernel', 'bsr', 'bsr_kernel', 'ell', 'ell_gather', 'hyb', 'coo')"
        raise ValueError(msg)
    info = sparse.OperatorInfo(format=fmt, stored_slots=stored, nnz=mat.nnz,
                               bytes_per_matvec=stored * 4 + 2 * n * 4)
    return matvec, values, info


def _args(values):
    return values if isinstance(values, tuple) else (values,)


def vjp_in_x(matvec):
    """``grad(v, values)``: the gradient in x of ``sum(matvec(x, values)**2)`` at ``v``."""

    def grad(v, values):
        x = v.detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(matvec(x, *_args(values)) ** 2), [x])
        return g

    return grad


def predicted_launches(fmt) -> dict:
    """The kernels one matvec and one VJP in x of ``fmt`` launch: K4 and K4 on
    the transpose for ``dia_kernel`` (no K5: the values need no gradient),
    K10 twice for ``bsr_kernel`` (a symmetric operator), none otherwise."""
    if fmt == "dia_kernel":
        return {"matvec": {"dia_matvec": 1}, "vjp": {"dia_matvec": 1, "dia_matvec_transposed": 1}}
    if fmt == "bsr_kernel":
        return {"matvec": {"bsr_spmv": 1}, "vjp": {"bsr_spmv": 2}}
    return {"matvec": {}, "vjp": {}}


def _launched(fn):
    """``(fn(), {kernel: launches})`` of one call, the card synchronised."""
    native.reset_launches()
    out = fn()
    if out.is_cuda:
        torch.cuda.synchronize()
    return out, {k: c for k, c in native.launch_counts().items() if c}


def run(case_list, *, device="cuda") -> tuple:
    """``(rows, outputs, launches)``: the JSON rows; ``{(case, format): (A v,
    VJP in x)}`` at the all-ones v of one call each; the kernels launched by
    that matvec and that VJP."""
    rows, outputs, launches = [], {}, {}
    for case_name, mat, formats in case_list:
        v = torch.ones(mat.shape[0], dtype=torch.float32, device=device)
        for fmt in formats:
            if fmt == "ell_gather" and (case_name, "ell") in outputs:
                timed = next(r for r in rows if r["case"] == case_name and r["format"] == "ell")
                rows.append(dict(timed, format=fmt, same_as="ell"))
                outputs[(case_name, fmt)] = outputs[(case_name, "ell")]
                launches[(case_name, fmt)] = launches[(case_name, "ell")]
                print(f"{case_name}/{fmt}: the same function as ell on the card; not timed again", flush=True)
                continue
            try:
                matvec, values, info = operator(mat, fmt, device=device)
            except Exception as err:  # noqa: BLE001
                print(f"{case_name}/{fmt}: pack failed ({type(err).__name__}: {err})", flush=True)
                continue
            grad = vjp_in_x(matvec)
            out, mv_launches = _launched(lambda: matvec(v, *_args(values)))
            g, vjp_launches = _launched(lambda: grad(v, values))
            outputs[(case_name, fmt)] = (out.detach(), g)
            launches[(case_name, fmt)] = {"matvec": mv_launches, "vjp": vjp_launches}
            t, clock = device_seconds(lambda: matvec(v, *_args(values)), reps=REPS, device=device)
            t_vjp, clock_vjp = device_seconds(lambda: grad(v, values), reps=REPS, device=device)
            nnz_s = mat.nnz / t if t > 0 else None
            print(f"{case_name}/{fmt}: {t * 1e3:.4f} ms/matvec ({(nnz_s or 0.0) / 1e9:.2f} Gnnz/s, "
                  f"{(nnz_s or 0.0) * info.bytes_per_matvec / mat.nnz / 1e9:.0f} GB/s eff, "
                  f"fill {info.fill_efficiency:.3f}); "
                  f"vjp {t_vjp * 1e3:.4f} ms ({clock}, {clock_vjp}); launches {launches[(case_name, fmt)]}",
                  flush=True)
            row = {"case": case_name, "format": fmt, "time_s": t, "time_vjp_s": t_vjp, "nnz_per_s": nnz_s,
                   "fill": info.fill_efficiency}
            if not t > 0:
                row["time_s"] = row["nnz_per_s"] = None
                row["unresolved"] = True
            if not t_vjp > 0:
                row["time_vjp_s"] = None
                row["unresolved"] = True
            if "host-bound" in clock + clock_vjp:  # the times are upper bounds
                row["unresolved"] = True
            rows.append(row)
    return rows, outputs, launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--grid", type=int, default=1024)
    parser.add_argument("--random_n", type=int, default=65536)
    parser.add_argument("--random_nnz_per_row", type=int, default=8)
    parser.add_argument("--fem_grid", type=int, default=24)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    print(args, flush=True)
    pin_float32()
    case_list = cases(args.grid, args.random_n, args.random_nnz_per_row, args.fem_grid)
    rows, outputs, launches = run(case_list, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "formats.json"), "w") as fp:
        json.dump(rows, fp, indent=2)
    return rows, outputs, launches


if __name__ == "__main__":
    main()
