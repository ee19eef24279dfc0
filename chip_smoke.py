"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to their plain versions.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository; it exits non-zero without
printing a result when any of them is missing or any phase fails.

Phases, in order:
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (one nvcc per source, in parallel), with its time;
  3. kernel parity: K1 (``csrc/gram_matvec.cu``) with its autograd
     backward, and K2 (``csrc/gram_grads.cu``), against their plain
     PyTorch versions on the card, for rbf / matern12 / matern32,
     d in {1, 8, 12, 40}, scalar and ARD lengthscales, K1 at m in
     {1, 15, 40} and K2 at m in {1, 225}, ragged row counts;
  4. the oracle: at N = 2,048 the Krylov marginal likelihood against a
     dense Cholesky one, and its gradient through the kernels against
     the gradient through the plain versions;
  5. the slice: Adam steps of the GP training step at N_train = 400,000
     (the reference's largest configuration), with per-step K1/K2
     launch counts;
  6. DIA parity: K4 (``csrc/dia.cu``), K4 on the transpose (through the
     autograd backward) and K5 against their plain versions, offsets
     (-1, 0, 1), (-130, -7, 0, 7, 130) with random values in every slot,
     and the 2-D Laplacian's with its packed values, n in {16,384,
     1,000,000, 1,048,576};
  7. Lanczos parity: K6 and K7 (``csrc/lanczos_dia.cu``) against their
     plain versions (alphas, betas, basis, residual, dv, dvals for a
     seeded random cotangent) at (n, K) = (4,736, 12), (4,739, 12),
     (16,384, 90), (1,048,576, 90) and on an exhausted Krylov space,
     with each tolerance derived from the plain version's
     float32-vs-float64 spread; the autograd Function equals the two
     wrappers bit for bit;
  8. the sparse slice: ``bench.py``'s flow through the port's entry
     points (the Laplacian on an m x m grid -> ``sparse_operator`` ->
     ``tridiag_dia_fused`` and the generic ``tridiag``), one VJP with the
     all-ones cotangent per route at m = 128, 1,000 and 1,024, with
     launches per VJP, the dispatch log, fused vs generic, and VJP wall
     times;
  9. kernel times at the slices' shapes beside their bounds, their
     plain versions' times and (K4) one library call, each held to its
     plain version again. K4 and K5 cycle through operand sets larger
     than the L2 together, as the main path does;
 10. Arnoldi parity: K9 (``csrc/arnoldi_dia.cu``) against its plain
     version (Q, H, residual, 1/|v0|) and the autograd Function (K9
     forward, adjoint over the transposed K4 and K5) against the plain
     forward and adjoint, at (n, K) from (4,736, 12) to (1,000,000, 90),
     with and without re-orthogonalisation, and on an exhausted Krylov
     space (exactly);
 11. the Arnoldi slice: ``sparse_operator`` -> ``hessenberg`` (K = 90)
     and ``tridiag(reortho="full")`` (K = 10, 90, 250) at the 128 x 128
     Laplacian and ``hessenberg`` at 1000 x 1000, one VJP with the
     all-ones cotangent per route: launches per VJP, dispatch log, fused
     vs generic, adjoint vs backprop, wall times, a profiled run;
 12. per-probe SLQ: ``krylov_logdet_slq(90, 10 probes, blocked=False)``
     and its gradient on the 128 x 128 Laplacian against the
     closed-form log-determinant;
 13. the wave-PDE training step at 128 x 128 on the bundled pairs: the
     adjoint gradient against backprop, then three Adam steps;
 14. K9's time per launch beside its bound and plain version. The
     kernels of every slice, with their numbers, form one JSON line.
The last two lines are the card (``name, power.limit``) and
``{"ok": true, "device": {...}}``.
"""

import functools
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# fp32 rates of one H100 SXM (NVIDIA data sheet): CUDA-core peak and HBM3.
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12

# Kernel-vs-plain tolerances on the card (max abs error over max |plain|).
# Both sides compute the same direct-difference cells in float32; they
# differ only in summation order and fused multiply-adds.
TOL_K1 = 1e-4
TOL_K2 = 1e-3  # sums over millions of cells of both signs

# DIA kernels (K4 and its transpose) vs plain: an output is a sum of
# D <= 5 float32 products taken in another order, with fused
# multiply-adds, so a few units in the last place of the largest term.
TOL_DIA = 1e-5
# K5 is one float32 product per slot on both sides: bit for bit.
TOL_DVALS = 0.0
# Lanczos without re-orthogonalisation amplifies rounding with depth, so
# a fixed number would either pass anything or fail on rounding alone.
# The kernel and the plain float32 version each differ from exact
# arithmetic by about the plain version's float32-vs-float64 spread, so
# they may differ from each other by twice it; the limit is 10x the
# spread measured at the same inputs, and never below 1e-6 (a few ulps,
# for the exactly representable cases where the spread is 0).
SPREAD_FACTOR = 10.0
SPREAD_FLOOR = 1e-6

# The reference's largest run: N_train = 400,000 (the JAX driver's adj400k).
N_TRAIN = 400_000
DEVICE = "cuda"
# The sparse slice: bench.py's Lanczos depth, its 128 x 128 grid and the
# 1024 x 1024 grid (the largest DIA case the JAX package was run at).
DEPTH = 90
GRIDS = (128, 1024)
# The sparse slice also runs the 1000 x 1000 grid: n = 1,000,000 is a
# multiple of neither 128 nor 1024, the JAX kernels' tiling rules, and on
# the card must still run every kernel of the path.
SLICE_GRIDS = (128, 1000, 1024)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _rel_err(a, b) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-30)


def _report(label, err, tol, failures):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {label}: max rel err {err:.3e} (tol {tol:.0e}) {status}", flush=True)
    if not err <= tol:
        failures.append(label)


def phase_build():
    from lanczos_adjoints_tpu_torch.ops import native

    start = time.perf_counter()
    reports = native.build_all()
    seconds = time.perf_counter() - start
    print(f"[build] {len(reports)} sources compiled in {seconds:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return seconds


def phase_parity(device="cuda", rows=(3001, 2777), kinds=("rbf", "matern12", "matern32"),
                 dims=(1, 8, 12, 40)):
    """K1, its autograd backward and K2 against their plain versions.

    d = 40 reaches the widest instantiation (rows padded to 64); K1 at
    m = 40 serves the right-hand sides in three chunks, the last ragged.
    """
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    print("[parity] kernels vs plain versions on the card", flush=True)
    failures = []
    rng = np.random.default_rng(0)
    n, n_cols = rows
    for kind in kinds:
        for d in dims:
            x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=device)
            y = torch.tensor(rng.standard_normal((n_cols, d)), dtype=torch.float32, device=device)
            for ard in (False, True):
                ell_np = rng.uniform(0.5, 2.0, (d,) if ard else ())
                ell = torch.tensor(ell_np, dtype=torch.float32, device=device)
                out_s = torch.tensor(1.3, dtype=torch.float32, device=device)
                xs, ys = fg.kernel_rows(x, ell, kind), fg.kernel_rows(y, ell, kind)
                tag = f"{kind} d={d} {'ard' if ard else 'scalar'}"
                for m in (1, 15, 40):
                    v = torch.tensor(rng.standard_normal((n_cols, m)), dtype=torch.float32, device=device)
                    got = fg.gram_matvec_rows(kind, xs, ys, v)
                    want = fg.gram_matvec_plain(kind, xs, ys, v)
                    torch.cuda.synchronize()
                    _report(f"K1 {tag} m={m}", _rel_err(got, want), TOL_K1, failures)
                    if m == 40:
                        continue

                    # Autograd: the Function (K1 forward, K1 + K2 backward)
                    # against autograd through the plain composition.
                    vv = v[:, 0] if m == 1 else v
                    cot = torch.tensor(rng.standard_normal((n,) + vv.shape[1:]), dtype=torch.float32, device=device)
                    grads = []
                    for fn in (fg.gram_matvec_fused(kind), lambda *a: fg.gram_matvec_reference(kind, *a)):
                        args = [vv.clone().requires_grad_(), ell.clone().requires_grad_(),
                                out_s.clone().requires_grad_()]
                        grads.append(torch.autograd.grad(torch.sum(fn(x, y, *args) * cot), args))
                    torch.cuda.synchronize()
                    for name, a, b in zip(("dv", "dell", "dout"), *grads):
                        _report(f"K1 vjp {name} {tag} m={m}", _rel_err(a, b), TOL_K2, failures)
                for m in (1, 225):
                    v = torch.tensor(rng.standard_normal((n_cols, m)), dtype=torch.float32, device=device)
                    u = torch.tensor(rng.standard_normal((n, m)), dtype=torch.float32, device=device)
                    got = fg.gram_grads_rows(kind, xs, ys, v, u)
                    want = fg.gram_grads_plain(kind, xs, ys, v, u)
                    torch.cuda.synchronize()
                    _report(f"K2 {tag} m={m}", _rel_err(got, want), TOL_K2, failures)
    if failures:
        msg = f"{len(failures)} kernel parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _plain_policy():
    """The fused policy's shape with the plain, autograd-differentiated matvec."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    def matvec(fun):
        kind, constrain = fun.fused_spec
        inputs, _noise = fun.fused_data

        def matvec_y(i, j, v, raw_ell, raw_out):
            return fg.gram_matvec_reference(
                kind, inputs[i], inputs[j], v, constrain(raw_ell), constrain(raw_out)
            )

        return matvec_y

    return matvec


def _data(n_train, seed=1):
    from lanczos_adjoints_tpu_torch.utils import uci

    X, y = uci.uci_synthetic_gp500k()
    n = n_train * 5 // 4
    (X_tr, y_tr), _ = uci.split_train_test_shuffle(seed, X[:n], y[:n], train_fraction=0.8)
    return (torch.tensor(X_tr, device=DEVICE), torch.tensor(y_tr, device=DEVICE))


def phase_oracle(n=2048):
    """Krylov MLL vs the dense Cholesky oracle; kernel vs plain gradients."""
    from lanczos_adjoints_tpu_torch.models import gp
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    print(f"[oracle] N={n}: Krylov vs Cholesky, kernels vs plain versions", flush=True)
    X, y = _data(n, seed=0)
    rng = np.random.default_rng(0)
    params = torch.tensor(
        np.concatenate([[0.0], rng.uniform(0.0, 1.0, 8), [0.5], [-1.0]]),
        dtype=torch.float32, device=DEVICE,
    )
    probes = torch.tensor(rng.choice([-1.0, 1.0], size=(16, n)), dtype=torch.float32, device=DEVICE)
    # The verify drive's tight settings: PCG atol = rtol = 1e-4, 20 Lanczos
    # steps, 16 probes.
    results = {}
    for name, policy in (("kernels", None), ("plain", _plain_policy())):
        stack = train_gp.assemble(
            n_train=n, ndim=8, num_matvecs=20, num_samples=16, rank_precon=128,
            precon_block=64, cg_tol=1e-4, cg_rtol=1e-4, cg_maxiter=100, cg_miniter=2,
            sample=lambda _key: probes, matvec=policy, device=DEVICE,
        )
        p = params.clone().requires_grad_()
        value, info = stack.mll_lanczos(p, None, X, y)
        (grad,) = torch.autograd.grad(value, [p])
        torch.cuda.synchronize()
        results[name] = (value.item(), grad, float(info["logpdf"]["solve"]["num_steps"]))

    p1, p2, p3 = gp.unflatten_params(params, 8)
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = gp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())
    likelihood, _ = gp.likelihood_pdf_p(
        gp.gram_matvec(), gp.logpdf_cholesky(), lambda _e, _n: ((lambda v, _s: v), {}),
        constrain=gp.constraint_greater_than(train_gp.NOISE_MINVAL),
    )
    exact, _ = gp.target_logml(gp.model_gp(mean, kernel), likelihood)(
        X, y, params_mean=p1, params_kernel=p2, params_likelihood=p3
    )
    exact = -exact.item() / n
    value_k, grad_k, steps = results["kernels"]
    value_p, grad_p, _ = results["plain"]
    rel = abs(value_k - exact) / abs(exact)
    print(f"  loss: Krylov {value_k:.6f} (CG steps {steps:.0f}), Cholesky {exact:.6f}, "
          f"rel diff {rel:.2e} (tol 1e-02)")
    print(f"  loss: kernels {value_k:.7f} vs plain {value_p:.7f}")
    grad_err = _rel_err(grad_k, grad_p)
    print(f"  gradient: kernels vs plain max rel err {grad_err:.2e} (tol 1e-03); "
          f"finite {bool(torch.isfinite(grad_k).all())}")
    if not (rel <= 1e-2 and grad_err <= 1e-3 and bool(torch.isfinite(grad_k).all())):
        raise RuntimeError("oracle check failed")


def phase_slice(n_train, steps):
    """Adam steps of the training step at the reference's largest configuration."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    X, y = _data(n_train)
    stack = train_gp.assemble(n_train=n_train, ndim=8, device=DEVICE)
    print(f"[slice] matern32 ARD, N_train={n_train}, d=8, 15 Lanczos x 15 probes, "
          f"PCG atol=1.0 miniter=10 maxiter=25, rank {stack.rank} (500 rounded down "
          f"to block 64), Adam lr=0.05, {steps} steps", flush=True)
    params = torch.randn(stack.num_params, generator=torch.Generator().manual_seed(1))
    opt = train_gp.AdamIfFinite(params.to(DEVICE).requires_grad_(), lr=0.05)
    key = torch.Generator(device=DEVICE).manual_seed(1)
    gram = (native.KERNELS["gram_matvec"], native.KERNELS["gram_grads"])
    native.reset_launches()
    per_step, times = [], []
    for step in range(steps):
        before = [k.launches for k in gram]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, info, grad, applied = train_gp.train_step(stack, opt, key, X, y)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = [k.launches - b for k, b in zip(gram, before)]
        per_step.append(counts)
        times.append(seconds)
        finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(value))
        print(f"  step {step}: loss {value.item():.6f} cg_steps "
              f"{float(info['logpdf']['solve']['num_steps']):.0f} grad finite {finite} "
              f"applied {applied} wall {seconds:.3f} s launches "
              f"K1 {counts[0]} K2 {counts[1]}", flush=True)
        if not finite or min(counts) == 0:
            raise RuntimeError(f"slice step {step} failed (finite={finite}, launches={counts})")
    totals = [k.launches for k in gram]
    print(f"  launches over {steps} steps: K1 {totals[0]}, K2 {totals[1]}; "
          f"step wall times {[round(t, 3) for t in times]}")
    return {"launches": totals, "per_step": per_step, "step_s": times}


def _cell_ops(kernel, m, d=8):
    """fp32 operations per cell: distance 3d, Matern-3/2 value 5 (K1) or
    value and derivative plus the weighted sums 5d + 9 (K2), contraction 2m."""
    return 2 * m + (3 * d + 5 if kernel == "K1" else 5 * d + 9)


def phase_timing(n, slice_counts):
    """Gram kernel and plain times at the GP slice's shapes; their kernels-line entries."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    print(f"[timing] N=M={n}, matern32, d=8 (CUDA events)", flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    X = torch.randn((n, 8), generator=g, device=DEVICE)
    ell = torch.full((8,), 0.9, device=DEVICE)
    xs = fg.kernel_rows(X, ell, "matern32")
    kinds = {"K1": [1, 15], "K2": [1, 225]}
    shapes = {}
    for kernel, ms_ in kinds.items():
        for m in ms_:
            v = torch.randn((n, m), generator=g, device=DEVICE)
            u = torch.randn((n, m), generator=g, device=DEVICE)
            if kernel == "K1":
                run = lambda: fg.gram_matvec_rows("matern32", xs, xs, v)  # noqa: E731
                plain = lambda: fg.gram_matvec_plain("matern32", xs, xs, v)  # noqa: E731
                nbytes = 4 * (2 * n * 8 + 2 * n * m)
            else:
                run = lambda: fg.gram_grads_rows("matern32", xs, xs, v, u)  # noqa: E731
                plain = lambda: fg.gram_grads_plain("matern32", xs, xs, v, u)  # noqa: E731
                nbytes = 4 * (2 * n * 8 + 2 * n * m + (n // 64 + 1) * 9)
            got = run()  # warm-up, and the value held against the plain one
            ms = events_ms(run, 2)
            # One timed plain run: it loops over thousands of row chunks,
            # so its first chunk's warm-up is lost in the total.
            want = []
            plain_ms = events_ms(lambda: want.append(plain()), 1)
            want = want[0]
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ops = n * n * _cell_ops(kernel, m)
            bound_ms = 1e3 * max(ops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES)
            by = "operations" if ops / PEAK_FLOPS_FP32 >= nbytes / PEAK_BYTES else "bytes"
            shapes[(kernel, m)] = {
                "m": m, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "max_abs_err": err, "max_rel_err": rel,
            }
            print(f"  {kernel} m={m}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({by}), max abs err {err:.3e} (rel {rel:.2e})", flush=True)
            tol = TOL_K1 if kernel == "K1" else TOL_K2
            if not rel <= tol:
                raise RuntimeError(f"{kernel} m={m} disagrees with its plain version at N={n}")
            del v, u, got, want
    entries = []
    meta = {
        "K1": ("gram_matvec", "lanczos_adjoints_tpu_torch/csrc/gram_matvec.cu",
               "lanczos_adjoints_tpu/ops/pallas_gram.py:188", 15),
        "K2": ("gram_grads", "lanczos_adjoints_tpu_torch/csrc/gram_grads.cu",
               "lanczos_adjoints_tpu/ops/pallas_gram.py:214", 225),
    }
    for idx, (kernel, (name, source, replaces, main_m)) in enumerate(meta.items()):
        main = shapes[(kernel, main_m)]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": slice_counts["launches"][idx],
            "launches_per_step": [c[idx] for c in slice_counts["per_step"]],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "n": n, "m": main_m,
            "by_m": [shapes[(kernel, m)] for m in kinds[kernel]],
        })
    return entries


# ---------------------------------------------------------------------------
# The sparse slice: DIA matvec (K4, K5) and fused Lanczos (K6, K7)
# ---------------------------------------------------------------------------


def _dia(offsets, n):
    from lanczos_adjoints_tpu_torch.ops import sparse

    empty = np.zeros(0, dtype=np.int64)
    return sparse.DIAData(offsets=tuple(offsets), shape=(n, n), nnz=0,
                          diag_of_entry=empty, pos_of_entry=empty)


def _laplacian(m, device=None):
    """The m x m grid Laplacian: (DIAData, packed float32 values on the card)."""
    from lanczos_adjoints_tpu_torch.ops import sparse
    from lanczos_adjoints_tpu_torch.utils import test_util

    mat = test_util.laplacian_2d(m)
    dia = sparse.dia_pack(mat)
    return mat, dia, sparse.dia_values(dia, mat.data, device=device or DEVICE)


def _tensor(rng, shape, device=None):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device or DEVICE)


def _spread_tol(spread):
    return max(SPREAD_FACTOR * spread, SPREAD_FLOOR)


def _report_spread(label, err, spread, failures):
    tol = _spread_tol(spread)
    status = "ok" if err <= tol else "FAIL"
    print(f"  {label}: max rel err {err:.3e}; plain f32 vs f64 {spread:.3e}; "
          f"tol {tol:.3e} {status}", flush=True)
    if not err <= tol:
        failures.append(label)


def phase_parity_dia(sizes=(16_384, 1_000_000, 1 << 20)):
    """K4, K4 on the transpose (autograd backward) and K5 against their plain versions."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd

    print("[parity-dia] DIA kernels vs plain versions on the card", flush=True)
    failures = []
    rng = np.random.default_rng(3)
    for n in sizes:
        m = int(round(n ** 0.5))
        _mat, lap, lap_vals = _laplacian(m)
        cases = [
            ("(-1,0,1) random", (-1, 0, 1), None),
            ("(-130,-7,0,7,130) random", (-130, -7, 0, 7, 130), None),
            (f"laplacian {lap.offsets} packed", lap.offsets, lap_vals),
        ]
        for name, offsets, vals in cases:
            if vals is None:  # non-zero values in every slot, the wrapped ones too
                vals = _tensor(rng, (len(offsets), n))
            x, u = _tensor(rng, n), _tensor(rng, n)
            tag = f"n={n} {name}"
            got = fd.dia_matvec_rows(offsets, x, vals)
            want = fd.dia_matvec_plain(offsets, x, vals)
            torch.cuda.synchronize()
            _report(f"K4 {tag}", _rel_err(got, want), TOL_DIA, failures)
            got = fd.dia_dvals_rows(offsets, x, u)
            want = fd.dia_dvals_plain(offsets, x, u)
            torch.cuda.synchronize()
            _report(f"K5 {tag}", _rel_err(got, want), TOL_DVALS, failures)

            # The Function's backward (K4 on the transpose, K5) against
            # autograd through the plain roll form.
            grads = []
            for fn in (fd.dia_matvec_fused(_dia(offsets, n), check_tiling=False),
                       lambda v, p: fd.dia_matvec_plain(offsets, v, p)):
                args = [x.clone().requires_grad_(), vals.clone().requires_grad_()]
                grads.append(torch.autograd.grad(fn(*args), args, u))
            torch.cuda.synchronize()
            _report(f"K4^T vjp dv {tag}", _rel_err(grads[0][0], grads[1][0]), TOL_DIA, failures)
            _report(f"K5 vjp dvals {tag}", _rel_err(grads[0][1], grads[1][1]), TOL_DVALS, failures)
    if failures:
        msg = f"{len(failures)} DIA parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _cotangent(rng, depth, n):
    """A seeded random cotangent of every output of the decomposition."""
    return (_tensor(rng, (depth, n)), _tensor(rng, depth), _tensor(rng, depth - 1),
            _tensor(rng, n), _tensor(rng, ()))


def _leaves(out):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _lanczos_cases():
    """(name, dia, vals, v0, depth) for the Lanczos parity phase."""
    from lanczos_adjoints_tpu_torch.ops import sparse

    rng = np.random.default_rng(4)
    # 37 x 128, a multiple of 128 that is not one of 1024; and 4,739, a
    # multiple of neither (the kernels take any n).
    for n in (4_736, 4_739):
        idx = np.arange(n)
        mat = sparse.csr_from_coo(  # the tridiagonal 2.5 / -1 of the JAX kernel's tests
            np.concatenate([idx, idx[:-1], idx[1:]]), np.concatenate([idx, idx[1:], idx[:-1]]),
            np.concatenate([2.5 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)]), shape=(n, n),
        )
        dia = sparse.dia_pack(mat)
        vals = sparse.dia_values(dia, mat.data, device=DEVICE)
        yield f"tridiagonal n={n} K=12", dia, vals, _tensor(rng, n), 12
    for m in GRIDS:
        _mat, dia, vals = _laplacian(m)
        yield f"laplacian n={m * m} K={DEPTH}", dia, vals, _tensor(rng, m * m), DEPTH
    # An exhausted Krylov space: A = 1.5 I and a one-hot v0 give an exactly
    # zero residual at step 0, so every later beta and basis vector is
    # the guarded zero.
    n = 16_384
    dia = _dia((0,), n)
    v0 = torch.zeros(n, device=DEVICE)
    v0[7] = 1.0
    yield "exhausted (1.5 I, one-hot v0) n=16384 K=12", dia, torch.full((1, n), 1.5, device=DEVICE), v0, 12


def phase_parity_lanczos():
    """K6 and K7 against their plain versions, tolerances from the f32-vs-f64 spread."""
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl

    print("[parity-lanczos] fused Lanczos kernels vs plain versions on the card", flush=True)
    failures = []
    rng = np.random.default_rng(5)
    for name, dia, vals, v0, depth in _lanczos_cases():
        offsets, n = dia.offsets, dia.shape[0]
        kernel = fl.lanczos_forward_rows(offsets, vals, v0, depth)
        plain = fl.lanczos_forward_plain(offsets, vals, v0, depth)
        exact = fl.lanczos_forward_plain(offsets, vals.double(), v0.double(), depth)
        torch.cuda.synchronize()
        for label, pick in (("alphas", lambda r: r[1]), ("betas", lambda r: r[2]),
                            ("basis", lambda r: r[0][:-1]), ("residual", lambda r: r[0][-1])):
            _report_spread(f"K6 {label} {name} kernel vs plain", _rel_err(pick(kernel), pick(plain)),
                           _rel_err(pick(plain), pick(exact)), failures)
        if float(plain[2][1:].abs().max()) == 0.0:
            ok = float(kernel[2].abs().max()) == 0.0 and float(kernel[0][1:].abs().max()) == 0.0
            print(f"  K6 guard {name}: betas and basis rows 1.. exactly zero: {ok}")
            if not ok:
                failures.append(f"K6 guard {name}")

        # The adjoint on the plain forward's decomposition, so that it is
        # compared on identical inputs; float64 on the same values upcast.
        cot = _cotangent(rng, depth, n)
        xs, alphas, betas = plain
        dxs = torch.cat([cot[0], cot[3][None]])
        dbetas = torch.cat([cot[2], cot[4][None]])
        inv_norm = 1.0 / torch.linalg.vector_norm(v0)
        args = (xs, alphas, betas, inv_norm, dxs, cot[1], dbetas)
        got = fl.lanczos_adjoint_rows(offsets, vals, *args)
        want = fl.lanczos_adjoint_plain(offsets, vals, *args)
        exact = fl.lanczos_adjoint_plain(offsets, vals.double(), *(a.double() for a in args))
        torch.cuda.synchronize()
        for label, i in (("dv", 0), ("dvals", 1)):
            _report_spread(f"K7 {label} {name} kernel vs plain", _rel_err(got[i], want[i]),
                           _rel_err(want[i], exact[i]), failures)

        # The autograd Function (K6 forward, K7 backward) against the two
        # wrappers on the same inputs: deterministic kernels, so bit for
        # bit. Both stream values call the same code; one pass suffices.
        estimate = fl.tridiag_dia_fused(dia, depth, stream=True, check_tiling=False)
        inputs = [v0.clone().requires_grad_(), vals.clone().requires_grad_()]
        outputs = _leaves(estimate(*inputs))
        grads = torch.autograd.grad(outputs, inputs, cot)
        xs_k, alphas_k, betas_k = kernel
        direct = fl.lanczos_adjoint_rows(offsets, vals, xs_k, alphas_k, betas_k, *args[3:])
        torch.cuda.synchronize()
        same_fwd = torch.equal(outputs[0], xs_k[:-1]) and torch.equal(outputs[1], alphas_k)
        same_bwd = all(torch.equal(a, b) for a, b in zip(grads, direct))
        print(f"  Function {name}: forward == K6 wrapper bitwise {same_fwd}, "
              f"backward == K7 wrapper bitwise {same_bwd}", flush=True)
        if not (same_fwd and same_bwd):
            failures.append(f"Function {name}")
        del kernel, plain, exact, got, want, cot, args, outputs, grads, direct
    if failures:
        msg = f"{len(failures)} Lanczos parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _one_vjp(estimate, v0, vals):
    """One forward + VJP with the all-ones cotangent, as bench.py does."""
    inputs = [v0.clone().requires_grad_(), vals.clone().requires_grad_()]
    outputs = _leaves(estimate(*inputs))
    return torch.autograd.grad(outputs, inputs, [torch.ones_like(o) for o in outputs])


DIA_KERNELS = ("dia_matvec", "dia_matvec_transposed", "dia_dvals",
               "lanczos_dia_forward", "lanczos_dia_adjoint")


def phase_slice_sparse(m):
    """bench.py's flow through the port's public entry points at an m x m grid."""
    from lanczos_adjoints_tpu_torch.krylov import lanczos
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl
    from lanczos_adjoints_tpu_torch.ops import native, sparse
    from lanczos_adjoints_tpu_torch.utils import test_util
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    mat = test_util.laplacian_2d(m)
    matvec, _values, info = sparse.sparse_operator(mat, with_info=True, device=DEVICE)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device=DEVICE)
    v0 = torch.ones(mat.shape[0], device=DEVICE)
    print(f"[slice-sparse] {m}x{m} Laplacian: n={mat.shape[0]} nnz={mat.nnz} "
          f"format={info.format} fill={info.fill_efficiency:.4f} offsets={dia.offsets} "
          f"K={DEPTH}, one VJP with the all-ones cotangent", flush=True)
    log_generic, log_default = [], []
    routes = {
        # K6/K7 take any n: the JAX kernel's n % 128 rule is not checked.
        "fused": fl.tridiag_dia_fused(dia, DEPTH, check_tiling=False),
        "generic": lanczos.tridiag(matvec, DEPTH, reortho="none", allow_fused=False,
                                   dispatch_log=log_generic),
        "default": lanczos.tridiag(matvec, DEPTH, reortho="none", dispatch_log=log_default),
    }
    expected = {
        "fused": {"lanczos_dia_forward": 1, "lanczos_dia_adjoint": 1},
        "generic": {"dia_matvec": 2 * DEPTH, "dia_dvals": DEPTH},
        "default": {"lanczos_dia_forward": 1, "lanczos_dia_adjoint": 1},
    }
    failures, grads, launches = [], {}, {}
    for route, estimate in routes.items():
        native.reset_launches()
        grads[route] = _one_vjp(estimate, v0, vals)
        torch.cuda.synchronize()
        counts = native.launch_counts()
        launches[route] = {k: counts[k] for k in DIA_KERNELS}
        want = {k: expected[route].get(k, 0) for k in DIA_KERNELS}
        dv = grads[route][0]
        finite = bool(torch.isfinite(dv).all()) and bool(torch.isfinite(grads[route][1]).all())
        nonzero = float(dv.abs().max()) > 0.0
        ok = launches[route] == want and finite and nonzero
        print(f"  {route}: launches per VJP {launches[route]} (predicted {want}); "
              f"dv finite {finite} non-zero {nonzero} max|dv| {float(dv.abs().max()):.6e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(route)
    print(f"  dispatch log: generic {log_generic}, default {log_default}")
    if log_generic != ["tridiag:generic"] or log_default != ["tridiag:dia_fused"]:
        failures.append("dispatch log")

    # Fused vs generic, against the spread of the plain version (float32
    # vs float64) on the same inputs and cotangent.
    offsets = dia.offsets
    spreads = []
    for dtype in (torch.float32, torch.float64):
        xs, alphas, betas = fl.lanczos_forward_plain(offsets, vals.to(dtype), v0.to(dtype), DEPTH)
        ones = torch.ones_like(xs)
        spreads.append(fl.lanczos_adjoint_plain(
            offsets, vals.to(dtype), xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0.to(dtype)),
            ones, torch.ones_like(alphas), torch.ones_like(betas)))
    for label, i in (("dv", 0), ("dvals", 1)):
        _report_spread(f"fused vs generic {label} m={m}", _rel_err(grads["fused"][i], grads["generic"][i]),
                       _rel_err(spreads[0][i], spreads[1][i]), failures)
    same = torch.equal(grads["fused"][0], grads["default"][0])
    print(f"  default dispatch == fused bitwise: {same}")
    if not same:
        failures.append("default vs fused")
    if failures:
        raise RuntimeError(f"sparse slice m={m} failed: {failures}")

    times, profiles = {}, {}
    for route in ("fused", "generic"):
        times[route] = events_ms(lambda r=route: _one_vjp(routes[r], v0, vals), 5)
        print(f"  VJP wall time {route}: {times[route]:.3f} ms (CUDA events, mean of 5 after warm-up)",
              flush=True)
    for route in ("fused", "generic"):
        profiles[route] = _print_profile(route, lambda r=route: _one_vjp(routes[r], v0, vals))
    return {"launches": launches, "vjp_ms": times, "profile": profiles,
            "n": mat.shape[0], "nnz": mat.nnz}


def _short(name):
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


def _print_profile(label, fn):
    """One run of ``fn`` under the profiler: device busy time, idle share, top kernels."""
    from lanczos_adjoints_tpu_torch.utils.timing import device_profile

    wall_ms, kernels = device_profile(fn)
    if not kernels:
        print(f"  profile {label}: the profiler saw no device activity; device time not measured")
        return None
    busy = sum(t for _count, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    print(f"  profile {label} (one run under torch.profiler): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1.0 - busy / wall_ms:.3f}; top: "
          + "; ".join(f"{_short(name)} x{c} {t:.3f} ms" for name, (c, t) in top), flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "top": [[_short(name), c, t] for name, (c, t) in top], "kernels": kernels}


def _per_launch_ms(kernels, symbol):
    """Mean device ms per launch of the kernels whose name holds ``symbol``, or None."""
    mine = [ct for name, ct in kernels.items() if symbol in name]
    return sum(t for _c, t in mine) / sum(c for c, _t in mine) if mine else None


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS_FP32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# Distinct operand sets that a timed K4/K5 call cycles through: 8 x 29 MB
# at n = 1,048,576, so that about 200 MB pass through the 50 MB L2
# between two uses of one set and every launch reads its operands from
# device memory, as in the main path (where each step brings a new x).
ROTATE_SETS = 8


def _rotating(fns):
    """One callable that runs ``fns`` in turn, the next one at each call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _record(rows, failures, key, symbol, runs, plains, nbytes, ops, reps, plain_reps, *,
            tols=None, exact=None, library=None):
    """Time ``runs`` (and ``plains``, ``library``) in rotation over their
    operand sets into ``rows[key]``; hold set 0's kernel result to its
    plain one, output by output, within ``tols`` or, given the float64
    plain result ``exact``, within the spread-derived limit (a miss
    appends ``key`` to ``failures``)."""
    from lanczos_adjoints_tpu_torch.utils.timing import device_profile, events_ms

    got = runs[0]()  # warm-up, and the value held against the plain one
    want = plains[0]()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if exact is not None:
        tols = [_spread_tol(_rel_err(w, e)) for w, e in zip(want, exact())]
    torch.cuda.synchronize()
    run, plain = _rotating(runs), _rotating(plains)
    ms_events = events_ms(run, reps)
    plain_ms = events_ms(plain, plain_reps)
    # The kernel's own device time per launch, without the host's
    # share of back-to-back launches, where the profiler sees it.
    _wall, kernels = device_profile(lambda: [run() for _ in range(reps)])
    ms_device = _per_launch_ms(kernels, symbol)
    ms = ms_device if ms_device is not None else ms_events
    library_ms = library_events = None
    if library is not None:
        lib = _rotating(library)
        lib()
        library_events = events_ms(lib, reps)
        # Device time of the whole call (all its kernels), as for K4.
        _wall, lib_kernels = device_profile(lambda: [lib() for _ in range(reps)])
        busy = sum(t for _c, t in lib_kernels.values())
        library_ms = busy / reps if lib_kernels else library_events
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = [_rel_err(a, b) for a, b in zip(got, want)]
    ok = all(r <= t for r, t in zip(rel, tols))
    if not ok:
        failures.append(key)
    bound_ms, by = _bound(nbytes, ops)
    rows[key] = {"ms": ms, "ms_events": ms_events, "ms_device": ms_device,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                 "library_ms": library_ms, "library_ms_events": library_events,
                 "max_abs_err": abs_err, "rel_errs": rel, "rel_limits": list(tols),
                 "operand_sets": len(runs)}
    lib = (f", library {library_ms:.4f} ms on the device ({library_events:.4f} ms by events)"
           if library is not None else "")
    dev = f"{ms_device:.4f} ms" if ms_device is not None else "not measured"
    print(f"  {key}: kernel {dev} on the device ({ms_events:.4f} ms by events back to back, "
          f"{len(runs)} operand sets), plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms "
          f"({by}); max abs err {abs_err:.3e}, rel errs "
          + ", ".join(f"{r:.2e} (limit {t:.2e})" for r, t in zip(rel, tols))
          + (" ok" if ok else " FAIL"), flush=True)


def phase_timing_sparse(slices):
    """Per-launch times of K4-K7 at the sparse slice's shapes; their kernels-line entries."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl

    print("[timing-sparse] DIA kernels at the slice's shapes (profiler and CUDA events)", flush=True)
    rng = np.random.default_rng(6)
    rows, failures = {}, []
    record = functools.partial(_record, rows, failures)

    m = GRIDS[-1]
    mat, dia, vals = _laplacian(m)
    n, offsets, num_diags = mat.shape[0], dia.offsets, len(dia.offsets)
    sets = [(_tensor(rng, n), vals.clone(), _tensor(rng, n)) for _ in range(ROTATE_SETS)]
    # Yardstick only (the port never calls it): cuSPARSE through one
    # PyTorch call on the same Laplacian; its wrapped DIA slots are zero,
    # so it computes the same product.
    csr = torch.sparse_csr_tensor(
        torch.tensor(mat.indptr, device=DEVICE), torch.tensor(mat.indices, device=DEVICE),
        torch.tensor(mat.data, dtype=torch.float32, device=DEVICE), size=mat.shape,
        check_invariants=True,
    )
    x0 = sets[0][0]
    lib_err = _rel_err(csr @ x0, fd.dia_matvec_rows(offsets, x0, vals))
    print(f"  library CSR product vs K4: max rel err {lib_err:.3e}")
    record(("K4", n), "dia_matvec_kernel",
           [lambda s=s: fd.dia_matvec_rows(offsets, s[0], s[1]) for s in sets],
           [lambda s=s: fd.dia_matvec_plain(offsets, s[0], s[1]) for s in sets],
           4 * (num_diags + 2) * n, 2 * num_diags * n, 48, 8, tols=(TOL_DIA,),
           library=[lambda s=s: csr @ s[0] for s in sets])
    record(("K5", n), "dia_dvals_kernel",
           [lambda s=s: fd.dia_dvals_rows(offsets, s[0], s[2]) for s in sets],
           [lambda s=s: fd.dia_dvals_plain(offsets, s[0], s[2]) for s in sets],
           4 * (num_diags + 2) * n, num_diags * n, 48, 8, tols=(TOL_DVALS,))
    del sets, csr
    for m in GRIDS:
        _mat, dia, vals = _laplacian(m)
        n, offsets = dia.shape[0], dia.offsets
        v0 = torch.ones(n, device=DEVICE)
        xs, alphas, betas = fl.lanczos_forward_plain(offsets, vals, v0, DEPTH)
        cot = _cotangent(rng, DEPTH, n)
        args = (xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0),
                torch.cat([cot[0], cot[3][None]]), cot[1], torch.cat([cot[2], cot[4][None]]))
        reps = 5 if n > 100_000 else 20
        # One operand set: at n = 1M the basis alone is 8x the L2; at
        # n = 16,384 everything fits in L2 on the main path as well.
        # Operations per row and step: the matvec 2D, the dots and
        # updates 9 (K6); the matvec and dvals 4D, dots and updates 16 (K7).
        record(("K6", n), "lanczos_forward_kernel",
               [lambda: fl.lanczos_forward_rows(offsets, vals, v0, DEPTH)],
               [lambda: fl.lanczos_forward_plain(offsets, vals, v0, DEPTH)],
               4 * (num_diags + 1 + DEPTH + 1) * n, DEPTH * (2 * num_diags + 9) * n, reps, 2,
               exact=lambda: fl.lanczos_forward_plain(offsets, vals.double(), v0.double(), DEPTH))
        record(("K7", n), "lanczos_adjoint_kernel",
               [lambda: fl.lanczos_adjoint_rows(offsets, vals, *args)],
               [lambda: fl.lanczos_adjoint_plain(offsets, vals, *args)],
               4 * (2 * (DEPTH + 1) + 2 * num_diags + 1) * n, DEPTH * (4 * num_diags + 16) * n,
               reps, 2,
               exact=lambda: fl.lanczos_adjoint_plain(offsets, vals.double(),
                                                      *(a.double() for a in args)))
        del xs, cot, args
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions in [timing-sparse]: {failures}")

    big = GRIDS[-1] ** 2
    full = slices[GRIDS[-1]]
    meta = (
        ("K4", "dia_matvec", "dia_matvec_kernel", "lanczos_adjoints_tpu_torch/csrc/dia.cu",
         "lanczos_adjoints_tpu/ops/pallas_dia.py:84", "generic"),
        ("K5", "dia_dvals", "dia_dvals_kernel", "lanczos_adjoints_tpu_torch/csrc/dia.cu",
         "lanczos_adjoints_tpu/ops/pallas_dia.py:94", "generic"),
        ("K6", "lanczos_dia_forward", "lanczos_forward_kernel",
         "lanczos_adjoints_tpu_torch/csrc/lanczos_dia.cu",
         "lanczos_adjoints_tpu/ops/pallas_lanczos.py:59", "fused"),
        ("K7", "lanczos_dia_adjoint", "lanczos_adjoint_kernel",
         "lanczos_adjoints_tpu_torch/csrc/lanczos_dia.cu",
         "lanczos_adjoints_tpu/ops/pallas_lanczos.py:93", "fused"),
    )
    entries = []
    for kernel, name, symbol, source, replaces, route in meta:
        main = rows[(kernel, big)]
        profile = full["profile"][route]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": full["launches"][route][name], "launch_route": route, **main, "n": big,
            # Device ms per launch inside the profiled VJP of the main path.
            "ms_in_vjp": _per_launch_ms(profile["kernels"], symbol) if profile else None,
            "launches_per_vjp": {f"m={g}": s["launches"][route][name] for g, s in slices.items()},
        }
        if kernel in ("K6", "K7"):
            entry["by_n"] = [dict(rows[(kernel, g * g)], n=g * g) for g in GRIDS]
            entry["also_replaces"] = ("lanczos_adjoints_tpu/ops/pallas_lanczos.py:280"
                                      if kernel == "K6" else
                                      "lanczos_adjoints_tpu/ops/pallas_lanczos.py:322")
        if kernel == "K4":
            entry["launches_transposed"] = full["launches"][route]["dia_matvec_transposed"]
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The Arnoldi slice: the fused Arnoldi forward (K9), per-probe SLQ, the PDE step
# ---------------------------------------------------------------------------

# (n, K, reortho) of [parity-arnoldi]: the tridiagonal operator at 37 x 128
# rows and at 4,739 (a multiple of neither 128 nor 1024), the 128 x 128
# Laplacian at the benchmark's K = 90 and its deepest K = 250, and the
# 1000 x 1000 Laplacian (n = 1,000,000).
ARNOLDI_PARITY = ((4_736, 12, "none"), (4_736, 12, "full"), (4_739, 12, "full"),
                  (16_384, 90, "none"), (16_384, 90, "full"), (16_384, 250, "full"),
                  (1_000_000, 90, "full"))
# (grid m, entry point, K, reortho) of [slice-arnoldi]: the Arnoldi VJP of the
# reference's figure (K = 90, no re-orthogonalisation) and with it, the
# re-orthogonalised Lanczos over the benchmark's depths, and n = 1,000,000.
ARNOLDI_SLICE = ((128, "hessenberg", 90, "none"), (128, "hessenberg", 90, "full"),
                 (128, "tridiag", 10, "full"), (128, "tridiag", 90, "full"),
                 (128, "tridiag", 250, "full"), (1000, "hessenberg", 90, "full"))
# Which [slice-arnoldi] run is the main path of the kernels line.
ARNOLDI_MAIN = (1000, "hessenberg", 90, "full")
ARNOLDI_KERNELS = ("arnoldi_dia_forward", "dia_matvec", "dia_matvec_transposed", "dia_dvals")
SLQ_DEPTH, SLQ_PROBES = 90, 10
PDE_GRID, PDE_STEPS = 128, 3


def _tridiagonal(n):
    """The tridiagonal 2.5 / -1 operator of the JAX fused-kernel tests."""
    from lanczos_adjoints_tpu_torch.ops import sparse

    idx = np.arange(n)
    mat = sparse.csr_from_coo(
        np.concatenate([idx, idx[:-1], idx[1:]]), np.concatenate([idx, idx[1:], idx[:-1]]),
        np.concatenate([2.5 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)]), shape=(n, n),
    )
    dia = sparse.dia_pack(mat)
    return dia, sparse.dia_values(dia, mat.data, device=DEVICE)


def _arnoldi_cases():
    """(name, dia, vals, v0, depth, reortho, exact) for [parity-arnoldi]."""
    rng = np.random.default_rng(7)
    for n, depth, reortho in ARNOLDI_PARITY:
        if n in (4_736, 4_739):
            dia, vals = _tridiagonal(n)
            kind = "tridiagonal"
        else:
            _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
            kind = "laplacian"
        yield f"{kind} n={n} K={depth} {reortho}", dia, vals, _tensor(rng, n), depth, reortho, False
    # An exhausted Krylov space: A = 1.5 I and a one-hot v0 give an exactly
    # zero residual at step 0; every later column, H entry and the
    # residual are the guarded zeros, on both sides.
    n = 16_384
    v0 = torch.zeros(n, device=DEVICE)
    v0[7] = 1.0
    for reortho in ("none", "full"):
        yield (f"exhausted (1.5 I, one-hot v0) n={n} K=12 {reortho}", _dia((0,), n),
               torch.full((1, n), 1.5, device=DEVICE), v0, 12, reortho, True)


def _plain_dia_vjp(offsets, vals):
    """The DIA adjoint step's two products by the kernels' plain versions."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd

    neg, vals_t = fd.transposed(offsets, vals)
    return lambda q, lam: (fd.dia_matvec_plain(neg, lam, vals_t), [fd.dia_dvals_plain(offsets, q, lam)])


def _plain_arnoldi_vjp(offsets, vals, v0, depth, reortho, cot):
    """Plain K9 and the closed-form adjoint over the plain DIA products: ``(dv, dvals)``."""
    from lanczos_adjoints_tpu_torch.krylov import arnoldi
    from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa

    q, h, res, inv_norm = fa.hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)
    dQ, dH, dres, dinv = (c.to(vals.dtype) for c in cot)
    dv, (dvals,) = arnoldi._adjoint(
        _plain_dia_vjp(offsets, vals), Q=q.T, H=h, res=res, inv_norm=inv_norm, dQ=dQ, dH=dH,
        dres=dres, dinv_norm=dinv, reortho=reortho)
    return dv, dvals


def phase_parity_arnoldi():
    """K9 against its plain version (Q, H, res, 1/|v0|), and the Function's
    gradients (K9 forward, adjoint over the transposed K4 and K5) against the
    plain forward and adjoint, with tolerances from the f32-vs-f64 spread."""
    from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa

    print("[parity-arnoldi] fused Arnoldi kernel vs plain version on the card", flush=True)
    failures = []
    rng = np.random.default_rng(8)
    for name, dia, vals, v0, depth, reortho, exhausted in _arnoldi_cases():
        offsets, n = dia.offsets, dia.shape[0]
        kernel = fa.hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)
        plain = fa.hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)
        torch.cuda.synchronize()
        if exhausted:
            same = all(torch.equal(a, b) for a, b in zip(kernel, plain))
            zeros = float(kernel[1].abs().sum()) == 1.5 and float(kernel[0][1:].abs().max()) == 0.0
            print(f"  K9 {name}: kernel == plain exactly {same}; H = 1.5 e1 e1^T and basis rows "
                  f"1.. zero {zeros}", flush=True)
            if not (same and zeros):
                failures.append(f"K9 {name}")
        else:
            exact = fa.hessenberg_dia_forward_plain(offsets, vals.double(), v0.double(), depth, reortho)
            for label, i in (("Q", 0), ("H", 1), ("res", 2), ("1/|v0|", 3)):
                _report_spread(f"K9 {label} {name} kernel vs plain", _rel_err(kernel[i], plain[i]),
                               _rel_err(plain[i], exact[i]), failures)
            del exact
        del kernel

        cot = (_tensor(rng, (n, depth)), _tensor(rng, (depth, depth)), _tensor(rng, n), _tensor(rng, ()))
        estimate = fa.hessenberg_dia_fused(dia, depth, reortho=reortho, check_tiling=False)
        inputs = [v0.clone().requires_grad_(), vals.clone().requires_grad_()]
        grads = torch.autograd.grad(estimate(*inputs), inputs, cot)
        want = _plain_arnoldi_vjp(offsets, vals, v0, depth, reortho, cot)
        exact = _plain_arnoldi_vjp(offsets, vals.double(), v0.double(), depth, reortho, cot)
        torch.cuda.synchronize()
        for label, i in (("dv", 0), ("dvals", 1)):
            _report_spread(f"K9 Function {label} {name} vs plain", _rel_err(grads[i], want[i]),
                           _rel_err(want[i], exact[i]), failures)
        del plain, cot, grads, want, exact
    if failures:
        msg = f"{len(failures)} Arnoldi parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _arnoldi_entry(kind, matvec, depth, reortho, **kwargs):
    from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos

    if kind == "hessenberg":
        return arnoldi.hessenberg(matvec, depth, reortho=reortho, **kwargs)
    return lanczos.tridiag(matvec, depth, reortho=reortho, **kwargs)


def _launches(names):
    from lanczos_adjoints_tpu_torch.ops import native

    counts = native.launch_counts()
    return {k: counts[k] for k in names}


def phase_slice_arnoldi(m, kind, depth, reortho):
    """The Arnoldi VJP through the port's entry points at an m x m grid:
    ``sparse_operator`` -> ``hessenberg`` or ``tridiag(reortho="full")``."""
    from lanczos_adjoints_tpu_torch.ops import native, sparse
    from lanczos_adjoints_tpu_torch.utils import test_util
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    mat = test_util.laplacian_2d(m)
    matvec, vals = sparse.sparse_operator(mat, device=DEVICE)
    dia = sparse.dia_pack(mat)
    n = mat.shape[0]
    v0 = torch.ones(n, device=DEVICE)
    tag = f"{kind} K={depth} reortho={reortho} m={m}"
    print(f"[slice-arnoldi] {m}x{m} Laplacian (n={n}): {kind}, K={depth}, reortho={reortho}, "
          f"one VJP with the all-ones cotangent", flush=True)
    log_fused, log_generic = [], []
    routes = {
        "fused": _arnoldi_entry(kind, matvec, depth, reortho, dispatch_log=log_fused),
        "generic": _arnoldi_entry(kind, matvec, depth, reortho, allow_fused=False,
                                  dispatch_log=log_generic),
    }
    expected = {
        "fused": {"arnoldi_dia_forward": 1, "dia_matvec_transposed": depth, "dia_dvals": depth},
        # The generic adjoint differentiates the K4 Function at each step:
        # its forward K4, then the transposed K4 and K5.
        "generic": {"dia_matvec": 2 * depth, "dia_matvec_transposed": depth, "dia_dvals": depth},
    }
    failures, grads, launches = [], {}, {}
    for route, estimate in routes.items():
        native.reset_launches()
        grads[route] = _one_vjp(estimate, v0, vals)
        torch.cuda.synchronize()
        launches[route] = _launches(ARNOLDI_KERNELS)
        want = {k: expected[route].get(k, 0) for k in ARNOLDI_KERNELS}
        finite = all(bool(torch.isfinite(g).all()) for g in grads[route])
        ok = launches[route] == want and finite and float(grads[route][0].abs().max()) > 0.0
        print(f"  {route}: launches per VJP {launches[route]} (predicted {want}); grads finite "
              f"{finite} max|dv| {float(grads[route][0].abs().max()):.6e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(route)
    prefix = ["tridiag:arnoldi_full"] if kind == "tridiag" else []
    print(f"  dispatch log: fused {log_fused}, generic {log_generic}")
    if log_fused != prefix + ["hessenberg:dia_fused"] or log_generic != prefix + ["hessenberg:generic"]:
        failures.append("dispatch log")

    # The spread: the generic route over the plain roll matvec, float32 vs float64.
    roll = sparse.dia_matvec_fn(dia)
    plain = [_one_vjp(_arnoldi_entry(kind, roll, depth, reortho, allow_fused=False),
                      v0.to(dtype), vals.to(dtype)) for dtype in (torch.float32, torch.float64)]
    for label, i in (("dv", 0), ("dvals", 1)):
        _report_spread(f"fused vs generic {label} {tag}", _rel_err(grads["fused"][i], grads["generic"][i]),
                       _rel_err(plain[0][i], plain[1][i]), failures)
    if m == 128 and depth == 90:
        # The closed-form adjoint against backprop through the loop: in
        # float64 to rounding, in float32 within the spreads of both.
        backprop = [_one_vjp(_arnoldi_entry(kind, op, depth, reortho, custom_vjp=False), v0.to(dtype),
                             vals.to(dtype)) for op, dtype in ((matvec, torch.float32), (roll, torch.float64))]
        for label, i in (("dv", 0), ("dvals", 1)):
            spread = max(_rel_err(plain[0][i], plain[1][i]), _rel_err(backprop[0][i], backprop[1][i]))
            _report_spread(f"adjoint vs backprop {label} {tag}", _rel_err(grads["fused"][i], backprop[0][i]),
                           spread, failures)
            print(f"  adjoint vs backprop {label} in float64: max rel err "
                  f"{_rel_err(plain[1][i], backprop[1][i]):.3e}")
    if failures:
        raise RuntimeError(f"Arnoldi slice {tag} failed: {failures}")

    times, profiles = {}, {}
    for route in ("fused", "generic"):
        times[route] = events_ms(lambda r=route: _one_vjp(routes[r], v0, vals), 5)
        print(f"  VJP wall time {route}: {times[route]:.3f} ms (CUDA events, mean of 5 after warm-up)",
              flush=True)
    for route in ("fused", "generic"):
        profiles[route] = _print_profile(route, lambda r=route: _one_vjp(routes[r], v0, vals))
    return {"launches": launches, "vjp_ms": times, "profile": profiles, "n": n}


def _laplacian_logdet(m):
    """The closed-form log-determinant of the m x m Dirichlet Laplacian."""
    j = np.arange(1, m + 1)
    theta = np.pi * j / (m + 1)
    return float(np.sum(np.log(4.0 - 2.0 * np.cos(theta)[:, None] - 2.0 * np.cos(theta)[None, :])))


def phase_slice_slq(m=128):
    """Per-probe SLQ log-determinant, value and gradient in the DIA values:
    ``krylov_logdet_slq(blocked=False)`` over ``sparse_operator``."""
    from lanczos_adjoints_tpu_torch.krylov import lanczos
    from lanczos_adjoints_tpu_torch.ops import native, sparse
    from lanczos_adjoints_tpu_torch.trace import hutchinson, slq
    from lanczos_adjoints_tpu_torch.utils import test_util
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    mat = test_util.laplacian_2d(m)
    matvec, vals = sparse.sparse_operator(mat, device=DEVICE)
    n = mat.shape[0]
    print(f"[slice-slq] {m}x{m} Laplacian (n={n}): krylov_logdet_slq({SLQ_DEPTH}, "
          f"sampler_rademacher(num={SLQ_PROBES}), blocked=False, matfun=log), value and "
          f"gradient in the DIA values", flush=True)
    drawn = []
    rademacher = hutchinson.sampler_rademacher(torch.ones(n, device=DEVICE), num=SLQ_PROBES)

    def sample(key):
        drawn.append(rademacher(key))
        return drawn[-1]

    def value_and_grad(op, sampler, p0):
        logdet = slq.krylov_logdet_slq(SLQ_DEPTH, sample=sampler, num_batches=1, checkpoint=False)
        p = p0.clone().requires_grad_()
        value, _info = logdet(op, torch.Generator(device=DEVICE).manual_seed(3), p)
        (grad,) = torch.autograd.grad(value, [p])
        return value.detach(), grad

    native.reset_launches()
    value, grad = value_and_grad(matvec, sample, vals)
    torch.cuda.synchronize()
    launches = _launches(ARNOLDI_KERNELS)
    want = {"arnoldi_dia_forward": SLQ_PROBES, "dia_matvec": 0,
            "dia_matvec_transposed": SLQ_PROBES * SLQ_DEPTH, "dia_dvals": SLQ_PROBES * SLQ_DEPTH}
    failures = []
    finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(value))
    print(f"  launches {launches} (predicted {want}); value and gradient finite {finite}", flush=True)
    if launches != want or not finite:
        failures.append("launches")

    probes = drawn[0]
    with torch.no_grad():
        per_probe = torch.stack([lanczos.integrand_spd(torch.log, SLQ_DEPTH, matvec)(v, vals)
                                 for v in probes]).double()
    se = float(per_probe.std()) / SLQ_PROBES ** 0.5
    exact = _laplacian_logdet(m)
    dev = abs(float(value) - exact)
    print(f"  logdet: SLQ {float(value):.4f}, closed form {exact:.4f}, |diff| {dev:.4f}, standard "
          f"error of the {SLQ_PROBES} per-probe values {se:.4f}, |diff| / se {dev / se:.3f} (limit 5); "
          f"mean of the per-probe values {float(per_probe.mean()):.4f}", flush=True)
    if not dev <= 5 * se:
        failures.append("closed form")

    # The generic route (the K4 matvec without its DIA tag) and the plain
    # spread (the roll matvec, float32 vs float64), on the same probes.
    fixed = lambda _key: probes  # noqa: E731
    roll = sparse.dia_matvec_fn(sparse.dia_pack(mat))
    generic = value_and_grad(lambda v, p: matvec(v, p), fixed, vals)
    plain = [value_and_grad(lambda v, p: roll(v, p), lambda _k, d=dtype: probes.to(d), vals.to(dtype))
             for dtype in (torch.float32, torch.float64)]
    _report_spread("fused vs generic value", _rel_err(value, generic[0]),
                   _rel_err(plain[0][0], plain[1][0]), failures)
    _report_spread("fused vs generic gradient", _rel_err(grad, generic[1]),
                   _rel_err(plain[0][1], plain[1][1]), failures)
    if failures:
        raise RuntimeError(f"SLQ slice failed: {failures}")

    ms = events_ms(lambda: value_and_grad(matvec, fixed, vals), 5)
    generic_ms = events_ms(lambda: value_and_grad(lambda v, p: matvec(v, p), fixed, vals), 2)
    print(f"  value-and-gradient wall time: fused {ms:.3f} ms (mean of 5), generic {generic_ms:.3f} ms "
          f"(mean of 2; CUDA events after warm-up)", flush=True)
    profile = _print_profile("fused", lambda: value_and_grad(matvec, fixed, vals))
    return {"launches": launches, "ms": ms, "generic_ms": generic_ms, "profile": profile,
            "value": float(value), "exact": exact, "se": se}


def _flat_grads(model):
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def phase_slice_pde(resolution=PDE_GRID, steps=PDE_STEPS):
    """The wave-PDE training step (Arnoldi K = 10 over the convolution) on the
    bundled pairs: the adjoint gradient against backprop, then Adam steps."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import pde as train_pde

    stack = train_pde.assemble(resolution, device=DEVICE)
    print(f"[slice-pde] wave PDE {resolution}x{resolution}, {stack.inputs.shape[0]} bundled pairs, "
          f"expm_arnoldi(10) (generic Arnoldi over the convolution), MLP 500-500-1, Adam lr 1e-2, "
          f"{steps} steps", flush=True)
    # Step 0's gradient: the closed-form Arnoldi adjoint against backprop
    # through the loop, same weights.
    train_pde.loss_fn(stack)[0].backward()
    g_adjoint = _flat_grads(stack.model).clone()
    oracle = train_pde.assemble(resolution, custom_vjp=False, device=DEVICE)
    oracle.model.load_state_dict(stack.model.state_dict())
    train_pde.loss_fn(oracle)[0].backward()
    g_backprop = _flat_grads(oracle.model)
    torch.cuda.synchronize()
    rel = float(torch.linalg.vector_norm(g_adjoint - g_backprop) / torch.linalg.vector_norm(g_backprop))
    close = bool(torch.allclose(g_adjoint, g_backprop, atol=1e-2, rtol=1e-2))
    print(f"  step 0 gradient, adjoint vs backprop: relative norm error {rel:.3e} (limit 1e-02), "
          f"allclose(atol=rtol=1e-2) {close}; |grad| {float(torch.linalg.vector_norm(g_backprop)):.4e}",
          flush=True)
    del oracle
    if not (rel <= 1e-2 and close):
        raise RuntimeError("PDE adjoint gradient disagrees with backprop")

    native.reset_launches()
    losses, times = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, info = train_pde.train_step(stack)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(value.item())
        print(f"  step {step}: loss {losses[-1]:.6e} wall {times[-1]:.3f} s "
              f"(matvecs per solve {info['num_matvecs']})", flush=True)
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"PDE step {step} gave a non-finite loss")
    counts = native.launch_counts()
    print(f"  kernel launches over the steps (none expected: the convolution carries no DIA tag): "
          f"{ {k: c for k, c in counts.items() if c} }")
    return {"losses": losses, "step_s": times, "grad_rel_err": rel}


def _arnoldi_ops(n, depth, passes, num_diags=5):
    """fp32 operations of K9: the Gram-Schmidt dots and updates and the matvec."""
    return 4 * passes * n * depth * (depth + 1) // 2 + 2 * num_diags * n * depth


def phase_timing_arnoldi(slice_runs):
    """K9's device time per launch at [parity-arnoldi]'s shapes from 16,384 up,
    beside its bound and its plain version's time; its kernels-line entry."""
    from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa

    print("[timing-arnoldi] K9 at the slice's shapes (profiler and CUDA events); library: none",
          flush=True)
    rows, failures = {}, []
    rng = np.random.default_rng(9)
    for n, depth, reortho in ARNOLDI_PARITY:
        if n < 16_384:
            continue
        _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
        offsets, num_diags = dia.offsets, len(dia.offsets)
        v0 = _tensor(rng, n)
        passes = 2 if reortho == "full" else 1
        nbytes = 4 * ((num_diags + 2 + depth) * n + depth * depth + 1)
        ops = _arnoldi_ops(n, depth, passes, num_diags)
        # Re-reading the basis rows in every pass (dots and update) and the
        # matvec's operands every step, as the kernel does.
        modelled = 4 * (2 * passes * n * depth * (depth + 1) // 2 + depth * (num_diags + 6) * n)
        _record(rows, failures, (n, depth, reortho), "arnoldi_forward_kernel",
                [lambda: fa.hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)],
                [lambda: fa.hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)],
                nbytes, ops, 5 if n > 100_000 else 20, 1,
                exact=lambda: fa.hessenberg_dia_forward_plain(offsets, vals.double(), v0.double(),
                                                              depth, reortho))
        row = rows[(n, depth, reortho)]
        row.update(n=n, depth=depth, reortho=reortho, modelled_bytes=modelled)
        print(f"    modelled traffic re-reading the basis every pass: {modelled / 1e9:.3f} GB, "
              f"{1e3 * modelled / PEAK_BYTES:.3f} ms at 3.35 TB/s; launches in the main path's VJP: 1",
              flush=True)
    if failures:
        raise RuntimeError(f"K9 disagrees with its plain version in [timing-arnoldi]: {failures}")
    m, kind, depth, reortho = ARNOLDI_MAIN
    n = m * m
    main_run = slice_runs[ARNOLDI_MAIN]
    profile = main_run["profile"]["fused"]
    return {
        "name": "arnoldi_dia_forward", "route": "cuda",
        "source": "lanczos_adjoints_tpu_torch/csrc/arnoldi_dia.cu",
        "replaces": "lanczos_adjoints_tpu/ops/pallas_arnoldi.py:40",
        "also_replaces": "lanczos_adjoints_tpu/ops/pallas_arnoldi.py:112",
        "launches": main_run["launches"]["fused"]["arnoldi_dia_forward"],
        **rows[(n, depth, reortho)],
        "ms_in_vjp": _per_launch_ms(profile["kernels"], "arnoldi_forward_kernel") if profile else None,
        "launches_per_vjp": {f"{k} K={d} {r} m={g}": run["launches"]["fused"]["arnoldi_dia_forward"]
                             for (g, k, d, r), run in slice_runs.items()},
        "by_shape": [rows[key] for key in rows],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"[card] {card}", flush=True)
    from lanczos_adjoints_tpu_torch.utils.precision import pin_float32

    pin_float32()
    phase_build()
    phase_parity()
    phase_oracle()
    counts = phase_slice(N_TRAIN, steps=3)
    entries = phase_timing(N_TRAIN, counts)
    phase_parity_dia()
    phase_parity_lanczos()
    slices = {m: phase_slice_sparse(m) for m in SLICE_GRIDS}
    entries += phase_timing_sparse(slices)
    phase_parity_arnoldi()
    arnoldi_runs = {shape: phase_slice_arnoldi(*shape) for shape in ARNOLDI_SLICE}
    slq_run = phase_slice_slq()
    phase_slice_pde()
    entries.append(phase_timing_arnoldi(arnoldi_runs))
    main_arnoldi = arnoldi_runs[ARNOLDI_MAIN]["launches"]["fused"]
    for entry in entries:
        # The DIA kernels' launches in the Arnoldi adjoint (main path) and SLQ.
        if entry["name"] in ("dia_matvec", "dia_dvals"):
            key = "dia_matvec_transposed" if entry["name"] == "dia_matvec" else "dia_dvals"
            entry["launches_arnoldi_vjp"] = main_arnoldi[key]
            entry["launches_slq"] = slq_run["launches"][key]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
