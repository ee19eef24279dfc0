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
  6. kernel times at the slice's shapes (CUDA events) beside their
     bounds and their plain versions' times, as one JSON line.
The last two lines are the card (``name, power.limit``) and
``{"ok": true, "device": {...}}``.
"""

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

# The reference's largest run: N_train = 400,000 (the JAX driver's adj400k).
N_TRAIN = 400_000
DEVICE = "cuda"


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


def _events_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    X, y = _data(n_train)
    stack = train_gp.assemble(n_train=n_train, ndim=8, device=DEVICE)
    print(f"[slice] matern32 ARD, N_train={n_train}, d=8, 15 Lanczos x 15 probes, "
          f"PCG atol=1.0 miniter=10 maxiter=25, rank {stack.rank} (500 rounded down "
          f"to block 64), Adam lr=0.05, {steps} steps", flush=True)
    params = torch.randn(stack.num_params, generator=torch.Generator().manual_seed(1))
    opt = train_gp.AdamIfFinite(params.to(DEVICE).requires_grad_(), lr=0.05)
    key = torch.Generator(device=DEVICE).manual_seed(1)
    for k in fg.KERNELS:
        k.launches = 0
    per_step, times = [], []
    for step in range(steps):
        before = [k.launches for k in fg.KERNELS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, info, grad, applied = train_gp.train_step(stack, opt, key, X, y)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = [k.launches - b for k, b in zip(fg.KERNELS, before)]
        per_step.append(counts)
        times.append(seconds)
        finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(value))
        print(f"  step {step}: loss {value.item():.6f} cg_steps "
              f"{float(info['logpdf']['solve']['num_steps']):.0f} grad finite {finite} "
              f"applied {applied} wall {seconds:.3f} s launches "
              f"K1 {counts[0]} K2 {counts[1]}", flush=True)
        if not finite or min(counts) == 0:
            raise RuntimeError(f"slice step {step} failed (finite={finite}, launches={counts})")
    totals = [k.launches for k in fg.KERNELS]
    print(f"  launches over {steps} steps: K1 {totals[0]}, K2 {totals[1]}; "
          f"step wall times {[round(t, 3) for t in times]}")
    return {"launches": totals, "per_step": per_step, "step_s": times}


def _cell_ops(kernel, m, d=8):
    """fp32 operations per cell: distance 3d, Matern-3/2 value 5 (K1) or
    value and derivative plus the weighted sums 5d + 9 (K2), contraction 2m."""
    return 2 * m + (3 * d + 5 if kernel == "K1" else 5 * d + 9)


def phase_timing(n, slice_counts):
    """Kernel and plain times at the slice's shapes, and the kernels line."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

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
            ms = _events_ms(run, 2)
            # One timed plain run: it loops over thousands of row chunks,
            # so its first chunk's warm-up is lost in the total.
            want = []
            plain_ms = _events_ms(lambda: want.append(plain()), 1)
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
    print(json.dumps({"kernels": entries}), flush=True)


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
    phase_timing(N_TRAIN, counts)
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
