"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to their plain versions.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository; it exits non-zero without
printing a result when any of them is missing or any phase fails.

Phases, in order:
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (one nvcc per source, in parallel), with its time;
  3. kernel parity: K1 (``csrc/gram_matvec.cu``) with its autograd
     backward, and K2 (``csrc/gram_grads.cu``, bit for bit across two
     runs), against their plain PyTorch versions on the card, for rbf /
     matern12 / matern32, d in {1, 8, 12, 40, 65, 130} (the last two
     wide rows in chunks of 64), scalar and ARD lengthscales, K1 at m in
     {1, 15, 40} and K2 at m in {1, 8, 15, 225, 400}, ragged row counts;
     K1's short transcendentals entry by entry from p = 0 to distances of
     ~30; K1 with its column split at 50,000 x 400,000 (the first 4,096
     rows) and at the posterior mean's 100,000 x 400,000 (the first 3,000);
  4. the oracle: at N = 2,048 the Krylov marginal likelihood against a
     dense Cholesky one, and its gradient through the kernels against
     the gradient through the plain versions;
  5. the slice: 2 epochs (cut from 3) of the GP training step at N_train = 400,000
     (the reference's largest configuration) from the JAX ``adj400k``
     run's initial parameters (``train.gp.ADJ400K_INIT``), on that run's
     own split and probes (``train.gp.JaxDraws``, 5 host batches of 3
     probes an epoch), with per-epoch K1/K2 launch counts: the epoch-0
     loss within 1e-4 of the run's, 10 CG steps and its ``slq_std_rels``
     within 1 %; the parameters and Adam's moments after epoch 1 within
     1e-4 of ``ckpt_00000001``'s (each entry over its array's largest);
     epoch 1 within 5e-4 (``results/.../adj400k_synthetic_gp500k_s1_*.npy``);
     then the driver: ``train.gp.run`` at the ``adj400k`` arguments with
     no epoch, from that run's final parameters (its ``params_opt``), on
     its split and ``mll_eval`` probes: the pivoted Cholesky at 400,000,
     ``predict_mean_split`` (``--split_step``: PCG at 400,000 restarted
     from the true residual in chunks of ``--cg_maxiter`` 25 steps, then K1
     at the test-by-train cross shape 100,000 x 400,000) and ``mll_eval``
     on the 100,000 test points, test RMSE and NLL within 1e-3 of that
     run's (the one-PCG evaluation's gaps printed beside), the restarts, chunk steps
     and true residuals, its eleven series written, K1 launches and wall
     time by shape (at 400,000^2 as the restarts predict); then
     ``--matvec auto`` on the card: one step at
     N_train = 16,000 under the dense and the 8-partition plain policies
     against ``fused`` at the same probes (10x the plain policy's
     float32-vs-float64 spread), and one partitioned matvec at 400,000 x
     400,000 (50 partitions, m = 1 and 15) by CUDA events beside K1,
     with its peak memory; then ``[slice-fixed]``: ``train.gp.run`` in
     ``solver_mode="fixed"`` (``optim_logml_adjoints_fixed.py``), one epoch
     at the adj400k arguments and width on the JAX draws (exactly 15 PCG
     steps, a finite loss, K1/K2 launches as predicted), its evaluation
     through ``predict_mean_split`` (finite RMSE and NLL), and the
     fixed-mode step of ``auto`` against ``fused`` at 16,000 under
     ``[slice-auto]``'s gates, the spread the largest of the plain
     policies';
  6. DIA parity: K4 (``csrc/dia.cu``), K4 on the transpose (through the
     autograd backward) and K5 against their plain versions, offsets
     (-1, 0, 1), (-130, -7, 0, 7, 130), 65 and 100 diagonals with random
     values in every slot, and the 2-D Laplacian's with its packed
     values, n in {16,384, 1,000,000, 1,048,576};
  7. Lanczos parity: K6 and K7 (``csrc/lanczos_dia.cu``) against their
     plain versions (alphas, betas, basis, residual, dv, dvals for a
     seeded random cotangent) at (n, K) = (4,736, 12), (4,739, 12),
     (16,384, 90), (1,048,576, 90), on an exhausted Krylov space and on
     K7's other plans (65 and 100 diagonals, offsets half way round,
     n = 1,200,000 and 3,000,000), with each tolerance derived from the
     plain version's float32-vs-float64 spread; the autograd Function
     equals the two wrappers bit for bit; K7 bit for bit across two runs;
  8. the sparse slice: ``bench.py``'s flow through the port's entry
     points (the Laplacian on an m x m grid -> ``sparse_operator`` ->
     ``tridiag_dia_fused`` and the generic ``tridiag``), one VJP with the
     all-ones cotangent per route at m = 128, 1,000 and 1,024, with
     launches per VJP, the dispatch log, fused vs generic, and VJP wall
     times;
  9. kernel times at the slices' shapes beside their bounds, their
     plain versions' times and (K4) one library call, (K5) the gather and
     multiply ``u * x[idx]`` beside K5 behind a held stream, each held to
     its plain version again, and K7's traffic (each array once, the parent
     kernel's schedule, this one's). K4 and K5 cycle through operand sets
     larger than the L2 together, as the main path does;
 10. Arnoldi parity: K9 (``csrc/arnoldi_dia.cu``) against its plain
     version (Q, H, residual, 1/|v0|) and the autograd Function (K9
     forward, adjoint over the transposed K4 and K5) against the plain
     forward and adjoint, at (n, K) from (4,736, 12) to (1,000,000, 90),
     with and without re-orthogonalisation, on an exhausted Krylov
     space (exactly), and on the streamed path at (100,489, 90) (n odd),
     (262,144, 250) (small tiles, v0 not 16-byte aligned) and (9,216,
     1,000) (the direct path, which reads the basis from device memory;
     held to the plain version on the leading 100 columns and to the
     Arnoldi relation and orthonormality over all, once more with a plan
     that keeps its coefficients in device memory), and at 100 and 65
     diagonals;
     K9 bit for bit across two runs at (1,000,000, 90) and (16,384, 250);
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
 14. the PDE driver: ``train.pde.run`` (the JAX ``train.py`` epoch loop)
     from the JAX run's flax weights (``train/pde_s1.npz``) at 32 x 32
     (Arnoldi depth 4, 4 epochs: each loss and the learned field within
     1e-4 of the committed series), and at 128 x 128 with Arnoldi depth 10
     and Euler with 40 matvecs (3 of the 5 epochs each: epoch 0 within 1e-3 of the
     committed TPU series, every epoch within the larger of 1e-3 and 10x
     JAX's float32-vs-float64 spread of its float32 CPU run), the matvecs,
     the four files, epoch wall times;
 15. the work-precision sweep (``train.pde_workprecision.run``) at 64 x 64:
     float32 (Arnoldi depth 4 within 1 % of JAX's CPU value, every other
     error at most 1e-4) and float64 (the committed
     ``workprecision_x64_s1.json`` within 1 % above 1e-12, below 1e-12
     where it is below), the committed float32 (TPU) file beside; then
     ``[slice-pde-diffrax]``: ``models.pde.solver_diffrax`` on the sweep's
     problem at 128 x 128 (state 2 x 128 x 128), every method x adjoint at
     16 and 64 steps in float32 and float64, against RK4 with 1,024 steps
     in float64 (the step counts checked against each method's stability
     on the imaginary axis; finite; ``recursive_checkpoint`` within 10x
     the float32-vs-float64 spread of ``direct``; Dopri5, Tsit5 and Dopri8
     within their float64 error plus 10x the reference's float32-vs-float64
     spread, and within 1e-8 in float64; at 64 steps ``recursive_checkpoint`` and ``backsolve`` below
     ``direct`` in peak memory; the evaluations counted and
     ``num_matvecs``), with each pair's time by CUDA events;
 16. the data generator (``train.pde_data.run``) at 128 x 128 with 80 pairs
     from a generator (shapes, dtypes, finite), and RK4 from the bundled
     inputs and parameter missing the bundled targets by JAX's own miss
     (within 1e-4, at 32 x 32 and 128 x 128);
 17. K9's time per launch beside its bound (each array once), the
     traffic of its streamed schedule where the basis cannot stay on
     chip (three reads of the basis a step, two without
     re-orthogonalisation), its plain version and its launch plan (path,
     blocks, tile rows);
 18. K3 parity (``csrc/gram_dgrads.cu``): the data-gradient moments
     against their plain version at [parity]'s rows and widths, m in
     {1, 8, 15, 225, 400}, bit for bit across two runs, and the
     Function's x and y gradients against autograd through the plain
     matvec (run after phase 5);
 19. the input-gradient slice: at N = 2,048 the gradient in the
     parameters and the training inputs through the kernels against the
     plain policy, then one step at N_train = 400,000 with its launches
     (K3 is timed with K1 and K2 in phase 4's table);
 20. BSR parity: K10 (``csrc/bsr.cu``, over the packed CSR view of the
     tiles) against both plain versions (the tile product and the packed
     product), bit for bit across two runs, and its Function's backward,
     on the FEM test matrix (grid 24), its RCM permutation, a ragged
     rectangular matrix, tiles with values off the CSR structure and
     tiles updated in place between two calls (the cache packs again);
 21. the BSR slice: the FEM matrix -> ``sparse_operator`` (BSR, K10) ->
     the Lanczos (K = 90) and re-orthogonalised Arnoldi VJPs, custom
     adjoint and backprop (one pack of the tiles a VJP), per-probe SLQ
     against a float64 dense Cholesky log-determinant, and one Lanczos
     VJP over a HYB operator;
 22. K10's time per launch with the L2 flushed before each call (cold)
     and with only the vector changing (warm), beside cuSPARSE CSR under
     both, the bound on the bytes the nonzeros need, its plain version
     and the pack;
 23. halo parity: K11 (``csrc/halo_dia.cu``) on P in {1, 2, 8, 64}
     partitions (where the local rows hold the halo), on one allocation
     a partition, on views of one tensor and on views offset by one
     float (1 row a thread), bit for bit against K4 on the whole vector
     and its plain version with fused multiply-adds, offsets (-1, 0, 1),
     (-130, -7, 0, 7, 130), (-1024, -1, 0, 1, 1024), 65 and 100
     diagonals with random values in every slot, n in {16,384,
     1,000,000, 1,048,576}, and n = 1,000 over 8 partitions with offsets
     +-63 (a halo wider than half the rows); both paths (4 rows a thread
     and 1) reached; the C entry refuses a vector launch on misaligned
     operands; the Function's dv (K11 on the transpose) against K4^T and
     dvals against K5 (bit for bit);
 24. the halo slice: the multi-device scaling benchmark's 5-diagonal
     operator at n = 2^20 -> ``parallel.sharded_dia_operator`` ->
     ``tridiag(K = 30)``, one VJP with the all-ones cotangent at P in
     {1, 2, 4, 8}: 60 K11 launches per VJP and no other DIA kernel, the
     dispatch log, agreement with the unsharded K6/K7 route, VJP wall
     times, a profiled VJP at P = 8;
 25. the mesh slice: ``train.gp.dryrun_multichip(8)`` with the fused
     kernels, then one ``adj400k`` step over an 8-partition rows mesh
     against the unsharded step (loss 1e-4, gradient 1e-3), launches 8x;
 26. K11's time per launch at n = 2^20, P = 8, 4, 2 and 1, beside its
     bound and traffic, its plain version, K4 on the whole vector and
     cuSPARSE;
 27. the linearised-Laplace drivers (``train.laplace``, no kernel) at the
     parity MLP of 3,709 parameters, from the JAX drivers' float32 CPU
     run (its fixture ``laplace_s1.npz``): ``train_map`` from JAX's
     initial parameters (MAP within 1e-3), ``calibrate`` (3 epochs) and
     ``calibrate_diag`` (10) from JAX's MAP vector and probes (curves and
     alphas within 0.5 %), ``compute_metrics`` from JAX's MAP vector,
     draws and Ritz-vector signs (each metric within 1 %; the JAX
     package's float32-vs-float64 spread and each sample's smallest
     relative Ritz gap printed), the committed TPU files printed beside
     without a gate;
 28. ``train.laplace gridsearch`` (``plot_callibration_loss.py``) at 3,709
     parameters on the JAX grid search's own probes (9 log alphas x 5):
     each loss within 1e-3 of JAX's float64 CPU run and within 10x JAX's
     float32-vs-float64 spread of its float32 run, each std within 1e-2,
     the committed TPU ``s1_gridsearch.npz`` beside without a gate;
 29. ``python -m lanczos_adjoints_tpu_torch.train.laplace callibration``
     at ``FULL_WIDTH_ARGS`` (3,688,970 parameters, 10 of its 30 epochs) on the
     port's own data: finite, the final loss under half the first, one
     float32 step within 1e-3 (loss) and 1e-2 (d/dlog alpha) of float64,
     one finite step at rank 50, the time per epoch by CUDA events, a
     profiled epoch and the peak memory. Phases 24-25 fail on any tensor
     off the card and on any launch of K1-K12;
 30. ``[slice-gp-report]`` (right after phase 5's driver run, on its
     files): ``train.gp_report``'s table with the card's name as the
     label, the run's RMSE and NLL in its row;
 31. the paper's studies (``studies/``) at their JAX scripts' defaults:
     ``[study-orthogonality]`` (float64 on the card, the rows of n = 4,
     8, 12 within 10x JAX's one-ulp spread of the committed rows),
     ``[study-wall-times]`` (Lanczos, Lanczos re-orthogonalised and
     Arnoldi at the 128 x 128 Laplacian, K = 10-250: the dispatch of each
     series, the launches of one call per depth and series against the
     prediction, finite times, finite values where backprop runs),
     ``[study-vjp-matvec]`` (the JAX script's 1e-3 between the two
     gradients), ``[study-mll]`` (both policies, agreeing within 1e-3)
     and ``[study-gram-matvec]`` (K1 once at each N, within 1e-4 of the
     plain policies that ran; a plain policy out of memory is recorded as
     failed);
 32. the sparse-format, roofline and scaling studies at their JAX
     scripts' defaults: ``[study-dia-roofline]`` (K12, ``csrc/dia_ceiling.cu``,
     at 128-1,024 threads a block against K4, the plain matvec and
     cuSPARSE at n_side 1,024 and 2,048, L2-warm and L2-cold; K12 bit for
     bit against its plain version at both sizes, at n % 4 != 0 and on
     misaligned views; launches against the prediction; K4 L2-cold at
     1024^2 within 20 % of its [timing-sparse] time), ``[study-spmv-formats]``
     (every format row, K4 and K10 within 1e-5 of the plain rows, the
     launches of each row's matvec and VJP as predicted) and
     ``[study-multihost]`` (the K1 and K4 local tables, the link stand-ins
     and the model on the card, then the measured path on 1-16 partitions
     of one card, its dv and dvals within 10x the plain spread of the
     unsharded fused route, 60 K11 launches a VJP);
 33. ``[study-mtx-parser]``: ``studies.mtx_parser`` at 500,000 rows (the
     JAX script's 1,000,000 cut in half) of 8 entries, the file read by scipy,
     the port's C++ parser (``native/mtxparse.cc``, built by the host
     compiler) and numpy into one CSR, each path's MB/s on the host. Every
     phase prints its wall time (``[phase-time]``). The kernels of every slice, with their
     numbers, form one JSON line.
Every profiled run prints the profiler's launch count of each of the
port's kernels beside the registry's, and flags a kernel whose launches
the profiler missed (its busy time is then a lower bound, its idle share
an upper bound).
The last two lines are the card (``name, power.limit``) and
``{"ok": true, "device": {...}}``.
"""

import ctypes
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# fp32 rates of one H100 SXM (NVIDIA data sheet): CUDA-core peak and HBM3.
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12
# The dense TF32 tensor-core peak, over the three products of a 3xTF32
# (fp32-accurate) contraction.
PEAK_FLOPS_3XTF32 = 495e12 / 3

# Kernel-vs-plain tolerances on the card (max abs error over max |plain|).
# Both sides compute the same direct-difference cells in float32; they
# differ only in summation order and fused multiply-adds.
TOL_K1 = 1e-4
TOL_K2 = 1e-3  # sums over millions of cells of both signs
# K3 (data gradients): ten times the JAX fused-kernel tests' value
# tolerance per family, as those tests hold the data gradients
# (tests/test_ops/test_pallas_gram.py:23, :163).
TOL_K3 = {"rbf": 1e-3, "matern12": 5e-2, "matern32": 1e-3}

# DIA kernels (K4 and its transpose) vs plain: an output is a sum of D
# float32 products (D <= 100 here) in the same order, with fused
# multiply-adds, so a few units in the last place of the largest partial
# sum, over the largest output.
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

# The reference's largest run: N_train = 400,000 (the JAX driver's adj400k),
# and its test set of 100,000.
N_TRAIN = 400_000
N_TEST = N_TRAIN // 4
# The port against the JAX adj400k run (train.gp.ADJ400K_ARGS and
# train.gp.adj400k_jax_result) on its own split and probes (train.gp.JaxDraws):
# the relative gap of the epoch-0 loss (the initial parameters: the loss
# computation alone), of slq_std_rels at epoch 0, of the parameters and
# Adam's moments after epoch 1 against its checkpoint (each entry over its
# array's largest), of the later epochs' losses, and of the test RMSE and NLL.
TOL_EPOCH0 = 1e-4
TOL_STD_REL = 1e-2
# slq_std_rels[0] in float64 at the same draws (the plain partitioned policy;
# ``scripts/torch_gp_adj400k.py --epoch0_f64`` on an H100): the spread over 5
# host batches of values ~2.4e5 apart by ~1e2, so per-batch errors are
# amplified 2,500-fold. The JAX run's 4.134285e-4 is 5.3 % above it (its
# batches carry ~2e-5 of TPU rounding); the port is held to this value and
# JAX's is printed beside.
SLQ_STD_REL0_F64 = 3.926419e-4
TOL_CKPT = 1e-4
TOL_LATER_EPOCHS = 5e-4
TOL_JAX_RUN = 1e-3
DEVICE = "cuda"
# [slice-laplace-full]'s calibration epochs at full width (the JAX run took 30;
# its curve falls under half its first value by epoch 4). 10, cut from 15 to
# leave the studies' phases room in the run's time.
LAPLACE_FULL_EPOCHS = 10
# The sparse slice: bench.py's Lanczos depth, its 128 x 128 grid and the
# 1024 x 1024 grid (the largest DIA case the JAX package was run at).
DEPTH = 90
GRIDS = (128, 1024)
# The sparse slice also runs the 1000 x 1000 grid: n = 1,000,000 is a
# multiple of neither 128 nor 1024, the JAX kernels' tiling rules, and on
# the card must still run every kernel of the path.
SLICE_GRIDS = (128, 1000, 1024)
# Operators of more than 64 diagonals (the DIA kernels took at most 64
# before their offsets moved to device memory): a band of 65, and 100
# spread over +-150.
WIDE_65 = tuple(range(-32, 33))
WIDE_100 = tuple(3 * k for k in range(-50, 51) if k)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def _events_ms_clocked(fn, reps):
    """``events_ms(fn, reps)``, with the card's clocks read while the runs
    it enqueued are still executing."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    clocks = _clocks()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, clocks


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
                 dims=(1, 8, 12, 40, 65, 130)):
    """K1, its autograd backward and K2 against their plain versions.

    d = 40 reaches the 64-wide instantiation and d = 65, 130 the wide
    rows (padded to 128 and 192, taken in chunks of 64); K1 at m = 40
    serves the right-hand sides in three passes, the last ragged. K2 is
    bit for bit across two runs. Then K1's short transcendentals at the
    tails (p = 0 and distances up to ~30) entry by entry, and K1 with its
    column split at 50,000 x 400,000 rows.
    """
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    print("[parity] kernels vs plain versions on the card", flush=True)
    failures = []
    rng = np.random.default_rng(0)
    restaged_rng = np.random.default_rng(400)
    n, n_cols = rows
    for kind in kinds:
        for d in dims:
            x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=device)
            y = torch.tensor(rng.standard_normal((n_cols, d)), dtype=torch.float32, device=device)
            for ard in (False, True):
                # Wide rows: lengthscales grown with sqrt(d), so that the
                # kernel values stay away from 0 as at the narrow widths.
                ell_np = rng.uniform(0.5, 2.0, (d,) if ard else ()) * _wide_scale(d)
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
                # K2: m = 1 (no contraction), one k-step, a per-probe width, the
                # SLQ adjoint's width (ragged against the 8-wide k-steps), and a
                # width whose U rows do not fit in shared memory (re-staged),
                # drawn from its own generator so that the other cases' inputs
                # do not depend on it.
                for m in (1, 8, 15, 225, 400):
                    gen = restaged_rng if m == 400 else rng
                    v = torch.tensor(gen.standard_normal((n_cols, m)), dtype=torch.float32, device=device)
                    u = torch.tensor(gen.standard_normal((n, m)), dtype=torch.float32, device=device)
                    got = fg.gram_grads_rows(kind, xs, ys, v, u)
                    again = fg.gram_grads_rows(kind, xs, ys, v, u)
                    want = fg.gram_grads_plain(kind, xs, ys, v, u)
                    torch.cuda.synchronize()
                    _report(f"K2 {tag} m={m}", _rel_err(got, want), TOL_K2, failures)
                    if not torch.equal(got, again):
                        print(f"  K2 {tag} m={m}: two runs differ FAIL", flush=True)
                        failures.append(f"K2 {tag} m={m} bitwise")
    _parity_k1_tails(kinds, failures)
    _parity_k1_split(failures)
    if failures:
        msg = f"{len(failures)} kernel parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _wide_scale(d):
    return np.sqrt(d / 8) if d > 64 else 1.0


def _parity_k1_tails(kinds, failures):
    """K1's Gram values entry by entry (v = the identity), against the plain
    version's full-precision sqrt and exp, from p = 0 (y = x) to distances
    of ~30, where the values fall to ~1e-12 (Matern) and below."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    n_cols, d = 16, 8
    y = torch.zeros((n_cols, d), device=DEVICE)
    y[:, 0] = torch.linspace(0.0, 30.0, n_cols, device=DEVICE)
    x = y.repeat(4, 1)  # rows at every distance from every column, p = 0 on the diagonal
    x[n_cols:, 1] = torch.linspace(1e-4, 3.0, 3 * n_cols, device=DEVICE)
    eye = torch.eye(n_cols, device=DEVICE)
    for kind in kinds:
        for m in (1, n_cols):
            one = torch.tensor(1.0, device=DEVICE)
            xs, ys = fg.kernel_rows(x, one, kind), fg.kernel_rows(y, one, kind)
            v = eye[:, :m].contiguous()
            got = fg.gram_matvec_rows(kind, xs, ys, v)
            want = fg.gram_matvec_plain(kind, xs, ys, v)
            torch.cuda.synchronize()
            live = want > 1e-30
            rel = float(((got - want).abs()[live] / want[live]).max())
            tiny = float(got[~live].abs().max()) if bool((~live).any()) else 0.0
            _report(f"K1 tails {kind} m={m} (entrywise over {int(live.sum())} values > 1e-30, "
                    f"min {float(want[live].min()):.2e}; max |K1| at the others {tiny:.1e}, limit 2e-30)",
                    rel if tiny <= 2e-30 else float("inf"), TOL_K1, failures)


def _parity_k1_split(failures, cases=((50_000, N_TRAIN, 8, (1, 15), 4096), (N_TEST, N_TRAIN, 8, (1,), 3_000),
                                     (3_000, 20_000, 130, (15,), 3_000))):
    """K1 with its column split, the segments summed in the launch: at one of
    8 row partitions of the main path's shape and at the posterior mean's
    test-by-train shape (the first rows against the plain version), and on
    wide rows (the staged kernel), bit for bit across two runs."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    g = torch.Generator(device=DEVICE).manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, n_cols, d, ms, check_rows in cases:
        ell = torch.full((d,), 0.9 * _wide_scale(d), device=DEVICE)
        xs = fg.kernel_rows(torch.randn((n, d), generator=g, device=DEVICE), ell, "matern32")
        ys = fg.kernel_rows(torch.randn((n_cols, d), generator=g, device=DEVICE), ell, "matern32")
        splits = fg.column_splits(n, n_cols, sms)
        for m in ms:
            v = torch.randn((n_cols, m), generator=g, device=DEVICE)
            got = fg.gram_matvec_rows("matern32", xs, ys, v)
            again = fg.gram_matvec_rows("matern32", xs, ys, v)
            want = fg.gram_matvec_plain("matern32", xs[:check_rows], ys, v)
            torch.cuda.synchronize()
            tag = f"K1 {n} x {n_cols} d={d} m={m}, {splits} column segments"
            _report(f"{tag} (first {check_rows} rows)", _rel_err(got[:check_rows], want), TOL_K1, failures)
            if splits < 2 or not torch.equal(got, again):
                print(f"  {tag}: not split, or two runs differ FAIL", flush=True)
                failures.append(f"{tag} bitwise")


def _plain_policy():
    """The fused policy's shape with the plain, autograd-differentiated matvec
    (on index-based kernels and, for input gradients, on feature rows)."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    def matvec(fun):
        kind, constrain = fun.fused_spec
        indexed = getattr(fun, "fused_data", None)

        def matvec_y(i, j, v, raw_ell, raw_out):
            x, y = (i, j) if indexed is None else (indexed[0][i], indexed[0][j])
            return fg.gram_matvec_reference(kind, x, y, v, constrain(raw_ell), constrain(raw_out))

        return matvec_y

    return matvec


def _data(n_train, seed=1):
    from lanczos_adjoints_tpu_torch.utils import data, uci

    X, y = uci.uci_synthetic_gp500k()
    n = n_train * 5 // 4
    (X_tr, y_tr), _ = data.split_train_test_shuffle(seed, X[:n], y[:n], train_fraction=0.8)
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


def _adj400k_args(*extra):
    import argparse

    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    return train_gp.build_argparser(argparse.ArgumentParser()).parse_args(
        [*train_gp.ADJ400K_ARGS, "--device", DEVICE, *extra])


def phase_slice(n_train, epochs=2):
    """Epochs of the training step at the reference's largest configuration,
    from the JAX adj400k run's initial parameters, on that run's own split and
    probes (``train.gp.JaxDraws``: 5 host batches of 3 probes an epoch): the
    epoch-0 loss, CG steps and ``slq_std_rels`` against the run's; the
    parameters and Adam's moments after epoch 1 against its checkpoint; the
    later losses against its curve."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    draws = train_gp.JaxDraws(device=DEVICE)
    args = _adj400k_args("--num_epochs", str(epochs), "--out", "unused")
    (X, y), _test = train_gp.split(args, permutation=draws.permutation)
    if len(X) != n_train:
        raise RuntimeError(f"the JAX split gives {len(X)} training points, not {n_train}")
    stack = train_gp.assemble(n_train=n_train, ndim=8, device=DEVICE, sample=train_gp.sample_given,
                              slq_host_batches=args.slq_host_batches)
    want = {name: train_gp.adj400k_jax_result(name) for name in ("loss_curve", "cg_numsteps_all", "slq_std_rels")}
    ckpt = {name: draws.arrays[f"ckpt1_{name}"] for name in ("params", "mu", "nu")}
    print(f"[slice] matern32 ARD, N_train={n_train}, d=8, 15 Lanczos x 15 probes in {args.slq_host_batches} host "
          f"batches, PCG atol=1.0 miniter=10 maxiter=25, rank {stack.rank} (500 rounded down to block 64), Adam "
          f"lr=0.05, {epochs} epochs from the JAX adj400k run's initial parameters on its own split and probes: "
          f"epoch 0 loss within {TOL_EPOCH0:.0e} of {want['loss_curve'][0]:.8f}, {want['cg_numsteps_all'][0]} CG "
          f"steps, slq_std_rels within {TOL_STD_REL:.0%} of its float64 value {SLQ_STD_REL0_F64:.6e} (the JAX run's "
          f"{want['slq_std_rels'][0]:.6e}); after epoch 1 each "
          f"parameter and Adam moment within {TOL_CKPT:.0e} of its array's largest (ckpt_00000001); epochs 1-{epochs - 1} "
          f"within {TOL_LATER_EPOCHS:.0e}", flush=True)
    params = torch.tensor(train_gp.ADJ400K_INIT, dtype=torch.float32)
    opt = train_gp.AdamIfFinite(params.to(DEVICE).requires_grad_(), lr=0.05)
    gram = (native.KERNELS["gram_matvec"], native.KERNELS["gram_grads"])
    native.reset_launches()
    per_step, times, gaps, failures = [], [], [], []
    for epoch in range(epochs):
        before = [k.launches for k in gram]
        key = draws.epoch_key(epoch, n_train)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, info, grad, applied = train_gp.train_step(stack, opt, key, X, y)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = [k.launches - b for k, b in zip(gram, before)]
        per_step.append(counts)
        times.append(seconds)
        finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(value))
        gap = value.item() / want["loss_curve"][epoch] - 1.0
        gaps.append(gap)
        steps = int(info["logpdf"]["solve"]["num_steps"])
        std_rel = float(info["logpdf"]["logdet"]["std_rel"])
        std_gap = std_rel / want["slq_std_rels"][epoch] - 1.0
        f64_gap = std_rel / SLQ_STD_REL0_F64 - 1.0
        print(f"  epoch {epoch}: loss {value.item():.8f} (JAX run {want['loss_curve'][epoch]:.8f}, gap {gap:+.3e}) "
              f"cg_steps {steps} (JAX {want['cg_numsteps_all'][epoch]}) slq_std_rel {std_rel:.6e} (JAX "
              f"{want['slq_std_rels'][epoch]:.6e}, gap {std_gap:+.3e}{'' if epoch else f'; float64 {SLQ_STD_REL0_F64:.6e}, gap {f64_gap:+.3e}'}) "
              f"grad finite {finite} applied {applied} "
              f"wall {seconds:.3f} s launches K1 {counts[0]} K2 {counts[1]}; probes left {len(key)}", flush=True)
        if not finite or min(counts) == 0 or len(key):
            failures.append(f"epoch {epoch}: finite={finite}, launches={counts}, probes left {len(key)}")
        tol = TOL_EPOCH0 if epoch == 0 else TOL_LATER_EPOCHS
        if not abs(gap) <= tol:
            failures.append(f"epoch {epoch} loss gap {gap:+.3e} (tol {tol:.0e})")
        if epoch == 0 and not (steps == want["cg_numsteps_all"][0] and abs(f64_gap) <= TOL_STD_REL):
            failures.append(f"epoch 0: cg_steps {steps}, slq_std_rel gap to float64 {f64_gap:+.3e}")
        if epoch == 1:
            state = opt.adam.state[opt.params]
            ours = {"params": opt.params.detach(), "mu": state["exp_avg"], "nu": state["exp_avg_sq"]}
            for name, ref in ckpt.items():
                diff = np.abs(ours[name].cpu().numpy().astype(np.float64) - ref)
                err = float(np.max(diff) / np.max(np.abs(ref)))
                print(f"  after epoch 1, {name} vs ckpt_00000001: max |gap| {np.max(diff):.3e}, over its largest "
                      f"entry {err:.3e} (tol {TOL_CKPT:.0e}); entries {np.array2string(diff, precision=2)}",
                      flush=True)
                if not err <= TOL_CKPT:
                    failures.append(f"after epoch 1: {name} {err:.3e}")
            count = int(state["step"])
            if count != int(draws.arrays["ckpt1_count"]):
                failures.append(f"Adam's step count {count}")
    totals = [k.launches for k in gram]
    print(f"  launches over {epochs} epochs: K1 {totals[0]}, K2 {totals[1]}; epoch wall times "
          f"{[round(t, 3) for t in times]}")
    if failures:
        raise RuntimeError(f"slice failed: {failures}")
    return {"launches": totals, "per_step": per_step, "step_s": times, "gaps": gaps}


def _auto_against_fused(n, partitions, solver_mode, pooled_spread=False):
    """One ``train_step`` at N_train = ``n`` in ``solver_mode`` under the plain
    ``auto`` policies (dense, partitioned) against ``fused`` (K1/K2) at the
    same probes: the loss and gradient within 10x the plain policy's
    float32-vs-float64 spread (never below ``SPREAD_FLOOR``), the CG steps
    equal. With ``pooled_spread`` the spread is the largest of the plain
    policies' at these inputs: one scalar's spread is one draw of the
    float32 rounding and may land near zero by chance (on an H100 the
    fixed-mode loss's spread was 1.27e-7 at 8 partitions, 1.32e-6 dense,
    and the kernels' loss 1.3e-6 from float64). Returns one row a partition count,
    ``"ok"`` among its keys."""
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    X32, y32 = _data(n, seed=3)
    probes32 = torch.tensor(np.random.default_rng(3).choice([-1.0, 1.0], size=(15, n)), device=DEVICE,
                            dtype=torch.float32)
    params32 = torch.tensor(train_gp.ADJ400K_INIT, dtype=torch.float32, device=DEVICE)

    def step(policy, dtype):
        to = lambda t: t.to(dtype)  # noqa: E731
        stack = train_gp.assemble(n_train=n, ndim=8, device=DEVICE, matvec=policy, solver_mode=solver_mode,
                                  sample=lambda _key: to(probes32))
        opt = train_gp.AdamIfFinite(to(params32).clone().requires_grad_(), lr=0.05)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, info, grad, _applied = train_gp.train_step(stack, opt, None, to(X32), to(y32))
        torch.cuda.synchronize()
        # Fixed-step PCG reports no step count; it takes assemble's 15 (num_matvecs).
        steps = int(info["logpdf"]["solve"].get("num_steps", 15))
        return value.item(), grad.double().cpu(), steps, time.perf_counter() - t0

    fused = step(train_gp.gram_policy("fused", 1), torch.float32)
    runs, spreads = {}, {}
    for parts in partitions:
        policy = train_gp.gram_policy("auto", parts)
        auto32, auto64 = runs[parts] = step(policy, torch.float32), step(policy, torch.float64)
        spreads[parts] = (abs(auto32[0] - auto64[0]) / abs(auto64[0]),
                          float((auto32[1] - auto64[1]).abs().max() / auto64[1].abs().max()))
    report = {}
    for parts in partitions:
        auto32, auto64 = runs[parts]
        spread_loss, spread_grad = (max(s[i] for s in spreads.values()) if pooled_spread else spreads[parts][i]
                                    for i in (0, 1))
        err_loss = abs(auto32[0] - fused[0]) / abs(fused[0])
        err_grad = float((auto32[1] - fused[1]).abs().max() / fused[1].abs().max())
        tol_loss = max(SPREAD_FACTOR * spread_loss, SPREAD_FLOOR)
        tol_grad = max(SPREAD_FACTOR * spread_grad, SPREAD_FLOOR)
        ok = err_loss <= tol_loss and err_grad <= tol_grad and auto32[2] == fused[2]
        print(f"  {solver_mode}, auto, {parts} partition(s): loss {auto32[0]:.8f} vs fused {fused[0]:.8f} (rel "
              f"{err_loss:.2e}, tol {tol_loss:.2e} = 10x the f32-vs-f64 spread {spread_loss:.2e}"
              f"{' (the largest of the plain policies)' if pooled_spread else ''}); gradient max rel "
              f"{err_grad:.2e} (tol {tol_grad:.2e}, spread {spread_grad:.2e}); CG steps {auto32[2]} vs {fused[2]}; "
              f"wall auto f32 {auto32[3]:.2f} s, f64 {auto64[3]:.2f} s, fused {fused[3]:.2f} s "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        report[parts] = {"loss_rel": err_loss, "grad_rel": err_grad, "spread_loss": spread_loss,
                         "spread_grad": spread_grad, "seconds": auto32[3], "ok": ok}
    return report


def phase_slice_auto(n=16_000, partitions=(1, 8), big=N_TRAIN, big_partitions=50):
    """``--matvec auto`` on the card: one ``train_step`` at N_train = ``n`` under
    the dense and the partitioned plain policies against ``fused`` (K1/K2) at
    the same probes, within 10x the plain policy's float32-vs-float64 spread;
    then one partitioned matvec at ``big`` x ``big`` (``big_partitions`` row
    blocks, m = 1 and 15) by CUDA events beside K1 at the same inputs, with
    its peak memory."""
    from lanczos_adjoints_tpu_torch.models import gp
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.ops import gram
    from lanczos_adjoints_tpu_torch.train import gp as train_gp
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    print(f"[slice-auto] train.gp.gram_policy('auto', P) on the card: one train_step at N_train={n}, d=8, matern32 "
          f"ARD, 15 Lanczos x 15 probes, rank 448, against 'fused' at the same probes; then one partitioned matvec "
          f"at {big} x {big}, {big_partitions} partitions", flush=True)
    failures, report = [], _auto_against_fused(n, partitions, "adaptive")
    failures += [f"auto at {parts} partitions" for parts, row in report.items() if not row["ok"]]

    g = torch.Generator(device=DEVICE).manual_seed(4)
    Xb = torch.randn((big, 8), generator=g, device=DEVICE)
    raw_ell, raw_out = torch.full((8,), 0.5, device=DEVICE), torch.tensor(0.3, device=DEVICE)
    kernel = gp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](raw_lengthscale=raw_ell,
                                                                          raw_outputscale=raw_out)
    matvec = gram.gram_matvec_partitioned(big_partitions, checkpoint=True)(kernel)
    constrain = gp.constraint_greater_than(0.0)
    xs = fg.kernel_rows(Xb, constrain(raw_ell), "matern32")
    for m in (1, 15):
        v = torch.randn((big, m), generator=g, device=DEVICE)
        with torch.no_grad():
            got = matvec(Xb, Xb, v, raw_ell, raw_out)  # warm-up and the value held to K1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = events_ms(lambda: matvec(Xb, Xb, v, raw_ell, raw_out), 1)
            peak = torch.cuda.max_memory_allocated() - base
            k1 = fg.gram_matvec_rows("matern32", xs, xs, v) * constrain(raw_out)
            k1_ms = events_ms(lambda: fg.gram_matvec_rows("matern32", xs, xs, v), 2)
        err = float((got - k1).abs().max() / k1.abs().max())
        print(f"  partitioned matvec {big} x {big}, m={m}, {big_partitions} partitions: {ms:.1f} ms by CUDA events, "
              f"peak memory {peak / 2**30:.2f} GiB above its inputs; K1 at the same inputs {k1_ms:.1f} ms (earlier "
              f"runs: {'209.4-212.5' if m == 1 else '250.3-253.6'} ms); max rel err vs K1 {err:.2e} (tol {TOL_K1:.0e})",
              flush=True)
        report[f"big m={m}"] = {"ms": ms, "k1_ms": k1_ms, "peak_gib": peak / 2**30, "rel_err": err}
        if not err <= TOL_K1:
            failures.append(f"partitioned matvec m={m}")
        del v, got, k1
    if failures:
        raise RuntimeError(f"slice-auto failed: {failures}")
    return report


# The gaps of the one-PCG evaluation (``predict_mean``) to the JAX adj400k run
# on an H100 (test RMSE, NLL), printed beside the restarted evaluation's.
ONE_PCG_GAPS = {"rmse": 4.0e-4, "nll": 1.2e-5}


def _tallied_k1(by_shape):
    """``fused_gram.gram_matvec_rows`` that tallies its launches into ``by_shape``:
    (rows, columns, m) -> (count, synchronised seconds)."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    launch = fg.gram_matvec_rows

    def tallied(kind, xs, ys, v2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = launch(kind, xs, ys, v2)
        torch.cuda.synchronize()
        key = (xs.shape[0], ys.shape[0], v2.shape[1])
        count, seconds = by_shape.get(key, (0, 0.0))
        by_shape[key] = (count + 1, seconds + time.perf_counter() - t0)
        return out

    return launch, tallied


def _split_eval_line(info) -> str:
    """``predict_mean_split``'s restarts, chunk steps and true residuals, as one line."""
    residuals, chunks = info["residual_rms"], info["chunk_steps"]
    return (f"predict_mean_split: {len(residuals)} true residuals, {len(chunks)} PCG chunks of {chunks} steps "
            f"({sum(chunks)} in all), true-residual RMS {[float(f'{r:.3e}') for r in residuals]} "
            f"(final {residuals[-1]:.3e}, atol 1e-2)")


def _split_eval_k1(info) -> int:
    """K1 launches at N_train x N_train of ``predict_mean_split``: one a true
    residual, and a chunk of k steps k + 1 (PCG's start from x = 0 applies the
    operator once)."""
    return len(info["residual_rms"]) + sum(info["chunk_steps"]) + len(info["chunk_steps"])


def phase_slice_driver(results_dir):
    """The driver's evaluation at the adj400k configuration, at the JAX run's
    final parameters, on its split and with its ``mll_eval`` probes
    (``train.gp.JaxDraws``): ``train.gp.run`` with no epoch, through the
    pivoted Cholesky, ``predict_mean_split`` (``--split_step``: PCG at
    400,000 restarted from the true residual in chunks of ``--cg_maxiter``
    25 steps, then the 100,000 x 400,000 cross product) and ``mll_eval`` on
    the test set; test RMSE and NLL within ``TOL_JAX_RUN`` of the JAX
    run's, the eleven series written. K1 launches are tallied by shape
    (rows, columns, m) with their wall time, each launch synchronised
    before and after. The series go to ``results_dir``, which
    ``[slice-gp-report]`` reads."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    params0 = train_gp.adj400k_jax_result("params_opt")
    want = {"rmse": float(train_gp.adj400k_jax_result("test_rmses")),
            "nll": float(train_gp.adj400k_jax_result("test_nlls"))}
    print(f"[slice-driver] train.gp.run at the adj400k arguments, no epoch, from the JAX run's params_opt, on its "
          f"split and mll_eval probes: predict_mean_split (restarted PCG, chunks of --cg_maxiter 25) and mll_eval "
          f"on the test set, held to the JAX run's RMSE {want['rmse']:.6f} and NLL {want['nll']:.6f} within "
          f"{TOL_JAX_RUN:.0e}", flush=True)
    by_shape = {}
    launch, tallied = _tallied_k1(by_shape)
    args = _adj400k_args("--num_epochs", "0", "--out", results_dir)
    fg.gram_matvec_rows = tallied
    native.reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train_gp.run(args, solver_mode="adaptive", params0=params0,
                              draws=train_gp.JaxDraws(device=DEVICE))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        fg.gram_matvec_rows = launch
    counts = _launches(("gram_matvec", "gram_grads"))
    files = sorted(os.listdir(results_dir))
    saved = np.load(f"{result.path}_params_opt.npy")
    names = sorted(f"adj400k_synthetic_gp500k_s1_{name}.npy" for name in train_gp.RESULTS)
    gaps = {"rmse": result.test_rmse / want["rmse"] - 1.0, "nll": result.test_nll / want["nll"] - 1.0}
    split = result.predict_info
    steps = {"predict_mean_split": sum(split.get("chunk_steps", [])),
             "mll_eval": float(result.eval_info["logpdf"]["solve"]["num_steps"])}
    eval_residual = float(torch.sqrt(torch.mean(result.eval_info["logpdf"]["solve"]["residual_abs"] ** 2)))
    print(f"  test RMSE {result.test_rmse:.6f} (JAX run {want['rmse']:.6f}, gap {gaps['rmse']:+.3e}; the "
          f"one-PCG evaluation's {ONE_PCG_GAPS['rmse']:.1e}), test NLL {result.test_nll:.6f} (JAX run {want['nll']:.6f}, gap "
          f"{gaps['nll']:+.3e}; one PCG {ONE_PCG_GAPS['nll']:.1e})", flush=True)
    print(f"  {_split_eval_line(split)}; mll_eval PCG {steps['mll_eval']:.0f} steps, residual RMS "
          f"{eval_residual:.3e} (atol 1e-4); wall: run {seconds:.2f} s, predict_mean_split "
          f"{result.seconds['predict_mean']:.2f} s, mll_eval {result.seconds['mll_eval']:.2f} s", flush=True)
    for (rows, cols, m), (count, secs) in sorted(by_shape.items()):
        print(f"  K1 {rows} x {cols} m={m}: {count} launches, {secs:.3f} s (synchronised)", flush=True)
    print(f"  launches: K1 {counts['gram_matvec']}, K2 {counts['gram_grads']}; {len(files)} files written, "
          f"params_opt equal to params0 {np.array_equal(saved, params0)}", flush=True)
    failures = [k for k, gap in gaps.items() if not abs(gap) <= TOL_JAX_RUN]
    if files != names:
        failures.append(f"files {files}")
    if not np.array_equal(saved, params0):
        failures.append("params_opt differs from params0")
    if "chunk_steps" not in split:
        failures.append("the evaluation did not go through predict_mean_split")
    elif by_shape.get((N_TRAIN, N_TRAIN, 1), (0,))[0] != _split_eval_k1(split):
        failures.append(f"K1 at {N_TRAIN}^2: {by_shape.get((N_TRAIN, N_TRAIN, 1))}, predicted {_split_eval_k1(split)}")
    if counts["gram_matvec"] == 0 or by_shape.get((N_TEST, N_TRAIN, 1), (0,))[0] != 1:
        failures.append(f"K1 launches {counts}, by shape {by_shape}")
    if failures:
        raise RuntimeError(f"slice-driver failed: {failures}")
    return {"launches": counts["gram_matvec"], "by_shape": {f"{r}x{c} m={m}": n for (r, c, m), (n, _s) in
                                                            by_shape.items()},
            "pcg_steps": steps, "chunk_steps": split["chunk_steps"], "residual_rms": split["residual_rms"],
            "seconds": {"run": seconds, **result.seconds},
            "test_rmse": result.test_rmse, "test_nll": result.test_nll, "gaps": gaps}


# [slice-fixed]'s K1/K2 launches in one fixed-mode epoch on the JAX draws
# (15 PCG steps, 5 host batches of 3 probes): the PCG solve and its
# transposed solve 16 each (15 steps and the start from x = 0; the solve's
# parameter gradient needs no forward value, only K2), m = 1; 15 Lanczos
# steps forward and 15 in the adjoint a batch (m = 3); K2 once for the
# solve (m = 1) and once a batch (m = 45).
FIXED_EPOCH_LAUNCHES = {(N_TRAIN, N_TRAIN, 1): 32, (N_TRAIN, N_TRAIN, 3): 150, "gram_grads": 6}


def phase_slice_fixed(n_auto=16_000, partitions=(1, 8)):
    """``optim_logml_adjoints_fixed.py`` on the card: ``train.gp.run`` at the
    adj400k arguments with one epoch in ``solver_mode="fixed"`` (15 PCG
    steps) at full width, from the JAX run's initial parameters on its split
    and probes, then its evaluation through ``predict_mean_split``: the loss
    finite, ``cg_numsteps_all`` [15], the epoch's K1/K2 launches as
    predicted (``FIXED_EPOCH_LAUNCHES``), the evaluation's K1 at N_train^2
    as its restarts and chunks predict, RMSE and NLL finite. Then at
    N_train = ``n_auto`` the fixed-mode step of ``--matvec auto`` against
    ``fused`` under ``[slice-auto]``'s gates, the spread pooled over the
    plain policies."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    print(f"[slice-fixed] train.gp.run(solver_mode='fixed') at the adj400k arguments, 1 epoch at N_train={N_TRAIN}, "
          f"d=8, 15 fixed PCG steps, 15 Lanczos x 15 probes in 5 host batches, from the JAX run's initial parameters "
          f"on its split and probes; then predict_mean_split and mll_eval on the test set; then fixed mode "
          f"auto vs fused at N_train={n_auto}", flush=True)
    by_shape = {}
    launch, tallied = _tallied_k1(by_shape)
    failures = []
    with tempfile.TemporaryDirectory() as out:
        args = _adj400k_args("--num_epochs", "1", "--out", out)
        fg.gram_matvec_rows = tallied
        native.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = train_gp.run(args, solver_mode="fixed", params0=train_gp.ADJ400K_INIT,
                                  draws=train_gp.JaxDraws(device=DEVICE))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            fg.gram_matvec_rows = launch
    counts = _launches(("gram_matvec", "gram_grads"))
    series, split = result.series, result.predict_info
    loss, steps = series["loss_curve"], series["cg_numsteps_all"]
    epoch_s = series["loss_timestamps"][0]
    print(f"  epoch 0: loss {loss[0]:.8f} cg_steps {steps} cg_error {series['cg_errors'][0]:.3e} slq_std_rel "
          f"{series['slq_std_rels'][0]:.6e} skipped {series['notfinite_curve'][0]}; epoch {epoch_s:.2f} s", flush=True)
    print(f"  test RMSE {result.test_rmse:.6f}, NLL {result.test_nll:.6f}; {_split_eval_line(split)}; wall: run "
          f"{seconds:.2f} s, predict_mean_split {result.seconds['predict_mean']:.2f} s, mll_eval "
          f"{result.seconds['mll_eval']:.2f} s", flush=True)
    for (rows, cols, m), (count, secs) in sorted(by_shape.items()):
        print(f"  K1 {rows} x {cols} m={m}: {count} launches, {secs:.3f} s (synchronised)", flush=True)
    want = {**FIXED_EPOCH_LAUNCHES}
    want[(N_TRAIN, N_TRAIN, 1)] += _split_eval_k1(split)
    got = {key: by_shape.get(key, (0,))[0] for key in want if key != "gram_grads"}
    got["gram_grads"] = counts["gram_grads"]
    print(f"  launches: K1 {counts['gram_matvec']}, K2 {counts['gram_grads']}; at N_train^2 and K2 {got} "
          f"(predicted {want}: the epoch's {FIXED_EPOCH_LAUNCHES} and the evaluation's {_split_eval_k1(split)})",
          flush=True)
    if not np.isfinite(loss).all() or steps != [15]:
        failures.append(f"loss {loss}, cg_numsteps_all {steps}")
    if got != want or by_shape.get((N_TEST, N_TRAIN, 1), (0,))[0] != 1:
        failures.append(f"launches {got} (predicted {want}), by shape {by_shape}")
    if not (np.isfinite(result.test_rmse) and np.isfinite(result.test_nll)):
        failures.append(f"RMSE {result.test_rmse}, NLL {result.test_nll}")
    report = _auto_against_fused(n_auto, partitions, "fixed", pooled_spread=True)
    failures += [f"fixed, auto at {parts} partitions" for parts, row in report.items() if not row["ok"]]
    if failures:
        raise RuntimeError(f"slice-fixed failed: {failures}")
    return {"loss": loss[0], "epoch_s": epoch_s, "seconds": {"run": seconds, **result.seconds},
            "chunk_steps": split["chunk_steps"], "residual_rms": split["residual_rms"],
            "test_rmse": result.test_rmse, "test_nll": result.test_nll, "auto": report}


def phase_parity_dgrads(rows=(3001, 2777), kinds=("rbf", "matern12", "matern32"),
                        dims=(1, 8, 12, 40, 65, 130)):
    """K3 against its plain version at [parity]'s rows, bit for bit across
    two runs, at m = 1 (no contraction), 8 (one k-step), 15 (padded to 16
    by the wrapper), 225 (the SLQ adjoint's width) and 400 (U re-staged);
    the Function's x and y gradients (K3 twice) against autograd through
    the plain matvec. The cases m = 8, 15 and 400 draw from their own
    generator, so that the other checks keep their inputs."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg

    print("[parity-dgrads] K3 vs its plain version on the card", flush=True)
    failures = []
    rng = np.random.default_rng(10)
    extra_rng = np.random.default_rng(11)
    n, n_cols = rows
    for kind in kinds:
        tol = TOL_K3[kind]
        for d in dims:
            x, y = _tensor(rng, (n, d)), _tensor(rng, (n_cols, d))
            ell = torch.tensor(rng.uniform(0.5, 2.0, d) * _wide_scale(d), dtype=torch.float32,
                               device=DEVICE)
            xs, ys = fg.kernel_rows(x, ell, kind), fg.kernel_rows(y, ell, kind)
            for m in (1, 8, 15, 225, 400):
                gen = rng if m in (1, 225) else extra_rng
                v, u = _tensor(gen, (n_cols, m)), _tensor(gen, (n, m))
                got = fg.gram_dgrads_rows(kind, xs, ys, v, u)
                again = fg.gram_dgrads_rows(kind, xs, ys, v, u)
                want = fg.gram_dgrads_plain(kind, xs, ys, v, u)
                torch.cuda.synchronize()
                tag = f"K3 {kind} d={d} m={m}"
                _report(tag, _rel_err(got, want), tol, failures)
                if not torch.equal(got, again):
                    print(f"  {tag}: two runs differ FAIL", flush=True)
                    failures.append(f"{tag} bitwise")
            # The Function's data gradients (rectangular, m = 15) against
            # autograd through the plain composition.
            v, u = _tensor(rng, (n_cols, 15)), _tensor(rng, (n, 15))
            out_s = torch.tensor(1.3, device=DEVICE)
            grads = []
            for fn in (fg.gram_matvec_fused(kind, data_grads=True),
                       functools.partial(fg.gram_matvec_reference, kind)):
                args = [x.clone().requires_grad_(), y.clone().requires_grad_()]
                grads.append(torch.autograd.grad(fn(*args, v, ell, out_s), args, u))
            torch.cuda.synchronize()
            for name, a, b in zip(("dx", "dy"), *grads):
                _report(f"K3 vjp {name} {kind} d={d} m=15", _rel_err(a, b), tol, failures)
    print("  K3 bitwise across two runs at every shape: "
          f"{not any(f.endswith('bitwise') for f in failures)}", flush=True)
    if failures:
        msg = f"{len(failures)} K3 parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _dgrads_step(stack, params, X, y, key):
    """The negative MLL and its gradient in the flat parameters and the inputs."""
    p = params.clone().requires_grad_()
    xs = X.clone().requires_grad_()
    value, info = stack.mll_lanczos(p, key, xs, y)
    dp, dx = torch.autograd.grad(value, [p, xs])
    return value.detach(), dp, dx, info


def phase_slice_dgrads(n_train, n_oracle=2048):
    """The GP step differentiated in the parameters and the training inputs
    (``gram_matvec_fused(data_grads=True)``): at N = 2,048 against the plain
    policy, then one step at the reference's largest configuration."""
    from lanczos_adjoints_tpu_torch.ops import gram, native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    print(f"[slice-dgrads] N={n_oracle}: input gradients, kernels vs plain versions", flush=True)
    X, y = _data(n_oracle, seed=0)
    rng = np.random.default_rng(0)
    params = torch.tensor(np.concatenate([[0.0], rng.uniform(0.0, 1.0, 8), [0.5], [-1.0]]),
                          dtype=torch.float32, device=DEVICE)
    probes = torch.tensor(rng.choice([-1.0, 1.0], size=(16, n_oracle)), dtype=torch.float32,
                          device=DEVICE)
    results = []
    for policy in (gram.gram_matvec_fused(data_grads=True), _plain_policy()):
        stack = train_gp.assemble(
            n_train=n_oracle, ndim=8, num_matvecs=20, num_samples=16, rank_precon=128,
            precon_block=64, cg_tol=1e-4, cg_rtol=1e-4, cg_maxiter=100, cg_miniter=2,
            sample=lambda _key: probes, matvec=policy, device=DEVICE,
        )
        results.append(_dgrads_step(stack, params, X, y, None))
        torch.cuda.synchronize()
    failures = []
    for label, i in (("parameters", 1), ("inputs", 2)):
        err = _rel_err(results[0][i], results[1][i])
        finite = bool(torch.isfinite(results[0][i]).all())
        print(f"  gradient in the {label}: kernels vs plain max err {err:.2e} of the largest entry "
              f"(tol 1e-03), finite {finite}, max |grad| {float(results[1][i].abs().max()):.4e}",
              flush=True)
        if not (err <= 1e-3 and finite):
            failures.append(label)
    print(f"  loss: kernels {results[0][0].item():.7f} vs plain {results[1][0].item():.7f}")
    if failures:
        raise RuntimeError(f"input-gradient oracle failed: {failures}")

    X, y = _data(n_train)
    stack = train_gp.assemble(n_train=n_train, ndim=8, matvec=gram.gram_matvec_fused(data_grads=True),
                              device=DEVICE)
    print(f"[slice-dgrads] one step in the parameters and the inputs: matern32 ARD, N_train={n_train}, "
          f"d=8, 15 Lanczos x 15 probes, PCG atol=1.0 miniter=10 maxiter=25, rank {stack.rank}",
          flush=True)
    params = torch.randn(stack.num_params, generator=torch.Generator().manual_seed(1)).to(DEVICE)
    key = torch.Generator(device=DEVICE).manual_seed(1)
    names = ("gram_matvec", "gram_grads", "gram_dgrads")
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, dp, dx, info = _dgrads_step(stack, params, X, y, key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = [native.KERNELS[k].launches for k in names]
    cg_steps = int(float(info["logpdf"]["solve"]["num_steps"]))
    # K1: 15 blocked Lanczos steps forward and 15 in the adjoint (m = 15),
    # 1 + s for the forward PCG and 1 + s for the backward solve (m = 1;
    # at atol = 1.0 both stop at miniter, s = 10). K2: one wide parameter
    # VJP in the SLQ adjoint (m = 225) and one in the CG backward (m = 1).
    # K3: dx and dy in each of those two VJPs.
    predicted = [30 + 2 * (1 + cg_steps), 2, 4]
    finite = all(bool(torch.isfinite(t).all()) for t in (value, dp, dx))
    print(f"  loss {value.item():.6f} cg_steps {cg_steps} wall {seconds:.3f} s launches K1 {counts[0]} "
          f"K2 {counts[1]} K3 {counts[2]} (predicted {predicted}); gradient finite {finite}, "
          f"max |dL/dx| {float(dx.abs().max()):.4e}, shape {tuple(dx.shape)}", flush=True)
    if counts != predicted or not finite:
        raise RuntimeError(f"input-gradient step failed (launches {counts}, finite {finite})")
    return {"launches": counts, "per_step": [counts], "step_s": [seconds]}


def _cell_ops(kernel, m, d=8):
    """(fp32 operations, contraction operations) per cell: distance 3d,
    Matern-3/2 value 5 (K1), value and derivative plus the weighted sums
    5d + 9 (K2) or the derivative and the moments 5d + 10 (K3); the
    contraction 2m. K1, and K2 and K3 for m > 1, contract on the tensor
    cores (3xTF32); K2 and K3 at m = 1 multiply once a cell on the fp32
    pipes, so their second number is 0 and the first holds it."""
    fp32 = {"K1": 3 * d + 5, "K2": 5 * d + 9, "K3": 5 * d + 10}[kernel]
    if kernel == "K1" or m > 1:
        return fp32, 2 * m
    return 2 * m + fp32, 0


def _gram_bound(kernel, cells, m, nbytes):
    """The least time for the work, whatever implements it: the larger of
    the fp32 operations at 67 TFLOP/s, the tensor-core contraction (K1; K2
    and K3 for m > 1) at the 3xTF32 rate and the bytes at 3.35 TB/s; and the
    all-fp32 bound (every operation at the fp32 rate), printed beside it
    so that earlier rows stay comparable."""
    fp32_ops, mma_ops = _cell_ops(kernel, m)
    ops = max(cells * fp32_ops / PEAK_FLOPS_FP32, cells * mma_ops / PEAK_FLOPS_3XTF32)
    old = 1e3 * max(cells * (fp32_ops + mma_ops) / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES)
    return 1e3 * max(ops, nbytes / PEAK_BYTES), "operations" if ops >= nbytes / PEAK_BYTES else "bytes", old


def phase_timing(n, slice_counts, dgrads_counts, driver, split_rows=50_000):
    """Gram kernel and plain times at the GP slices' shapes, K1 at one of
    8 row partitions (``split_rows`` x n, the column split) and at the
    posterior mean's cross shape (``N_TEST`` x n); their kernels-line
    entries, K1's with the driver's launches by shape."""
    from lanczos_adjoints_tpu_torch.ops import fused_gram as fg
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    print(f"[timing] N=M={n}, matern32, d=8 (CUDA events)", flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    X = torch.randn((n, 8), generator=g, device=DEVICE)
    ell = torch.full((8,), 0.9, device=DEVICE)
    xs = fg.kernel_rows(X, ell, "matern32")
    # The main path ([slice], 5 host batches of 3 probes) gives K1 m = 1, 3 and
    # K2 m = 1, 45; one batch of 15 probes ([slice-dgrads], [slice-mesh], the
    # driver's default) gives K1 m = 15 and K2 m = 225.
    kinds = {"K1": [1, 3, 15], "K2": [1, 45, 225], "K3": [1, 225], "K1 split": [1, 15], "K1 cross": [1]}
    row_counts = {"K1 split": split_rows, "K1 cross": N_TEST}
    shapes = {}
    for kernel, ms_ in kinds.items():
        rows = xs[:row_counts.get(kernel, n)]
        n_rows = rows.shape[0]
        for m in ms_:
            v = torch.randn((n, m), generator=g, device=DEVICE)
            u = torch.randn((n_rows, m), generator=g, device=DEVICE)
            if kernel.startswith("K1"):
                run = lambda: fg.gram_matvec_rows("matern32", rows, xs, v)  # noqa: E731
                plain = lambda: fg.gram_matvec_plain("matern32", rows, xs, v)  # noqa: E731
                nbytes = 4 * ((n_rows + n) * 8 + (n_rows + n) * m)
            elif kernel == "K2":
                run = lambda: fg.gram_grads_rows("matern32", xs, xs, v, u)  # noqa: E731
                plain = lambda: fg.gram_grads_plain("matern32", xs, xs, v, u)  # noqa: E731
                nbytes = 4 * (2 * n * 8 + 2 * n * m + -(-n // fg._GRADS_BLOCK_ROWS) * 9)
            else:
                run = lambda: fg.gram_dgrads_rows("matern32", xs, xs, v, u)  # noqa: E731
                plain = lambda: fg.gram_dgrads_plain("matern32", xs, xs, v, u)  # noqa: E731
                nbytes = 4 * (2 * n * 8 + 2 * n * m + n * 9)
            got = run()  # warm-up, and the value held against the plain one
            ms, clocks = _events_ms_clocked(run, 2)
            # One timed plain run: it loops over thousands of row chunks,
            # so its first chunk's warm-up is lost in the total.
            want = []
            plain_ms = events_ms(lambda: want.append(plain()), 1)
            want = want[0]
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            bound_ms, by, old_bound_ms = _gram_bound(kernel[:2], n_rows * n, m, nbytes)
            shapes[(kernel, m)] = {
                "m": m, "n_rows": n_rows, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "max_abs_err": err, "max_rel_err": rel,
                "clocks": clocks,
            }
            print(f"  {kernel} {n_rows} x {n} m={m}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({by}; all-fp32 bound {old_bound_ms:.3f} ms), max abs err {err:.3e} "
                  f"(rel {rel:.2e}); SM clock, max, power, temperature while it ran: {clocks}", flush=True)
            tol = {"K1": TOL_K1, "K2": TOL_K2, "K3": TOL_K3["matern32"]}[kernel[:2]]
            if not rel <= tol:
                raise RuntimeError(f"{kernel} m={m} disagrees with its plain version at N={n}")
            del v, u, got, want
    entries = []
    meta = {
        "K1": ("gram_matvec", "lanczos_adjoints_tpu_torch/csrc/gram_matvec.cu",
               "lanczos_adjoints_tpu/ops/pallas_gram.py:188", 3),
        "K2": ("gram_grads", "lanczos_adjoints_tpu_torch/csrc/gram_grads.cu",
               "lanczos_adjoints_tpu/ops/pallas_gram.py:214", 45),
        "K3": ("gram_dgrads", "lanczos_adjoints_tpu_torch/csrc/gram_dgrads.cu",
               "lanczos_adjoints_tpu/ops/pallas_gram.py:297", 225),
    }
    for idx, (kernel, (name, source, replaces, main_m)) in enumerate(meta.items()):
        main = shapes[(kernel, main_m)]
        # K1/K2 on the main path: the training steps; K3: the input-gradient step.
        counts = dgrads_counts if kernel == "K3" else slice_counts
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts["launches"][idx],
            "launches_per_step": [c[idx] for c in counts["per_step"]],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "n": n, "m": main_m,
            "by_m": [shapes[(kernel, m)] for m in kinds[kernel]],
        }
        if kernel == "K1":
            entry["split"] = [shapes[("K1 split", m)] for m in kinds["K1 split"]]
            entry["cross"] = [shapes[("K1 cross", m)] for m in kinds["K1 cross"]]
            entry["launches_driver"] = driver["launches"]
            entry["launches_driver_by_shape"] = driver["by_shape"]
        entries.append(entry)
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


def _symmetric_dia(rng, offsets, n):
    """A symmetric DIA operator on ``offsets`` (closed under negation), its
    values made on the card: N(0, 0.3^2) off the diagonal, each negative
    offset's row the circular transpose of its positive one's, and
    4 + U(0, 1) on the diagonal where one is stored. ``(DIAData, vals)``."""
    offsets = tuple(sorted(offsets))
    rows = {}
    for d in offsets:
        if d > 0:
            rows[d] = 0.3 * _tensor(rng, n)
            rows[-d] = torch.roll(rows[d], d)
        elif d == 0:
            rows[0] = 4.0 + torch.tensor(rng.random(n), dtype=torch.float32, device=DEVICE)
    return _dia(offsets, n), torch.stack([rows[d] for d in offsets]).contiguous()


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
    """K4, K4 on the transpose (autograd backward) and K5 against their plain
    versions, on 3 to 100 diagonals."""
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
            ("65 diagonals random", WIDE_65, None),
            ("100 diagonals random", WIDE_100, None),
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
    # K7's other plans (ops/fused_lanczos.py adjoint_plan; the cases above
    # take dvals resident and the state in registers): dvals streamed at 65
    # diagonals and at 100 spread over +-250,150, offsets that reach half
    # way round, and the state in device memory (more than 16 rows a
    # thread) with dvals resident and streamed.
    rng = np.random.default_rng(14)
    wide = tuple(5_003 * k for k in range(-50, 51) if k)
    half = (-(1 << 19) + 3, 0, (1 << 19) - 3)
    for name, offsets, n, depth in (("65 diagonals", WIDE_65, 1 << 20, 30),
                                    ("100 diagonals +-250,150", wide, 1 << 20, 12),
                                    ("offsets +-(2^19 - 3)", half, 1 << 20, 12),
                                    ("tridiagonal", (-1, 0, 1), 1_200_000, 12),
                                    ("tridiagonal", (-1, 0, 1), 3_000_000, 12)):
        dia, vals = _symmetric_dia(rng, offsets, n)
        yield f"{name} n={n} K={depth}", dia, vals, _tensor(rng, n), depth
    # K6's grid path with at most 4 rows a thread (n from 16,385 to about
    # 270,000): the 256 x 256 Laplacian, with its window of x, and 65
    # diagonals 1,001 apart, whose window does not fit beside the values.
    _mat, dia, vals = _laplacian(256)
    yield f"laplacian n={256 * 256} K={DEPTH}", dia, vals, _tensor(rng, 256 * 256), DEPTH
    dia, vals = _symmetric_dia(rng, tuple(1_001 * k for k in range(-32, 33)), 1 << 16)
    yield f"65 diagonals 1,001 apart n={1 << 16} K=30", dia, vals, _tensor(rng, 1 << 16), 30


# K7's plans that [parity-lanczos] must reach: (dvals path, state).
K7_PLANS = {("resident", "registers"), ("streamed", "registers"),
            ("resident", "device"), ("streamed", "device")}
# K6's plans that [parity-lanczos] must reach, one for each instantiation
# the planner can pick: (path, rows a thread keeps in registers (0: the
# state in device memory), a window of x, values). The grid path with 16
# slots and a window (1024^2, offsets +-(2^19 - 3)) or without, some of
# the values in device memory (65 and 100 diagonals at 2^20); with the
# state in device memory and a window (1.2M) or without (3M); with 4 slots
# and a window (256^2) or without (65 diagonals 1,001 apart at 65,536);
# the cluster path (16,384, 4,736, 4,739, exhausted).
K6_PLANS = {("grid", 16, True, "resident"), ("grid", 16, False, "streamed"),
            ("grid", 0, True, "resident"), ("grid", 0, False, "streamed"),
            ("grid", 4, True, "resident"), ("grid", 4, False, "resident"),
            ("cluster", 4, True, "resident")}


def _k7_plan(offsets, n, depth):
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl
    from lanczos_adjoints_tpu_torch.ops import native

    return fl.adjoint_plan(n, depth, *native.device_limits(DEVICE), num_diags=len(offsets))


def _k6_plan(offsets, n, depth):
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl
    from lanczos_adjoints_tpu_torch.ops import native

    return fl.forward_plan(n, depth, *native.device_limits(DEVICE), offsets=offsets)


def _k6_plan_line(plan):
    return (f"{plan.path} path, {plan.values} values ({plan.resident_diags} of {plan.num_diags} diagonals "
            f"on chip), x {f'from a window of {plan.window} rows' if plan.window else 'from device memory'}, "
            f"state in {f'registers ({plan.slots} slots)' if plan.slots else 'device memory'}, "
            f"{plan.blocks} blocks of {plan.threads} threads, {plan.rows} rows a block")


def phase_parity_lanczos():
    """K6 and K7 against their plain versions, tolerances from the f32-vs-f64
    spread, on every plan of K6 and K7; each twice on the same inputs, bit
    for bit."""
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl

    print("[parity-lanczos] fused Lanczos kernels vs plain versions on the card", flush=True)
    failures, plans, k6_plans = [], set(), set()
    rng = np.random.default_rng(5)
    for name, dia, vals, v0, depth in _lanczos_cases():
        offsets, n = dia.offsets, dia.shape[0]
        k6 = _k6_plan(offsets, n, depth)
        k6_plans.add((k6.path, k6.slots, bool(k6.window), k6.values))
        print(f"  K6 {name}: {_k6_plan_line(k6)}", flush=True)
        plan = _k7_plan(offsets, n, depth)
        plans.add((plan.path, plan.state))
        print(f"  K7 {name}: {plan.path} dvals ({plan.resident_diags} of {plan.num_diags} diagonals "
              f"on chip), state in {plan.state}, "
              f"{plan.blocks} blocks of {plan.threads} threads, {plan.rows} rows a block", flush=True)
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
    if plans < K7_PLANS:
        failures.append(f"K7 plans not reached: {sorted(K7_PLANS - plans)}")
    if k6_plans < K6_PLANS:
        failures.append(f"K6 plans not reached: {sorted(K6_PLANS - k6_plans)}")
    _k6_bitwise(failures)
    _k7_bitwise(failures)
    if failures:
        msg = f"{len(failures)} Lanczos parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _k6_bitwise(failures):
    """K6 twice on the same inputs at the 1024 x 1024 Laplacian (the grid
    path) and at the 128 x 128 one (the cluster path), K = 90."""
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl

    rng = np.random.default_rng(16)
    for m in (GRIDS[-1], GRIDS[0]):
        _mat, dia, vals = _laplacian(m)
        n = dia.shape[0]
        v0 = _tensor(rng, n)
        first = fl.lanczos_forward_rows(dia.offsets, vals, v0, DEPTH)
        second = fl.lanczos_forward_rows(dia.offsets, vals, v0, DEPTH)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        print(f"  K6 n={n} K={DEPTH} ({_k6_plan(dia.offsets, n, DEPTH).path} path): two runs bit for bit {same}",
              flush=True)
        if not same:
            failures.append(f"K6 bitwise n={n}")


def _k7_bitwise(failures):
    """K7 twice on the same inputs at the 1024 x 1024 Laplacian, K = 90."""
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl

    rng = np.random.default_rng(15)
    _mat, dia, vals = _laplacian(GRIDS[-1])
    n = dia.shape[0]
    xs, alphas, betas = fl.lanczos_forward_rows(dia.offsets, vals, _tensor(rng, n), DEPTH)
    cot = _cotangent(rng, DEPTH, n)
    args = (xs, alphas, betas, 1.0 / torch.linalg.vector_norm(xs[0]),
            torch.cat([cot[0], cot[3][None]]), cot[1], torch.cat([cot[2], cot[4][None]]))
    first = fl.lanczos_adjoint_rows(dia.offsets, vals, *args)
    second = fl.lanczos_adjoint_rows(dia.offsets, vals, *args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  K7 n={n} K={DEPTH}: two runs bit for bit {same}", flush=True)
    if not same:
        failures.append(f"K7 bitwise n={n}")


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


def _profiled(fn):
    """``device_profile(fn)``, with the profiler's launch count of each of the
    port's kernels printed beside the registry's for the same run, and a
    line of its own for each kernel the profiler missed launches of."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.utils.timing import device_profile, launch_report

    before = native.launch_counts()
    wall_ms, kernels = device_profile(fn)
    launched = {k: c - before[k] for k, c in native.launch_counts().items()}
    report, missed = launch_report(kernels, launched, native.device_symbols())
    print("    launches (profiler / registry): "
          + ("; ".join(f"{sym} {seen} / {count}" for sym, (seen, count) in report.items()) or "none"),
          flush=True)
    for sym in missed:
        seen, count = report[sym]
        print(f"    LAUNCH COUNT MISMATCH {sym}: the profiler saw {seen} of {count} launches; this "
              f"run's device busy time is a lower bound, its idle share an upper bound", flush=True)
    return wall_ms, kernels, {"launches": report, "missed": missed}


def _print_profile(label, fn):
    """One run of ``fn`` under the profiler: device busy time, idle share, top kernels."""
    print(f"  profile {label}:", flush=True)
    wall_ms, kernels, launches = _profiled(fn)
    if not kernels:
        print(f"  profile {label}: the profiler saw no device activity; device time not measured")
        return None
    busy = sum(t for _count, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    bound = " (busy a lower, idle an upper bound: launches missed)" if launches["missed"] else ""
    print(f"  profile {label} (one run under torch.profiler): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1.0 - busy / wall_ms:.3f}{bound}; top: "
          + "; ".join(f"{_short(name)} x{c} {t:.3f} ms" for name, (c, t) in top), flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "top": [[_short(name), c, t] for name, (c, t) in top], "kernels": kernels, **launches}


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
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

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
    _wall, kernels, _counts = _profiled(lambda: [run() for _ in range(reps)])
    ms_device = _per_launch_ms(kernels, symbol)
    ms = ms_device if ms_device is not None else ms_events
    library_ms = library_events = None
    if library is not None:
        lib = _rotating(library)
        lib()
        library_events = events_ms(lib, reps)
        # Device time of the whole call (all its kernels), as for K4.
        _wall, lib_kernels, _counts = _profiled(lambda: [lib() for _ in range(reps)])
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


def _k6_traffic(n, num_diags, depth, plan):
    """K6's bytes: each array once (what the function must move; the
    bound), the parent kernel's schedule and this one's. The parent's three
    sweeps a step moved (D + 8) vectors of 4n bytes (the values re-read, a
    work vector written, read and re-written, x read twice more and x_prev
    once, the basis row written; the D shifted reads of x counted once).
    This schedule's grid path moves 3 a step (r written, its D shifted
    reads counted once, the basis row written), its cluster path 1 (the
    basis row: r stays in shared memory), each one more for every diagonal
    of the values not in shared memory; and once the resident values, v0
    and basis row 0. Printed beside the bound, never part of the kernels
    line."""
    per_step = (3 if plan.path == "grid" else 1) + num_diags - plan.resident_diags
    return {"bytes_once": 4 * (num_diags + 1 + depth + 1) * n,
            "bytes_parent_schedule": 4 * depth * (num_diags + 8) * n,
            "bytes_schedule": 4 * (depth * per_step + plan.resident_diags + 2) * n}


def _k7_traffic(n, num_diags, depth, plan):
    """K7's bytes: each array once (what the function must move; the
    bound), the parent kernel's schedule and this one's. The parent's three
    sweeps a step moved (16 + 3D) vectors of 4n bytes (x, x_next, xi and
    lam_next re-read in each sweep, xi written twice, lam written and read
    back, dx, the values, the dvals read-modify-write; the D shifted reads
    of lam counted once, as cache-served). This schedule moves x and dx
    read, lam written and read back (its D shifted reads counted once), the
    read-modify-write of the diagonals of dvals that stay in device memory,
    and the values (D vectors) unless L2 holds them. Printed beside the
    bound, never part of the kernels line."""
    once = 4 * (2 * (depth + 1) + 2 * num_diags + 1) * n
    parent = 4 * depth * (16 + 3 * num_diags) * n
    step = 4 * n + 2 * (num_diags - plan.resident_diags) * n
    rest = once - 4 * 2 * (depth + 1) * n  # the values once, dvals and dv written
    return {"bytes_once": once, "bytes_parent_schedule": parent,
            "bytes_schedule_vals_in_l2": 4 * depth * step + rest,
            "bytes_schedule": 4 * depth * (step + num_diags * n) + rest - 4 * num_diags * n}


def _k5_library(row, offsets, sets, failures, reps=32):
    """K5's library time: ``u * x[idx]``, one gather of x by a precomputed
    (D, n) index ``(i + d_k) mod n`` and one multiply (two PyTorch calls; no
    single call computes dvals), beside K5, each over ``sets`` (L2-cold) by
    ``utils.timing.device_seconds`` (events behind a held stream). The
    library result must equal K5's bit for bit (one float32 product a slot
    on both sides). Sets the row's ``library_ms``."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.utils.timing import device_seconds

    n = sets[0][0].shape[0]
    idx = (torch.arange(n, device=DEVICE)[None, :]
           + torch.tensor(offsets, device=DEVICE)[:, None]).remainder(n)
    kernel = _rotating([lambda s=s: fd.dia_dvals_rows(offsets, s[0], s[2]) for s in sets])
    library = _rotating([lambda s=s: s[2] * s[0][idx] for s in sets])
    x, u = sets[0][0], sets[0][2]
    same = torch.equal(u * x[idx], fd.dia_dvals_rows(offsets, x, u))
    kernel(), library()
    k5_s, k5_clock = device_seconds(kernel, reps=reps, device=DEVICE)
    lib_s, lib_clock = device_seconds(library, reps=reps, device=DEVICE)
    row.update(library_ms=1e3 * lib_s, library_call="u * x[idx]: a gather by a precomputed (D, n) index, then a "
               "multiply", library_clock=lib_clock, ms_held_l2_cold=1e3 * k5_s, ms_held_clock=k5_clock)
    print(f"  K5 library u * x[idx] (two calls, the index precomputed): {1e3 * lib_s:.4f} ms ({lib_clock}); K5 "
          f"{1e3 * k5_s:.4f} ms ({k5_clock}), both L2-cold over {len(sets)} operand sets behind a held stream, "
          f"{reps} calls; equal to K5 bit for bit {same}", flush=True)
    if not same:
        failures.append("K5 library")


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
    _k5_library(rows[("K5", n)], offsets, sets, failures)
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
        k6 = _k6_plan(offsets, n, DEPTH)
        traffic = _k6_traffic(n, num_diags, DEPTH, k6)
        gb, ms = ({key: v / 1e9 for key, v in traffic.items()},
                  {key: 1e3 * v / PEAK_BYTES for key, v in traffic.items()})
        print(f"    K6 n={n} ({_k6_plan_line(k6)}): each array once {gb['bytes_once']:.4f} GB "
              f"({ms['bytes_once']:.4f} ms at 3.35 TB/s); the parent's schedule "
              f"{gb['bytes_parent_schedule']:.4f} GB ({ms['bytes_parent_schedule']:.4f} ms); this schedule "
              f"{gb['bytes_schedule']:.4f} GB ({ms['bytes_schedule']:.4f} ms); K6 at "
              f"{100 * ms['bytes_schedule'] / rows[('K6', n)]['ms']:.1f} % of this schedule's floor", flush=True)
        plan = _k7_plan(offsets, n, DEPTH)
        traffic = _k7_traffic(n, num_diags, DEPTH, plan)
        gb, ms = ({key: v / 1e9 for key, v in traffic.items()},
                  {key: 1e3 * v / PEAK_BYTES for key, v in traffic.items()})
        print(f"    K7 n={n} ({plan.path} dvals, state in {plan.state}): each array once "
              f"{gb['bytes_once']:.3f} GB ({ms['bytes_once']:.4f} ms at 3.35 TB/s); the parent's schedule "
              f"{gb['bytes_parent_schedule']:.3f} GB ({ms['bytes_parent_schedule']:.4f} ms); "
              f"this schedule {gb['bytes_schedule']:.3f} GB ({ms['bytes_schedule']:.4f} ms), "
              f"{gb['bytes_schedule_vals_in_l2']:.3f} GB ({ms['bytes_schedule_vals_in_l2']:.4f} ms) "
              f"with the values held in L2; K7 at {100 * ms['bytes_schedule'] / rows[('K7', n)]['ms']:.1f} % "
              f"of this schedule's floor", flush=True)
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
# (n, K, reortho) of [parity-arnoldi] on K9's streamed path beyond the main
# path's n = 1,000,000: n = 317^2 (odd, so 4-byte copies); K = 250 at 512^2
# (tiles of about 100 rows), its v0 a view 4 bytes past a 16-byte boundary
# (the wrapper copies it for the bulk copies). Their inputs come from their
# own generator, so every earlier case keeps its inputs.
ARNOLDI_STREAMED = ((100_489, 90, "full"), (262_144, 250, "full"))
ARNOLDI_MISALIGNED = 262_144  # the n of the case above whose v0 is misaligned
# K = 1,000 at 96^2: K9's streamed steps from 837 on would stage tiles of
# fewer than 32 rows, so the launch takes the direct path, whose sweeps read
# the basis from device memory. So deep a basis
# diverges from its plain version (their f32-vs-f64 spread is O(1)), so the
# kernel is held to the plain version on the leading ARNOLDI_DEEP_LEAD
# columns and, over all columns, to the Arnoldi relation and the basis's
# orthonormality, each within 10x the plain version's own (floor 1e-6).
ARNOLDI_DEEP, ARNOLDI_DEEP_LEAD = (9_216, 1_000, "full"), 100
# The same case through K9's C entry with a plan made for a block of
# ARNOLDI_SMALL_SMEM bytes of shared memory: too few for the 2 x 1,000
# coefficients, so the direct path keeps them in device memory (the plan
# for a depth whose coefficients outgrow the card's shared memory).
ARNOLDI_SMALL_SMEM = 12_000
# (n, K, reortho, offsets) of [parity-arnoldi] beyond 64 diagonals: 100
# resident at 128^2, 65 streamed at 2^20.
ARNOLDI_WIDE = ((16_384, 12, "full", WIDE_100), (1 << 20, 30, "full", WIDE_65))
# (n, K, reortho) at which K9 must give the same bits in two runs: the
# main path's streamed shape and the deepest resident one.
ARNOLDI_BITWISE = ((1_000_000, 90, "full"), (16_384, 250, "full"))
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
    rng = np.random.default_rng(12)
    for n, depth, reortho in ARNOLDI_STREAMED:
        _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
        v0, name = _tensor(rng, n), f"laplacian n={n} K={depth} {reortho}"
        if n == ARNOLDI_MISALIGNED:
            held = torch.empty(n + 1, device=DEVICE)
            held[1:] = v0
            v0, name = held[1:], name + " (v0 misaligned)"
            assert v0.data_ptr() % 16 == 4 and v0.is_contiguous()
        yield name, dia, vals, v0, depth, reortho, False
    n, depth, reortho = ARNOLDI_DEEP
    _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
    yield f"laplacian n={n} K={depth} {reortho}", dia, vals, _tensor(rng, n), depth, reortho, "deep"
    rng = np.random.default_rng(16)
    for n, depth, reortho, offsets in ARNOLDI_WIDE:
        dia, vals = _symmetric_dia(rng, offsets, n)
        yield (f"{len(offsets)} diagonals n={n} K={depth} {reortho}", dia, vals, _tensor(rng, n),
               depth, reortho, False)


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

    from lanczos_adjoints_tpu_torch.ops import native

    print("[parity-arnoldi] fused Arnoldi kernel vs plain version on the card", flush=True)
    failures = []
    rng = np.random.default_rng(8)
    for name, dia, vals, v0, depth, reortho, exhausted in _arnoldi_cases():
        offsets, n = dia.offsets, dia.shape[0]
        kernel = fa.hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)
        plain = fa.hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)
        torch.cuda.synchronize()
        if exhausted == "deep":
            exact = fa.hessenberg_dia_forward_plain(offsets, vals.double(), v0.double(), depth, reortho)
            limits = native.device_limits(DEVICE)
            plan = fa.launch_plan(n, depth, reortho, *limits, num_diags=len(offsets))
            _k9_deep(name, offsets, vals, kernel, plain, exact, plan, failures)
            # The plan for a block whose shared memory cannot hold the
            # coefficients: the same case, its coefficients in device memory.
            small = fa.launch_plan(n, depth, reortho, limits[0], ARNOLDI_SMALL_SMEM, num_diags=len(offsets))
            kernel = fa.launch_forward(offsets, vals, v0, reortho, small)
            torch.cuda.synchronize()
            _k9_deep(f"{name}, {ARNOLDI_SMALL_SMEM} B of shared memory a block", offsets, vals, kernel,
                     plain, exact, small, failures)
            if small.coef_floats == 0:
                failures.append(f"K9 {name}: the coefficients stayed in shared memory")
            del kernel, plain, exact
            continue
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
    _k9_bitwise(failures)
    if failures:
        msg = f"{len(failures)} Arnoldi parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _arnoldi_invariants(offsets, vals, q, h, res):
    """(Arnoldi relation, orthonormality, zero rows) of a K9 result, in
    float64: max |A Q - H^T Q - e_{K-1} res| / max |A Q| over the (K, n)
    rows, max |Q Q^T - I| over the nonzero rows (a DGKS truncation leaves
    the rows after it zero) and the number of zero rows."""
    q, h, res, vals = q.double(), h.double(), res.double(), vals.double()
    aq = sum(vals[k] * torch.roll(q, -int(d), dims=1) for k, d in enumerate(offsets))
    rel = aq - h.T @ q
    rel[-1] -= res
    nonzero = (q.abs().amax(dim=1) > 0).double()
    orth = (q @ q.T - torch.diag(nonzero)).abs().max()
    return float(rel.abs().max() / aq.abs().max()), float(orth), int((nonzero == 0).sum())


def _k9_deep(name, offsets, vals, kernel, plain, exact, plan, failures):
    """K9 at ``ARNOLDI_DEEP`` with ``plan`` against its plain version (f32
    ``plain``, f64 ``exact``): the leading columns by the spread rule, every
    column by the invariants."""
    lead = ARNOLDI_DEEP_LEAD
    for label, pick in (("Q", lambda r: r[0][:lead]), ("H", lambda r: r[1][:lead, :lead])):
        _report_spread(f"K9 {label} {name}, leading {lead} columns, kernel vs plain",
                       _rel_err(pick(kernel), pick(plain)), _rel_err(pick(plain), pick(exact)), failures)
    got = _arnoldi_invariants(offsets, vals, *kernel[:3])
    want = _arnoldi_invariants(offsets, vals, *plain[:3])
    for label, a, b in (("Arnoldi relation", got[0], want[0]), ("orthonormality", got[1], want[1])):
        tol = _spread_tol(b)
        status = "ok" if a <= tol else "FAIL"
        print(f"  K9 {label} {name}: kernel {a:.3e}; plain f32 {b:.3e}; tol {tol:.3e} {status}", flush=True)
        if not a <= tol:
            failures.append(f"K9 {label} {name}")
    where = "device memory" if plan.coef_floats else "shared memory"
    print(f"  K9 {name}: {plan.path} path, coefficients in {where}; zero rows kernel {got[2]}, "
          f"plain {want[2]}", flush=True)
    if plan.path != "direct":
        failures.append(f"K9 {name}: the {plan.path} path, not the direct one")


def _k9_bitwise(failures):
    """K9 twice on the same inputs at ``ARNOLDI_BITWISE``: the same bits."""
    from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa
    from lanczos_adjoints_tpu_torch.ops import native

    rng = np.random.default_rng(13)
    for n, depth, reortho in ARNOLDI_BITWISE:
        _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
        v0 = _tensor(rng, n)
        first = fa.hessenberg_dia_forward_rows(dia.offsets, vals, v0, depth, reortho)
        second = fa.hessenberg_dia_forward_rows(dia.offsets, vals, v0, depth, reortho)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        plan = fa.launch_plan(n, depth, reortho, *native.device_limits(DEVICE), num_diags=len(dia.offsets))
        print(f"  K9 n={n} K={depth} {reortho} ({plan.path}): two runs bit for bit {same}", flush=True)
        if not same:
            failures.append(f"K9 bitwise n={n} K={depth} {reortho}")
        del first, second


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


# The PDE drivers (train.pde, pde_workprecision, pde_data), held to the JAX
# drivers' CPU runs (train/pde_s1.npz) and to the committed series where
# those reproduce: (resolution, method, num_matvecs, epochs).
# 128 x 128 runs 3 of the fixture's 5 epochs, to leave the studies' phases room
# in the run's time (the width, 80 pairs at 128 x 128, is the JAX run's).
PDE_DRIVER_RUNS = ((32, "arnoldi", 4, 4), (128, "arnoldi", 10, 3), (128, "euler", 40, 3))
# 32 x 32: each loss and the learned field (over its largest value) against
# the committed series, which the JAX package reproduces on the CPU within
# 1.9e-7. 128 x 128: epoch 0 against the committed (TPU) series, every epoch
# against JAX's float32 CPU run within the larger of 1e-3 and 10x that run's
# float32-vs-float64 spread at the epoch (the loss jumps ~1e5-fold after the
# first Adam step, so rounding moves the later epochs).
TOL_PDE_COMMITTED = 1e-4
TOL_PDE_EPOCH0 = 1e-3
TOL_PDE_FLOOR = 1e-3
# The work-precision sweep at 64 x 64: float32 Arnoldi depth 4 (truncation-
# dominated) within 1 % of JAX's CPU value, every other float32 error at most
# 1e-4 (the float32 floor is ~1.2e-5); float64 within 1 % of the committed
# workprecision_x64_s1.json where that is above the float64 floor 1e-12,
# and below 1e-12 where it is not.
TOL_WP_DEPTH4 = 1e-2
WP_F32_CEILING = 1e-4
TOL_WP_F64 = 1e-2
WP_F64_FLOOR = 1e-12
# [slice-pde-diffrax]: the sweep's problem at the PDE driver's width, every
# method and adjoint of solver_diffrax at two step counts, against the port's
# RK4 with 1,024 steps (the sweep's reference step count at twice its width)
# in float64. Route and accuracy gates take _spread_tol of a float32-vs-float64
# spread (10x it, at least SPREAD_FLOOR): recursive_checkpoint against direct the spread of
# the direct solve; the float32 errors of Dopri5, Tsit5 and Dopri8 (value,
# direct and backsolve gradients) over their float64 errors at the same step
# count the spread of the reference solve (the same solve's own spread would
# make that bound hold by the triangle inequality). Their float64 errors stay
# under DIFFRAX_F64_CEILING (a wrong tableau coefficient leaves a low-order
# error far above it).
DIFFRAX_RESOLUTION = 128
DIFFRAX_STEPS = (16, 64)
DIFFRAX_REFERENCE_STEPS = 1024
DIFFRAX_ACCURATE = ("dopri5", "tsit5", "dopri8")
DIFFRAX_F64_CEILING = 1e-8
# Stable: no mode of the wave operator grows by more than this over the run.
DIFFRAX_GROWTH_TOL = 1e-3
# [study-mtx-parser]'s rows: the JAX script's 1,000,000 cut to 500,000 (a
# 104 MB file) to make room for [slice-pde-diffrax] in the run's time.
MTX_PARSER_ROWS = 500_000
# make_data at 128 x 128: RK4 from the bundled inputs and parameter misses
# the bundled targets by JAX's own miss (train/pde_s1.npz) within this.
TOL_RK4_MISS = 1e-4
# The grid search: each loss within 1e-3 of JAX's float64 CPU run, and within
# 1e-4 of its float32 CPU run less the bias of that run's ordered float32 sum
# in the Arnoldi start (train.laplace.jax_float32_dot_bias, 0.119 at every
# alpha; so corrected, JAX's float32 run is 3.0e-5 from its float64 run);
# each std within 1e-2 of the float64 run's.
TOL_GRID_LOSS = 1e-3
TOL_GRID_F32 = 1e-4
TOL_GRID_STD = 1e-2


def _pde_run(train_pde, fix, resolution, method, num_matvecs, epochs, out):
    args = train_pde.build_argparser().parse_args(
        ["--resolution", str(resolution), "--method", method, "--num_matvecs", str(num_matvecs), "--num_epochs",
         str(epochs), "--device", DEVICE, "--out", out])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_pde.run(args, fixture=fix)
    return result, time.perf_counter() - t0, sorted(f for f in os.listdir(out) if f.startswith(train_pde.label(args)))


def phase_slice_pde_driver(runs=PDE_DRIVER_RUNS):
    """``train.pde.run`` (the JAX ``train.py`` epoch loop) from the JAX run's
    flax weights at each of ``runs``: the losses against the committed series
    and JAX's float32 and float64 CPU runs, the matvecs, the learned field,
    the epoch wall times."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import pde as train_pde

    fix = train_pde.load_fixture()
    card = _card_line()
    print(f"[slice-pde-driver] train.pde.run from the JAX run's flax weights (train/pde_s1.npz) on {card}", flush=True)
    failures, results = [], {}
    native.reset_launches()
    mode = _OnCard()
    for resolution, method, num_matvecs, epochs in runs:
        name = f"{resolution}x{resolution}_{method}"
        with tempfile.TemporaryDirectory() as out, mode:
            result, wall, files = _pde_run(train_pde, fix, resolution, method, num_matvecs, epochs, out)
        conv = result["convergence"]
        jax32, jax64 = fix[f"{name}/convergence"][:epochs], fix[f"{name}/convergence_f64"][:epochs]
        committed = np.load(train_pde.JAX_TPU_RESULTS / "train" / f"{name}_s1_convergence.npy")[:epochs]
        epoch_s = np.diff(np.concatenate([[0.0], result["timestamps"]]))
        gap_tpu, gap32 = np.abs(conv / committed - 1.0), np.abs(conv / jax32 - 1.0)
        gap64, spread = np.abs(conv / jax64 - 1.0), np.abs(jax32 / jax64 - 1.0)
        print(f"  {name}, {num_matvecs} matvecs, {epochs} epochs: losses {conv.tolist()}", flush=True)
        print(f"    JAX float32 CPU {jax32.tolist()}, float64 {jax64.tolist()}, committed (TPU) {committed.tolist()}",
              flush=True)
        print(f"    rel gap to JAX f32 {gap32.tolist()}, to JAX f64 {gap64.tolist()}, to the committed series "
              f"{gap_tpu.tolist()}; JAX f32-vs-f64 spread {spread.tolist()}", flush=True)
        print(f"    epoch wall s {np.round(epoch_s, 4).tolist()} (run {wall:.2f} s, first epoch with warm-up; {card}); "
              f"matvecs {result['matvecs'].tolist()}; files {files}", flush=True)
        if len(files) != 4:
            failures.append(f"{name} wrote {files}")
        if not np.array_equal(result["matvecs"], fix[f"{name}/matvecs"][:epochs]):
            failures.append(f"{name} matvecs")
        if not np.all(np.isfinite(conv)):
            failures.append(f"{name} non-finite loss")
        field = result["scale_field"]
        field_jax = fix[f"{name}/scale_field"]
        field_gap = float(np.max(np.abs(field - field_jax)) / np.max(np.abs(field_jax)))
        if resolution == 32:
            field_tpu = np.load(train_pde.JAX_TPU_RESULTS / "train" / f"{name}_s1_scale_field.npy")
            field_gap = float(np.max(np.abs(field - field_tpu)) / np.max(np.abs(field_tpu)))
            ok = bool(np.all(gap_tpu <= TOL_PDE_COMMITTED)) and field_gap <= TOL_PDE_COMMITTED
            print(f"    each loss within {TOL_PDE_COMMITTED:.0e} of the committed series: {bool(np.all(gap_tpu <= TOL_PDE_COMMITTED))}; "
                  f"field max gap {field_gap:.3e} of its largest (tol {TOL_PDE_COMMITTED:.0e}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"{name} against the committed series")
        else:
            tol = np.maximum(TOL_PDE_FLOOR, SPREAD_FACTOR * spread)
            ok0, ok = bool(gap_tpu[0] <= TOL_PDE_EPOCH0), bool(np.all(gap32 <= tol))
            print(f"    epoch 0 within {TOL_PDE_EPOCH0:.0e} of the committed series: {ok0}; every epoch within "
                  f"{tol.tolist()} of JAX f32: {ok}; field max gap to JAX's CPU field {field_gap:.3e} of its "
                  f"largest (no gate)", flush=True)
            if not ok0:
                failures.append(f"{name} epoch 0")
            if not ok:
                failures.append(f"{name} epochs against JAX f32")
        results[name] = {"losses": conv.tolist(), "epoch_s": epoch_s.tolist(), "gap32": gap32.tolist(),
                         "gap_tpu": gap_tpu.tolist(), "field_gap": field_gap}
    mode.check("slice-pde-driver")
    _no_kernel_launched("slice-pde-driver")
    if failures:
        raise RuntimeError(f"slice-pde-driver failed: {failures}")
    return results


def phase_slice_pde_workprecision(resolution=64):
    """``train.pde_workprecision.run`` at 64 x 64 in float32 and with ``--x64``
    on the card: against JAX's float32 CPU sweep (the fixture) and the
    committed float64 ``workprecision_x64_s1.json``; the committed float32
    file (TPU) printed beside, without a gate."""
    import argparse

    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import pde as train_pde
    from lanczos_adjoints_tpu_torch.train import pde_workprecision as wp

    fix = train_pde.load_fixture()
    committed = {tag: json.loads((train_pde.JAX_TPU_RESULTS / "workprecision" / f"workprecision{tag}_s1.json")
                                 .read_text()) for tag in ("", "_x64")}
    print(f"[slice-pde-workprecision] {resolution}x{resolution}, gradient error against RK4 with "
          f"{wp.REFERENCE_STEPS} steps, float32 and float64 on the card", flush=True)
    failures, runs = [], {}
    native.reset_launches()
    mode = _OnCard()
    with tempfile.TemporaryDirectory() as out, mode:
        for x64 in (False, True):
            args = argparse.Namespace(resolution=resolution, seed=1, x64=x64, device=DEVICE, out=out)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = wp.run(args)
            torch.cuda.synchronize()
            runs["x64" if x64 else "f32"] = {"rows": rows, "s": time.perf_counter() - t0}
        files = sorted(os.listdir(out))
    mode.check("slice-pde-workprecision")
    _no_kernel_launched("slice-pde-workprecision")
    print(f"  files {files}; wall f32 {runs['f32']['s']:.2f} s, f64 {runs['x64']['s']:.2f} s", flush=True)
    keys = [(r["method"], r["num_matvecs"]) for r in runs["f32"]["rows"]]
    if keys != list(zip(fix["workprecision/method"].tolist(), fix["workprecision/num_matvecs"].tolist())):
        failures.append(f"float32 rows {keys}")
    for row, want, tpu in zip(runs["f32"]["rows"], fix["workprecision/error"], committed[""]):
        if (row["method"], row["num_matvecs"]) == ("arnoldi", 4):
            gap = abs(row["error"] / want - 1.0)
            ok, rule = gap <= TOL_WP_DEPTH4, f"rel gap {gap:.2e} (tol {TOL_WP_DEPTH4:.0e})"
        else:
            ok, rule = row["error"] <= WP_F32_CEILING, f"at most {WP_F32_CEILING:.0e}"
        print(f"  f32 {row['method']} {row['num_matvecs']:>3} matvecs: {row['error']:.4e} vs JAX CPU {want:.4e}, "
              f"{rule} {'ok' if ok else 'FAIL'}; committed TPU file {tpu['error']:.4e} (no gate)", flush=True)
        if not ok:
            failures.append(f"f32 {row['method']} {row['num_matvecs']}")
    if [(r["method"], r["num_matvecs"]) for r in runs["x64"]["rows"]] != \
            [(r["method"], r["num_matvecs"]) for r in committed["_x64"]]:
        failures.append("float64 rows")
    for row, want in zip(runs["x64"]["rows"], committed["_x64"]):
        if want["error"] > WP_F64_FLOOR:
            gap = abs(row["error"] / want["error"] - 1.0)
            ok, rule = gap <= TOL_WP_F64, f"rel gap {gap:.2e} (tol {TOL_WP_F64:.0e})"
        else:
            ok, rule = row["error"] < WP_F64_FLOOR, f"below {WP_F64_FLOOR:.0e}"
        print(f"  f64 {row['method']} {row['num_matvecs']:>3} matvecs: {row['error']:.4e} vs committed "
              f"{want['error']:.4e}, {rule} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"f64 {row['method']} {row['num_matvecs']}")
    if failures:
        raise RuntimeError(f"slice-pde-workprecision failed: {failures}")
    return runs


def _growth(tableau, h_omega, grid=4_000):
    """``max |R(i y)|`` over ``y`` in ``[0, h_omega]``: the most a step of the
    tableau amplifies a mode of the (purely oscillatory) wave operator, whose
    frequencies lie in ``[0, omega_max]``; ``R`` its stability polynomial."""
    s = tableau.stages
    a = np.zeros((s, s))
    for i, row in enumerate(tableau.a):
        a[i, :len(row)] = row
    coefs, v = [1.0], np.ones(s)
    for _ in range(s):
        coefs.append(float(np.asarray(tableau.b) @ v))
        v = a @ v
    return float(np.abs(np.polyval(coefs[::-1], 1j * np.linspace(0.0, h_omega, grid))).max())


def _grad_gap(run, other):
    """The relative gap of ``run``'s gradient to ``other``'s."""
    g = other["grad"].double()
    return float(torch.linalg.vector_norm(run["grad"].double() - g) / torch.linalg.vector_norm(g))


def _diffrax_run(solve_fn, y0, scale, vf):
    """One ``mean(u(1)^2)`` and its gradient in ``scale``: value, gradient,
    info, vector-field evaluations, ms by CUDA events, peak MiB above what
    was allocated before."""
    from lanczos_adjoints_tpu_torch.train import pde_workprecision as wp

    calls = [0]

    def counted(y, s):
        calls[0] += 1
        return vf(y, s)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    value, grad, info = wp.value_and_grad_of(solve_fn(counted), y0, scale)
    stop.record()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return {"value": value, "grad": grad, "info": info, "evals": calls[0], "ms": start.elapsed_time(stop),
            "peak_mib": peak}


def phase_slice_pde_diffrax(resolution=DIFFRAX_RESOLUTION, steps=DIFFRAX_STEPS):
    """``models.pde.solver_diffrax`` (``models/_runge_kutta.py``, no kernel) on
    the work-precision sweep's problem at ``resolution``: ``mean(u(1)^2)`` and
    its gradient in ``scale`` for each method x adjoint at ``steps``, float32
    and float64 on the card, against RK4 with ``DIFFRAX_REFERENCE_STEPS`` in
    float64; the gates of the module docstring's item 15."""
    from lanczos_adjoints_tpu_torch.models import _runge_kutta as rk
    from lanczos_adjoints_tpu_torch.models import pde
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import pde_workprecision as wp

    dtypes = {"f32": torch.float32, "f64": torch.float64}
    problems = {k: wp.problem(resolution, dtype=dt, device=DEVICE) for k, dt in dtypes.items()}
    # The wave speed is scale^2; the 5-point Laplacian's largest eigenvalue 8 / dx^2.
    omega_max = float(problems["f64"][1].max()) * math.sqrt(8.0) * (resolution - 1)
    print(f"[slice-pde-diffrax] solver_diffrax on the sweep's problem at {resolution}x{resolution} "
          f"(state 2x{resolution}x{resolution}), t * omega_max = {omega_max:.2f}, steps {steps}, against RK4 "
          f"with {DIFFRAX_REFERENCE_STEPS} steps in float64 on {_card_line()}", flush=True)
    failures, rows = [], []
    native.reset_launches()
    mode = _OnCard()
    # Not timed: the first launches of each operator, each adjoint once.
    warm_up = time.perf_counter()
    with mode:
        for adjoint in rk.ADJOINTS:
            _diffrax_run(lambda f, adjoint=adjoint: pde.solver_diffrax(0.0, 1.0, f, num_steps=2, method="heun",
                                                                       adjoint=adjoint), *problems["f32"])
    print(f"  warm-up (each adjoint once at 2 steps, not timed): {time.perf_counter() - warm_up:.2f} s", flush=True)
    with mode:
        refs = {k: _diffrax_run(lambda f, k=k: wp.rk4(DIFFRAX_REFERENCE_STEPS, f, dtype=dtypes[k], device=DEVICE),
                                *problems[k]) for k in dtypes}
    ref = refs["f64"]

    def value_err(run):
        return abs(run["value"] - ref["value"]) / abs(ref["value"])

    def grad_err(run):
        return _grad_gap(run, ref)

    ref_spread = {"value": value_err(refs["f32"]), "grad": grad_err(refs["f32"])}
    print(f"  reference RK4 x {DIFFRAX_REFERENCE_STEPS}: value {ref['value']:.10e}, float32 vs float64 spread "
          f"value {ref_spread['value']:.3e}, gradient {ref_spread['grad']:.3e}; {refs['f64']['ms']:.1f} ms "
          f"(float64), {refs['f32']['ms']:.1f} ms (float32)", flush=True)
    for method, tab in rk.TABLEAUX.items():
        for n in steps:
            growth = _growth(tab, omega_max / n) ** n
            stable = growth <= 1.0 + DIFFRAX_GROWTH_TOL
            print(f"  {method} x {n}: h * omega_max {omega_max / n:.3f}, largest growth of a mode over the run "
                  f"{growth:.6g}: {'stable' if stable else 'not stable (gated on finite values only)'}", flush=True)
            if method in DIFFRAX_ACCURATE and not stable:
                failures.append(f"{method} x {n} not stable")
    for method, tab in rk.TABLEAUX.items():
        for n in steps:
            runs = {}
            for adjoint in rk.ADJOINTS:
                for k in dtypes:
                    # Float64 runs for the spread (direct) and the accuracy gates.
                    if k == "f64" and (adjoint == "recursive_checkpoint" or
                                       (adjoint == "backsolve" and method not in DIFFRAX_ACCURATE)):
                        continue
                    with mode:
                        runs[adjoint, k] = _diffrax_run(
                            lambda f, adjoint=adjoint: pde.solver_diffrax(0.0, 1.0, f, num_steps=n, method=method,
                                                                          adjoint=adjoint), *problems[k])
            spread = _grad_gap(runs["direct", "f32"], runs["direct", "f64"])
            for adjoint in rk.ADJOINTS:
                run = runs[adjoint, "f32"]
                label = f"{method} x {n} {adjoint}"
                finite = math.isfinite(run["value"]) and bool(torch.isfinite(run["grad"]).all())
                want_evals = n * tab.stages * (1 if adjoint == "direct" else 2)
                row = {"method": method, "steps": n, "adjoint": adjoint, "ms": run["ms"], "evals": run["evals"],
                       "num_matvecs": run["info"]["num_matvecs"], "peak_mib": run["peak_mib"],
                       "value_err": value_err(run), "grad_err": grad_err(run)}
                line = (f"  {label}: {run['ms']:.1f} ms, {run['evals']} evaluations, num_matvecs "
                        f"{row['num_matvecs']}, peak {run['peak_mib']:.2f} MiB, value err {row['value_err']:.3e}, "
                        f"gradient err {row['grad_err']:.3e}")
                checks = [(finite, "finite"), (run["evals"] == want_evals, f"evaluations {want_evals}"),
                          (row["num_matvecs"] == n * tab.order, f"num_matvecs {n * tab.order}")]
                if adjoint == "recursive_checkpoint":
                    gap = _grad_gap(run, runs["direct", "f32"])
                    tol = _spread_tol(spread)
                    line += f"; vs direct {gap:.3e} (tol {tol:.3e}: 10x direct's f32-vs-f64 spread)"
                    checks.append((gap <= tol, "vs direct"))
                    if n == max(steps):
                        checks.append((run["peak_mib"] < runs["direct", "f32"]["peak_mib"], "memory below direct"))
                if adjoint == "backsolve" and n == max(steps):
                    checks.append((run["peak_mib"] < runs["direct", "f32"]["peak_mib"], "memory below direct"))
                if (adjoint, "f64") in runs:
                    run64 = runs[adjoint, "f64"]
                    row["value_err64"], row["grad_err64"] = value_err(run64), grad_err(run64)
                    line += f"; float64 value err {row['value_err64']:.3e}, gradient err {row['grad_err64']:.3e}"
                    if method in DIFFRAX_ACCURATE:
                        tol_v = row["value_err64"] + _spread_tol(ref_spread["value"])
                        tol_g = row["grad_err64"] + _spread_tol(ref_spread["grad"])
                        line += f" (float32 tol {tol_v:.3e}, {tol_g:.3e}; float64 tol {DIFFRAX_F64_CEILING:.0e})"
                        checks += [(row["value_err"] <= tol_v, "value err"), (row["grad_err"] <= tol_g, "gradient err"),
                                   (max(row["value_err64"], row["grad_err64"]) <= DIFFRAX_F64_CEILING, "float64 err")]
                    checks.append((math.isfinite(run64["value"]) and bool(torch.isfinite(run64["grad"]).all()),
                                   "float64 finite"))
                bad = [what for ok, what in checks if not ok]
                print(f"{line} {'ok' if not bad else 'FAIL ' + ', '.join(bad)}", flush=True)
                if bad:
                    failures.append(f"{label}: {', '.join(bad)}")
                rows.append(row)
    mode.check("slice-pde-diffrax")
    _no_kernel_launched("slice-pde-diffrax")
    if failures:
        raise RuntimeError(f"slice-pde-diffrax failed: {failures}")
    return rows


def phase_slice_pde_data(resolution=128, num_data=80):
    """``train.pde_data.run`` (``make_data.py``) at 128 x 128 with 80 pairs from a
    generator: the files' shapes and dtypes against the bundled ones, finite;
    then RK4 from the bundled inputs and parameter against the bundled targets,
    missing them by JAX's own miss."""
    import argparse

    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import pde as train_pde
    from lanczos_adjoints_tpu_torch.train import pde_data

    fix = train_pde.load_fixture()
    print(f"[slice-pde-data] make_data at {resolution}x{resolution}, {num_data} pairs: GRF over a "
          f"{resolution**2:,}^2 RBF covariance (Lanczos rank {pde_data.LANCZOS_RANK}), RK4 400 steps, one conv2d "
          f"a stage", flush=True)
    failures = []
    native.reset_launches()
    mode = _OnCard()
    with tempfile.TemporaryDirectory() as out:
        args = argparse.Namespace(resolution=resolution, num_data=num_data, seed=1, num_steps=400, device=DEVICE,
                                  out=out, fixture=None)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode:
            pde_data.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in ("inputs", "targets", "parameter"):
            got = np.load(f"{out}/{resolution}x{resolution}_data_{name}.npy")
            want = np.load(pde_data.DATA / f"{resolution}x{resolution}_data_{name}.npy", mmap_mode="r")
            ok = (got.dtype, got.shape) == (want.dtype, want.shape) and bool(np.all(np.isfinite(got)))
            print(f"  {name}: {got.dtype} {got.shape} (bundled {want.dtype} {want.shape}), finite "
                  f"{bool(np.all(np.isfinite(got)))}, max |.| {float(np.max(np.abs(got))):.4e} "
                  f"(bundled {float(np.max(np.abs(want))):.4e}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(name)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  make_data {wall:.2f} s wall, peak {peak:.2f} GiB", flush=True)
    misses = {}
    for n in (32, resolution):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode:
            max_rel, norm_rel, _ = pde_data.bundled_miss(n, device=DEVICE)
        torch.cuda.synchronize()
        want = fix[f"rk4_miss/{n}"]
        gaps = (abs(max_rel - want[0]), abs(norm_rel - want[1]))
        ok = max(gaps) <= TOL_RK4_MISS
        print(f"  RK4 from the bundled {n}x{n} inputs and parameter against its targets: max {max_rel:.6e} "
              f"(JAX {want[0]:.6e}), norm {norm_rel:.6e} (JAX {want[1]:.6e}), gaps {gaps[0]:.2e}, {gaps[1]:.2e} "
              f"(tol {TOL_RK4_MISS:.0e}) {'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.2f} s", flush=True)
        misses[n] = (max_rel, norm_rel)
        if not ok:
            failures.append(f"RK4 miss at {n}")
    mode.check("slice-pde-data")
    _no_kernel_launched("slice-pde-data")
    if failures:
        raise RuntimeError(f"slice-pde-data failed: {failures}")
    return {"wall_s": wall, "peak_gib": peak, "misses": misses}


def _arnoldi_ops(n, depth, passes, num_diags=5):
    """fp32 operations of K9: the Gram-Schmidt dots and updates and the matvec."""
    return 4 * passes * n * depth * (depth + 1) // 2 + 2 * num_diags * n * depth


# One H100 SXM: SMs and the shared memory a block may opt into (NVIDIA's
# Hopper tuning guide), for K9's bound.
H100_SMS, H100_SMEM_PER_BLOCK = 132, 232_448


def _arnoldi_bounds(n, depth, reortho, num_diags=5, sms=H100_SMS, smem_per_block=H100_SMEM_PER_BLOCK):
    """K9's bound, each array once (``bound_ms``: what the function must
    move), and beside it the streamed schedule's traffic where the (K, n)
    basis exceeds the card's shared memory (``bound_ms_streamed``): step i
    reads Q[:i+1] three times with re-orthogonalisation (first-pass dots;
    first update with second-pass dots; second update), twice without,
    plus each other array once. The latter credits no basis row kept on
    chip, so it is a bound of that schedule, not of the function."""
    passes = 2 if reortho == "full" else 1
    ops = _arnoldi_ops(n, depth, passes, num_diags)
    once = 4 * ((num_diags + 2 + depth) * n + depth * depth + 1)
    streamed = once + 4 * (passes + 1) * n * depth * (depth + 1) // 2
    bound_ms, by = _bound(once, ops)
    streamed_ms, streamed_by = _bound(streamed, ops)
    return {"bound_ms": bound_ms, "bound_by": by, "bound_bytes": once, "ops": ops,
            "basis_on_chip": 4 * depth * n <= sms * smem_per_block,
            "bound_ms_streamed": streamed_ms, "bound_by_streamed": streamed_by, "bytes_streamed": streamed}


def phase_timing_arnoldi(slice_runs):
    """K9's device time per launch at [parity-arnoldi]'s shapes from 16,384 up,
    beside its bound and its plain version's time; its kernels-line entry."""
    from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa
    from lanczos_adjoints_tpu_torch.ops import native

    print("[timing-arnoldi] K9 at the slice's shapes (profiler and CUDA events); library: none",
          flush=True)
    limits = native.device_limits(DEVICE)
    rows, failures = {}, []
    rng = np.random.default_rng(9)
    for n, depth, reortho in ARNOLDI_PARITY:
        if n < 16_384:
            continue
        _mat, dia, vals = _laplacian(int(round(n ** 0.5)))
        offsets, num_diags = dia.offsets, len(dia.offsets)
        v0 = _tensor(rng, n)
        bounds = _arnoldi_bounds(n, depth, reortho, num_diags)
        plan = fa.launch_plan(n, depth, reortho, *limits, num_diags=num_diags)
        print(f"  K9 n={n} K={depth} {reortho}: {plan.path} path, {plan.blocks} blocks of "
              f"{plan.block_threads} threads ({plan.threads} computing), {plan.rows} rows a block, "
              f"{plan.sweeps} sweeps a step, tile rows {plan.tile_rows(0)} at step 0 and "
              f"{plan.tile_rows(depth - 1, 'A')} (A) / {plan.tile_rows(depth - 1)} (B, C) at step "
              f"{depth - 1}, {plan.smem_bytes} B of shared memory a block (card: {limits[0]} SMs, "
              f"{limits[1]} B a block)", flush=True)
        _record(rows, failures, (n, depth, reortho), "arnoldi_forward_kernel",
                [lambda: fa.hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)],
                [lambda: fa.hessenberg_dia_forward_plain(offsets, vals, v0, depth, reortho)],
                bounds["bound_bytes"], bounds["ops"], 5 if n > 100_000 else 20, 1,
                exact=lambda: fa.hessenberg_dia_forward_plain(offsets, vals.double(), v0.double(),
                                                              depth, reortho))
        row = rows[(n, depth, reortho)]
        row.update(n=n, depth=depth, reortho=reortho, path=plan.path, blocks=plan.blocks,
                   threads=plan.threads, tile_rows_last=plan.tile_rows(depth - 1))
        sweeps = (f"; the streamed schedule ({3 if reortho == 'full' else 2} reads of Q[:i+1] a step, "
                  f"no row kept on chip) {bounds['bytes_streamed'] / 1e9:.3f} GB, "
                  f"{bounds['bound_ms_streamed']:.4f} ms, the kernel at "
                  f"{100 * bounds['bound_ms_streamed'] / row['ms']:.1f} % of it"
                  ) if not bounds["basis_on_chip"] else " (the basis fits the card's shared memory)"
        print(f"    bound {bounds['bound_ms']:.4f} ms by {bounds['bound_by']} (each array once, "
              f"{bounds['bound_bytes'] / 1e9:.3f} GB){sweeps}; launches in the main path's VJP: 1",
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


# ---------------------------------------------------------------------------
# The BSR slice: the block-ELL matvec (K10) under the Lanczos and Arnoldi VJPs
# ---------------------------------------------------------------------------

# The FEM test matrix of the JAX SpMV benchmark (spmv_formats/benchmark.py:57):
# a bcsstk-class 3-D stiffness pattern, n = 41,472, ~81 nnz a row.
BSR_GRID, BSR_DEPTH, BSR_PROBES = 24, 90, 10
# K10 vs its plain version: an output sums ~1,000 stored slots (mostly
# zero) in float32 in another order, with fused multiply-adds.
TOL_BSR = 1e-5
# The HYB route: spmv_formats/benchmark.py:37-42's random matrix, 8 entries a row.
HYB_N, HYB_PER_ROW = 65_536, 8
BSR_KERNELS = ("bsr_spmv",)


def _fem(rcm=False):
    from lanczos_adjoints_tpu_torch.ops import fused_bsr, sparse

    mat = fused_bsr.fem_test_matrix(BSR_GRID, dofs=3)
    if rcm:
        mat = sparse.permute_symmetric(mat, sparse.reverse_cuthill_mckee(mat))
    bsr = sparse.bsr_pack(mat, device=DEVICE)
    return mat, bsr, sparse.bsr_values(bsr, mat.data, device=DEVICE)


def _random_csr(n, per_row, seed=0):
    """spmv_formats/benchmark.py:37-42's random matrix."""
    from lanczos_adjoints_tpu_torch.ops import sparse

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, len(rows))
    return sparse.csr_from_coo(rows, cols, rng.normal(size=len(rows)), shape=(n, n))


def _k10_check(label, bsr, tiles, vs, packer, failures):
    """K10 on ``vs`` against both plain versions (the tile product, the JAX
    semantics, and the packed product on the same pack), bit for bit across
    two runs."""
    from lanczos_adjoints_tpu_torch.ops import fused_bsr

    errs, same = {"tile": [], "packed": []}, True
    for v in vs:
        got = fused_bsr.bsr_spmv_rows(bsr, v, tiles, packer)
        same &= torch.equal(got, fused_bsr.bsr_spmv_rows(bsr, v, tiles, packer))
        errs["tile"].append(_rel_err(got, fused_bsr.bsr_spmv_plain(bsr, v, tiles)))
        errs["packed"].append(_rel_err(got, fused_bsr.bsr_spmv_packed_plain(packer(tiles), v)))
    torch.cuda.synchronize()
    for plain, e in errs.items():
        _report(f"K10 {label} vs {plain} plain ({len(vs)} vectors, worst)", max(e), TOL_BSR, failures)
    if not same:
        print(f"  K10 {label}: two runs differ FAIL", flush=True)
        failures.append(f"K10 {label} bitwise")


def phase_parity_bsr():
    """K10 over its packed CSR view against both plain versions, and its
    Function's backward (K10 for dv, the dtiles broadcast) against the tile
    product's autograd, on the FEM matrix, its RCM permutation and a ragged
    rectangular random matrix; then tiles with values off the CSR structure
    and tiles updated in place between two calls (the cache packs again)."""
    from lanczos_adjoints_tpu_torch.ops import fused_bsr, sparse

    print("[parity-bsr] K10 vs its plain versions on the card", flush=True)
    failures = []
    rng = np.random.default_rng(11)
    rect = _random_csr(3001, 40)
    rect = sparse.csr_from_coo(rect.rows, rect.indices % 2777, rect.data, shape=(3001, 2777))
    fem = _fem()
    cases = [("fem", *fem), ("fem rcm", *_fem(rcm=True)),
             ("random 3001x2777", rect, sparse.bsr_pack(rect, device=DEVICE), None)]
    for name, mat, bsr, tiles in cases:
        if tiles is None:
            tiles = sparse.bsr_values(bsr, mat.data, device=DEVICE)
        symmetric = mat.shape[0] == mat.shape[1]
        packer = fused_bsr.BsrPacker(bsr)
        pack = packer(tiles)
        print(f"  {name}: n={mat.shape} nnz={mat.nnz} width={bsr.width} fill "
              f"{mat.nnz / bsr.num_slots:.4f} tiles {4 * bsr.num_slots / 1e6:.1f} MB; packed view "
              f"nnz={pack.nnz} structural={pack.structural} lanes/row "
              f"{fused_bsr.lanes_per_row(pack.nnz, pack.n_rows)}", flush=True)
        if pack.nnz != mat.nnz or not pack.structural:
            failures.append(f"{name} pack")
        _k10_check(name, bsr, tiles, [_tensor(rng, mat.shape[1]) for _ in range(ROTATE_SETS)],
                   packer, failures)
        v, u = _tensor(rng, mat.shape[1]), _tensor(rng, mat.shape[0])
        grads = []
        for fn in (fused_bsr.bsr_matvec_fused(bsr, symmetric=symmetric), sparse.bsr_matvec_fn(bsr)):
            args = [v.clone().requires_grad_(), tiles.clone().requires_grad_()]
            grads.append(torch.autograd.grad(fn(*args), args, u))
        torch.cuda.synchronize()
        _report(f"K10 vjp dv {name} ({'K10' if symmetric else 'scatter-add'})",
                _rel_err(grads[0][0], grads[1][0]), TOL_BSR, failures)
        _report(f"K10 vjp dtiles {name}", _rel_err(grads[0][1], grads[1][1]), TOL_BSR, failures)
        del tiles, grads, pack, packer

    # Values off the structure: a dense update in 1 % of every tile's slots
    # (padded slots, padded rows and columns past the last one included).
    mat, bsr, tiles = fem
    g = torch.Generator(device=DEVICE).manual_seed(11)
    update = torch.randn(tiles.shape, generator=g, device=DEVICE) * (
        torch.rand(tiles.shape, generator=g, device=DEVICE) < 0.01)
    updated = tiles + update
    packer = fused_bsr.BsrPacker(bsr)
    pack = packer(updated)
    print(f"  fem + off-structure update: packed view nnz={pack.nnz} (structure {mat.nnz}) "
          f"structural={pack.structural}", flush=True)
    if pack.structural or pack.nnz <= mat.nnz:
        failures.append("off-structure pack")
    _k10_check("fem off-structure", bsr, updated, [_tensor(rng, mat.shape[1]) for _ in range(2)],
               packer, failures)
    del updated, pack, packer

    # In place between two calls of one operator: the second call packs again.
    matvec = fused_bsr.bsr_matvec_fused(bsr, symmetric=True)
    t, v = tiles.clone(), _tensor(rng, mat.shape[1])
    packs = fused_bsr.PACKS
    first = matvec(v, t)
    t.add_(update)
    second = matvec(v, t)
    torch.cuda.synchronize()
    repacked = fused_bsr.PACKS - packs
    print(f"  in-place update between two calls: packs {repacked} (2 expected)", flush=True)
    if repacked != 2:
        failures.append("in-place repack")
    _report("K10 before the in-place update vs tile plain", _rel_err(first, fused_bsr.bsr_spmv_plain(bsr, v, tiles)),
            TOL_BSR, failures)
    _report("K10 after the in-place update vs tile plain", _rel_err(second, fused_bsr.bsr_spmv_plain(bsr, v, t)),
            TOL_BSR, failures)
    del t, update, fem, tiles
    if failures:
        msg = f"{len(failures)} BSR parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _symmetrised_entries(mat, bsr):
    """``dtiles -> g_ij + g_ji``: the tile gradient at the stored entries, symmetrised.

    For a symmetric operator the Lanczos adjoint returns the gradient along
    symmetric perturbations; backprop through the loop returns the full
    one. The two agree on this part.
    """
    a = np.lexsort((mat.indices, mat.rows))
    b = np.lexsort((mat.rows, mat.indices))
    transpose = np.empty(mat.nnz, dtype=np.int64)
    transpose[a] = b
    entries = torch.as_tensor(bsr.scatter_idx, device=DEVICE)
    transpose = torch.as_tensor(transpose, device=DEVICE)

    def symmetrised(dtiles):
        g = dtiles.reshape(-1)[entries]
        return g + g[transpose]

    return symmetrised


def _dense_logdet(mat):
    """log det of the CSR matrix by a float64 dense Cholesky on the card."""
    n = mat.shape[0]
    dense = torch.zeros((n, n), dtype=torch.float64, device=DEVICE)
    dense[torch.as_tensor(mat.rows, device=DEVICE), torch.as_tensor(mat.indices, device=DEVICE)] = (
        torch.as_tensor(mat.data, dtype=torch.float64, device=DEVICE))
    chol = torch.linalg.cholesky(dense)
    del dense
    value = 2.0 * float(torch.sum(torch.log(torch.diagonal(chol))))
    del chol
    torch.cuda.empty_cache()
    return value


def phase_slice_bsr():
    """The JAX VJP benchmark's flow on the FEM matrix through the port's
    entry points: ``sparse_operator`` (BSR, K10) -> ``tridiag`` and
    ``hessenberg`` at K = 90, custom adjoint and backprop; per-probe SLQ
    in the tiles; one Lanczos VJP over a HYB operator."""
    from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos
    from lanczos_adjoints_tpu_torch.ops import fused_bsr, native, sparse
    from lanczos_adjoints_tpu_torch.trace import hutchinson, slq
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    mat, bsr, _tiles = _fem()
    del _tiles
    matvec, tiles, info = sparse.sparse_operator(mat, with_info=True, device=DEVICE)
    n = mat.shape[0]
    v0 = torch.ones(n, device=DEVICE)
    print(f"[slice-bsr] FEM grid {BSR_GRID}, 3 dofs: n={n} nnz={mat.nnz} format={info.format} "
          f"width={bsr.width} fill={info.fill_efficiency:.4f} tiles {4 * info.stored_slots / 1e6:.1f} MB, "
          f"K={BSR_DEPTH}, one VJP with the all-ones cotangent per route", flush=True)
    failures = [] if info.format == "bsr" else ["format"]
    logs = {"lanczos": [], "arnoldi": []}

    def build(kind, op, custom_vjp, log=None):
        if kind == "lanczos":
            return lanczos.tridiag(op, BSR_DEPTH, reortho="none", custom_vjp=custom_vjp, dispatch_log=log)
        # Re-orthogonalised: without it, Arnoldi on this operator loses
        # orthogonality (1e-2 at K = 12 in float64) and the closed-form
        # adjoint departs from backprop by 1e10 in both packages.
        return arnoldi.hessenberg(op, BSR_DEPTH, reortho="full", custom_vjp=custom_vjp, dispatch_log=log)

    routes = {(kind, cv): build(kind, matvec, cv, logs[kind] if cv else None)
              for kind in ("lanczos", "arnoldi") for cv in (True, False)}
    # Forward: one K10 a step. Custom Lanczos adjoint: one K10 a step (A lam),
    # its value gradient a broadcast; custom Arnoldi adjoint: the forward K10
    # and the cotangent K10 of each step's VJP; backprop: each step's dv.
    expected = {("lanczos", True): 2 * BSR_DEPTH, ("lanczos", False): 2 * BSR_DEPTH,
                ("arnoldi", True): 3 * BSR_DEPTH, ("arnoldi", False): 2 * BSR_DEPTH}
    # One pack of the tiles a VJP: the forward and adjoint matvecs share it.
    grads, launches, packs = {}, {}, {}
    for key, estimate in routes.items():
        native.reset_launches()
        fused_bsr.PACKS = 0
        grads[key] = _one_vjp(estimate, v0, tiles)
        torch.cuda.synchronize()
        launches[key] = _launches(BSR_KERNELS)["bsr_spmv"]
        packs[key] = fused_bsr.PACKS
        finite = all(bool(torch.isfinite(g).all()) for g in grads[key])
        ok = launches[key] == expected[key] and packs[key] == 1 and finite
        print(f"  {key[0]} {'custom' if key[1] else 'backprop'}: K10 launches per VJP {launches[key]} "
              f"(predicted {expected[key]}), packs {packs[key]} (predicted 1); grads finite {finite} max|dv| "
              f"{float(grads[key][0].abs().max()):.6e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{key} launches")
    print(f"  dispatch log: {logs}")
    if logs != {"lanczos": ["tridiag:generic"], "arnoldi": ["hessenberg:generic"]}:
        failures.append("dispatch log")

    # Custom adjoint vs backprop, against the spread of the plain einsum
    # matvec's float32-vs-float64 VJPs on the same inputs.
    plain = sparse.bsr_matvec_fn(bsr)
    symmetrised = _symmetrised_entries(mat, bsr)
    for kind in ("lanczos", "arnoldi"):
        spread = {}
        for cv in (True, False):
            pair = [_one_vjp(build(kind, plain, cv), v0.to(dtype), tiles.to(dtype))
                    for dtype in (torch.float32, torch.float64)]
            spread[cv] = (_rel_err(pair[0][0], pair[1][0]),
                          _rel_err(symmetrised(pair[0][1]), symmetrised(pair[1][1])))
            del pair
        custom, backprop = grads[(kind, True)], grads[(kind, False)]
        _report_spread(f"adjoint vs backprop dv {kind}", _rel_err(custom[0], backprop[0]),
                       max(spread[True][0], spread[False][0]), failures)
        _report_spread(f"adjoint vs backprop symmetrised dtiles {kind}",
                       _rel_err(symmetrised(custom[1]), symmetrised(backprop[1])),
                       max(spread[True][1], spread[False][1]), failures)
    del grads
    if failures:
        raise RuntimeError(f"BSR slice failed: {failures}")

    times = {}
    for key in routes:
        times[key] = events_ms(lambda k=key: _one_vjp(routes[k], v0, tiles), 5)
        print(f"  VJP wall time {key[0]} {'custom' if key[1] else 'backprop'}: {times[key]:.3f} ms "
              f"(CUDA events, mean of 5 after warm-up)", flush=True)
    profiles = {kind: _print_profile(f"{kind} custom", lambda k=kind: _one_vjp(routes[(k, True)], v0, tiles))
                for kind in ("lanczos", "arnoldi")}

    # Per-probe SLQ, value and gradient in the tiles, against a float64
    # dense Cholesky log-determinant.
    drawn = []
    rademacher = hutchinson.sampler_rademacher(torch.ones(n, device=DEVICE), num=BSR_PROBES)

    def value_and_grad(sampler):
        logdet = slq.krylov_logdet_slq(BSR_DEPTH, sample=sampler, num_batches=1, checkpoint=False)
        p = tiles.clone().requires_grad_()
        value, _info = logdet(matvec, torch.Generator(device=DEVICE).manual_seed(4), p)
        (grad,) = torch.autograd.grad(value, [p])
        return value.detach(), grad

    native.reset_launches()
    fused_bsr.PACKS = 0
    value, grad = value_and_grad(lambda key: drawn.append(rademacher(key)) or drawn[-1])
    torch.cuda.synchronize()
    slq_launches = _launches(BSR_KERNELS)["bsr_spmv"]
    slq_packs = fused_bsr.PACKS
    finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(value))
    want = BSR_PROBES * 3 * BSR_DEPTH  # each probe: a re-orthogonalised Arnoldi VJP
    print(f"  SLQ ({BSR_PROBES} probes, K={BSR_DEPTH}): K10 launches {slq_launches} (predicted {want}), "
          f"packs {slq_packs} (predicted 1: every probe sees the same tiles); value and gradient finite "
          f"{finite}", flush=True)
    if slq_launches != want or slq_packs != 1 or not finite:
        failures.append("SLQ launches")
    with torch.no_grad():
        per_probe = torch.stack([lanczos.integrand_spd(torch.log, BSR_DEPTH, matvec)(v, tiles)
                                 for v in drawn[0]]).double()
    se = float(per_probe.std()) / BSR_PROBES ** 0.5
    slq_ms = events_ms(lambda: value_and_grad(lambda _key: drawn[0]), 2)
    t0 = time.perf_counter()
    exact = _dense_logdet(mat)
    chol_s = time.perf_counter() - t0
    dev = abs(float(value) - exact)
    print(f"  logdet: SLQ {float(value):.4f}, float64 dense Cholesky {exact:.4f} ({chol_s:.1f} s), |diff| "
          f"{dev:.4f}, standard error {se:.4f}, |diff| / se {dev / se:.3f} (limit 5); value-and-gradient "
          f"wall time {slq_ms:.3f} ms (CUDA events, mean of 2)", flush=True)
    if not dev <= 5 * se:
        failures.append("SLQ vs Cholesky")

    # The HYB route on the card: PyTorch ops, no kernel of the port.
    rnd = _random_csr(HYB_N, HYB_PER_ROW)
    mv_h, values_h, info_h = sparse.sparse_operator(rnd, with_info=True, device=DEVICE)
    native.reset_launches()
    inputs = [torch.ones(HYB_N, device=DEVICE).requires_grad_()] + [p.clone().requires_grad_() for p in values_h]
    outputs = _leaves(lanczos.tridiag(mv_h, BSR_DEPTH, reortho="none")(*inputs))
    hyb_grads = torch.autograd.grad(outputs, inputs, [torch.ones_like(o) for o in outputs], allow_unused=True)
    torch.cuda.synchronize()
    hyb_counts = {k: c for k, c in native.launch_counts().items() if c}
    hyb_finite = all(g is None or bool(torch.isfinite(g).all()) for g in hyb_grads)
    hyb_ms = events_ms(lambda: torch.autograd.grad(
        _leaves(lanczos.tridiag(mv_h, BSR_DEPTH, reortho="none")(*inputs)), inputs,
        [torch.ones_like(o) for o in outputs], allow_unused=True), 3)
    print(f"  HYB: random {HYB_N} x {HYB_N}, {HYB_PER_ROW} a row: format={info_h.format} fill="
          f"{info_h.fill_efficiency:.4f}, heavy rows {values_h[1].shape[0]}; Lanczos K={BSR_DEPTH} VJP grads "
          f"finite {hyb_finite}, kernel launches {hyb_counts} (none expected), wall {hyb_ms:.3f} ms "
          f"(mean of 3)", flush=True)
    if info_h.format != "hyb" or not hyb_finite or hyb_counts:
        failures.append("hyb")
    if failures:
        raise RuntimeError(f"BSR slice failed: {failures}")
    return {"launches": launches, "packs": packs, "slq_packs": slq_packs, "vjp_ms": times,
            "profile": profiles, "slq_launches": slq_launches,
            "slq_ms": slq_ms, "slq": float(value), "exact": exact, "se": se, "hyb_ms": hyb_ms, "n": n,
            "nnz": mat.nnz}


# Bytes read and written between two cold timed calls: 10x the 50 MB L2,
# so that no operand of the previous call is left in it.
FLUSH_BYTES = 512 << 20


def _cold_ms(fn, reps, flush, symbol=None):
    """``fn()`` with the L2 flushed before every call (``flush`` negated in
    place, a read and a write of 10x the L2, outside the timed span): the
    mean of CUDA events around each call, and, given the ``symbol`` of a
    kernel of the port, that kernel's device time per launch from the
    profiler (else None)."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]

    def timed():
        for start, stop in pairs:
            flush.neg_()
            start.record()
            fn()
            stop.record()

    timed()
    torch.cuda.synchronize()
    events = sum(a.elapsed_time(b) for a, b in pairs) / reps
    if symbol is None:
        return events, None
    _wall, kernels, _counts = _profiled(timed)
    return events, _per_launch_ms(kernels, symbol)


def phase_timing_bsr(slice_run):
    """K10's time per launch on the FEM matrix and its RCM permutation, with
    the L2 flushed before each call (cold) and with only the vector changing
    (warm, as in the Lanczos loop), beside cuSPARSE CSR under both, the
    bound on the work the nonzeros need, the plain version and the pack;
    its kernels-line entry."""
    from lanczos_adjoints_tpu_torch.ops import fused_bsr

    print("[timing-bsr] K10 at the slice's shapes (profiler and CUDA events), L2-cold and warm; "
          "library: cuSPARSE CSR", flush=True)
    rows, failures = {}, []
    rng = np.random.default_rng(12)
    flush = torch.zeros(FLUSH_BYTES // 4, device=DEVICE)
    for rcm in (False, True):
        key = "rcm" if rcm else "fem"
        mat, bsr, tiles = _fem(rcm)
        n, nnz = mat.shape[0], mat.nnz
        packer = fused_bsr.BsrPacker(bsr)
        pack = packer(tiles)
        # Warm: 8 vectors, one operator, as the Lanczos loop sees it.
        vs = [_tensor(rng, n) for _ in range(ROTATE_SETS)]
        csr = torch.sparse_csr_tensor(
            torch.tensor(mat.indptr, device=DEVICE), torch.tensor(mat.indices, device=DEVICE),
            torch.tensor(mat.data, dtype=torch.float32, device=DEVICE), size=mat.shape,
            check_invariants=True,
        )
        lib_err = _rel_err(csr @ vs[0], fused_bsr.bsr_spmv_packed(pack, vs[0]))
        print(f"  {key}: library CSR product vs K10: max rel err {lib_err:.3e}", flush=True)
        # The work the nonzeros need, the same for any format: each value and
        # column once, the row pointers, v and out.
        nbytes = 8 * nnz + 4 * (n + 1) + 8 * n
        _record(rows, failures, key, "bsr_csr_spmv_kernel",
                [lambda v=v: fused_bsr.bsr_spmv_packed(pack, v) for v in vs],
                [lambda v=v: fused_bsr.bsr_spmv_packed_plain(pack, v) for v in vs],
                nbytes, 2 * nnz, 48, 8, tols=(TOL_BSR,),
                library=[lambda v=v: csr @ v for v in vs])
        row = rows[key]
        cold_events, cold_device = _cold_ms(lambda: fused_bsr.bsr_spmv_packed(pack, vs[0]), 20, flush,
                                            "bsr_csr_spmv_kernel")
        lib_cold, _none = _cold_ms(lambda: csr @ vs[0], 20, flush)
        structure = fused_bsr.bsr_structure(bsr, DEVICE)
        fused_bsr.pack_tiles(bsr, tiles, structure)
        pack_ms = _events_ms_sync(lambda: fused_bsr.pack_tiles(bsr, tiles, structure), 5)
        # The pack reads the tile stream once (the count off the structure),
        # gathers each value by its int64 slot, writes it and counts it.
        pack_bytes = 4 * bsr.num_slots + nnz * (8 + 4 + 4 + 4)
        # Other bounds, printed beside the measured times only: the kernels
        # line carries one bound, bound_ms.
        pack_bound_ms = 1e3 * pack_bytes / PEAK_BYTES
        tiles_bound_ms = 1e3 * 4 * (bsr.num_slots + bsr.block_cols.numel() + 2 * n) / PEAK_BYTES
        row.update(
            n=n, nnz=nnz, width=bsr.width, tile_mb=4 * bsr.num_slots / 1e6, csr_mb=nbytes / 1e6,
            ms_warm=row["ms"], library_ms_warm=row["library_ms"],
            # Cold, like for like: CUDA events around each call for both.
            ms_cold=cold_events, ms_cold_device=cold_device, library_ms_cold=lib_cold,
            pack_ms=pack_ms, pack_bytes=pack_bytes,
        )
        device = "not measured" if cold_device is None else f"{cold_device:.4f} ms"
        print(f"  {key}: K10 cold {cold_events:.4f} ms by events ({device} on the device), warm "
              f"{row['ms_warm']:.4f} ms on the device; cuSPARSE cold {lib_cold:.4f} ms by events, warm "
              f"{row['library_ms_warm']:.4f} ms on the device; bound "
              f"{row['bound_ms']:.4f} ms on {nbytes / 1e6:.1f} MB (the tiles' bound "
              f"{tiles_bound_ms:.4f} ms on {row['tile_mb']:.1f} MB); pack {pack_ms:.4f} ms "
              f"(bound {pack_bound_ms:.4f} ms on {pack_bytes / 1e6:.1f} MB, one host sync)",
              flush=True)
        del tiles, csr, vs, pack, packer, structure
    del flush
    if failures:
        raise RuntimeError(f"K10 disagrees with its plain version in [timing-bsr]: {failures}")
    profile = slice_run["profile"]["lanczos"]
    in_vjp = _per_launch_ms(profile["kernels"], "bsr_csr_spmv_kernel") if profile else None
    print(f"  fem: K10 in the profiled Lanczos VJP {in_vjp if in_vjp is None else f'{in_vjp:.4f}'} ms a "
          f"launch", flush=True)
    return {
        "name": "bsr_spmv", "route": "cuda", "source": "lanczos_adjoints_tpu_torch/csrc/bsr.cu",
        "replaces": "lanczos_adjoints_tpu/ops/pallas_bsr.py:48",
        "launches": slice_run["launches"][("lanczos", True)], **rows["fem"],
        "ms_in_vjp": in_vjp,
        "launches_per_vjp": {f"{k} {'custom' if cv else 'backprop'}": c
                             for (k, cv), c in slice_run["launches"].items()},
        "packs_per_vjp": {f"{k} {'custom' if cv else 'backprop'}": c
                          for (k, cv), c in slice_run["packs"].items()},
        "launches_slq": slice_run["slq_launches"], "packs_slq": slice_run["slq_packs"],
        "by_matrix": rows,
    }


def _events_ms_sync(fn, reps):
    """Mean ms of ``fn()`` by CUDA events where ``fn`` synchronises with the
    host itself (the pack's count): events around each call."""
    total = 0.0
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


# ---------------------------------------------------------------------------
# The multi-device layer on one card: the halo-exchange DIA kernel (K11), the
# row-partitioned Lanczos VJP, the sharded GP step
# ---------------------------------------------------------------------------

# [parity-halo] shapes: n = 1,000,000 is not a multiple of P x 1024 (the
# JAX kernel's tiling), and over 64 partitions its 15,625 local rows take
# K11's scalar path; at n = 16,384, P = 8 and halo 1024 every row of a
# partition is an edge row. A case runs at every P whose local rows hold
# its halo.
HALO_SIZES = (16_384, 1_000_000, 1 << 20)
HALO_OFFSETS = ((-1, 0, 1), (-130, -7, 0, 7, 130), (-1024, -1, 0, 1, 1024), WIDE_65, WIDE_100)
HALO_PARTITIONS = (1, 2, 8, 64)
# (n, offsets, P) where the halo is wider than half the local rows (63 of
# 125, and 125 % 4 != 0: the scalar path): a partition's first and last
# 63 rows overlap.
HALO_WIDE = ((1000, (-63, 0, 63), 8), (1000, (-63, -62, -1, 0, 1, 62, 63), 8))
# [slice-halo]: multihost_scaling's measured path at its defaults.
HALO_N, HALO_BANDWIDTH, HALO_DEPTH, HALO_MESHES = 1 << 20, 1024, 30, (1, 2, 4, 8)
HALO_KERNELS = ("halo_dia_matvec", "halo_dia_matvec_transposed", *DIA_KERNELS)


def _offset_by_one(t):
    """A contiguous copy of ``t`` that starts one float past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _k11_refusals(failures):
    """The C entry refuses a vector launch (4 rows a thread) on values
    offset by one float, on local rows that are no multiple of 4 and on a
    partition table with one misaligned block, without launching."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

    fn = native.library("halo_dia").lat_halo_dia_matvec
    offsets = (-1, 0, 1)
    offs = native.offsets_arg(offsets, None, DEVICE)
    host = (ctypes.c_int * 3)(*offsets)
    stream = native.stream(torch.device(DEVICE))
    launches = native.KERNELS["halo_dia_matvec"].launches
    v, vals = torch.ones(1024, device=DEVICE), torch.ones((3, 1024), device=DEVICE)
    out = torch.empty_like(v)
    shifted = _offset_by_one(vals)
    v_1000, vals_1000 = torch.ones(1000, device=DEVICE), torch.ones((3, 1000), device=DEVICE)
    parts = [_offset_by_one(vals[:, :512].contiguous()), vals[:, 512:].contiguous()]
    tables = [fh._pointers(ts) for ts in ([v[:512], v[512:]], parts, [out[:512], out[512:]])]
    cases = {
        "values offset by one float": (v.data_ptr(), shifted.data_ptr(), out.data_ptr(), 0, 2, 512, 1024),
        "local rows 125": (v_1000.data_ptr(), vals_1000.data_ptr(), out.data_ptr(), 0, 8, 125, 1000),
        "a partition table with one misaligned block": (*tables, 1, 2, 512, 512),
    }
    for label, (pv, pw, po, table, parts_, local_n, ld) in cases.items():
        status = fn(pv, pw, po, table, parts_, local_n, ld, 1, 3, host, offs.data_ptr(), 4, 8, stream)
        ok = status != 0 and native.KERNELS["halo_dia_matvec"].launches == launches
        print(f"  K11 refuses a vector launch on {label}: status {status} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"vector launch on {label} accepted")
    torch.cuda.synchronize()


def phase_parity_halo():
    """K11 bit for bit against K4 on the global vector and against its
    plain version summed with fused multiply-adds (K4's rounding), on one
    allocation per partition (so that a partition reads its neighbours'
    halos where they live) and on views of one tensor, aligned and offset
    by one float; each case's path (4 rows a thread or 1) and that both
    are reached; the C entry's refusals; the Function's dv (K11 on the
    transpose) and dvals (against K5, bit for bit)."""
    from lanczos_adjoints_tpu_torch import parallel
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

    print("[parity-halo] K11 vs K4 and its plain version, bit for bit, P partitions on one card", flush=True)
    failures, paths = [], {1: 0, fh.VECTOR_ROWS: 0}
    _k11_refusals(failures)
    sms = native.device_limits(DEVICE)[0]
    rng = np.random.default_rng(13)
    cases = [(n, offsets, HALO_PARTITIONS) for n in HALO_SIZES for offsets in HALO_OFFSETS]
    cases += [(n, offsets, (parts,)) for n, offsets, parts in HALO_WIDE]
    for n, offsets, partitions in cases:
        vals = _tensor(rng, (len(offsets), n))  # every slot, the wrapped ones too
        for parts in partitions:
            local_n = n // parts
            if fh.halo_width(offsets) > local_n:
                continue
            shown = offsets if len(offsets) <= 7 else f"{len(offsets)} diagonals"
            tag = f"n={n} offsets={shown} P={parts}"
            plan = fh.halo_plan(offsets, n, parts, sms)
            own = {"memory_format": torch.contiguous_format}  # a new allocation each
            vals_parts = [vals[:, p * local_n:(p + 1) * local_n].clone(**own) for p in range(parts)]
            v = _tensor(rng, n)
            v_parts = [v[p * local_n:(p + 1) * local_n].clone(**own) for p in range(parts)]
            v_off, vals_off = _offset_by_one(v), _offset_by_one(vals)
            layouts = {
                "one allocation a partition": (
                    lambda: torch.cat(fh.halo_dia_parts(offsets, v_parts, vals_parts)),
                    plan.rows(local_n, *(w.data_ptr() for w in vals_parts))),
                "views": (lambda: fh.halo_dia_rows(offsets, v, vals, parts), plan.rows(n, vals.data_ptr())),
                "views offset by one float": (lambda: fh.halo_dia_rows(offsets, v_off, vals_off, parts),
                                              plan.rows(n, vals_off.data_ptr())),
            }
            k4 = fd.dia_matvec_rows(offsets, v, vals)
            plain = fh.halo_dia_plain(offsets, v, vals, parts, fused=True)
            taken, ok = [], True
            for label, (run, rows) in layouts.items():
                before = dict(fh.LAUNCHES_BY_ROWS)
                got = run()
                torch.cuda.synchronize()
                path = [r for r, c in fh.LAUNCHES_BY_ROWS.items() if c != before[r]]
                taken.append(path)
                for r in path:
                    paths[r] += 1
                same = (torch.equal(got, k4), torch.equal(got, plain))
                if not all(same) or path != [rows]:
                    print(f"  K11 {tag} {label}: rows a thread {path} (predicted {rows}); bit for bit vs K4 "
                          f"{same[0]}, vs plain {same[1]}; rel err vs K4 {_rel_err(got, k4):.3e} FAIL", flush=True)
                    failures.append(f"{tag} {label}")
                    ok = False
            print(f"  K11 {tag}: rows a thread {taken} ({', '.join(layouts)}); bit for bit vs K4 and the "
                  f"plain version {'ok' if ok else 'FAIL'}", flush=True)
            # The operator's Function: dv by K11 on the transpose, dvals
            # by the shift products, against K4^T and K5 on the whole vector.
            op = parallel.sharded_dia_operator(_dia(offsets, n), parallel.device_mesh(parts))
            x, u = _tensor(rng, n), _tensor(rng, n)
            args = [x.clone().requires_grad_(), vals.clone().requires_grad_()]
            dv, dvals = torch.autograd.grad(op(*args), args, u)
            ref = [x.clone().requires_grad_(), vals.clone().requires_grad_()]
            dv_k4, _ = torch.autograd.grad(fd.dia_matvec_fused(_dia(offsets, n), check_tiling=False)(*ref),
                                           ref, u)
            dvals_k5 = fd.dia_dvals_rows(offsets, x, u)
            torch.cuda.synchronize()
            _report(f"K11^T vjp dv {tag} vs K4^T", _rel_err(dv, dv_k4), TOL_DIA, failures)
            _report(f"vjp dvals {tag} vs K5", _rel_err(dvals, dvals_k5), TOL_DVALS, failures)
        del vals
    print(f"  launches by path: {fh.VECTOR_ROWS} rows a thread {paths[fh.VECTOR_ROWS]}, 1 row a thread "
          f"{paths[1]}", flush=True)
    if not all(paths.values()):
        failures.append(f"a path of K11 was not reached: {paths}")
    if failures:
        msg = f"{len(failures)} halo parity checks failed: {failures[:5]}"
        raise RuntimeError(msg)


def _halo_reference(mat, dia, vals, v0, depth):
    """The unsharded fused route (K6/K7 on ``sparse_operator``) that the sharded
    VJPs are held to: ``(estimate, (dv, dvals), (plain f32, plain f64), dispatch log)``,
    the plain adjoint run in both precisions for the spread-derived limit."""
    from lanczos_adjoints_tpu_torch.krylov import lanczos
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl
    from lanczos_adjoints_tpu_torch.ops import sparse

    matvec_u, _vals_u = sparse.sparse_operator(mat, format="dia", device=DEVICE)
    log_u = []
    unsharded = lanczos.tridiag(matvec_u, depth, reortho="none", dispatch_log=log_u)
    want_grads = _one_vjp(unsharded, v0, vals)
    spreads = []
    for dtype in (torch.float32, torch.float64):
        xs, alphas, betas = fl.lanczos_forward_plain(dia.offsets, vals.to(dtype), v0.to(dtype), depth)
        spreads.append(fl.lanczos_adjoint_plain(
            dia.offsets, vals.to(dtype), xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0.to(dtype)),
            torch.ones_like(xs), torch.ones_like(alphas), torch.ones_like(betas)))
    return unsharded, want_grads, spreads, log_u


def phase_slice_halo():
    """multihost_scaling's measured path through the port's entry points: the
    5-diagonal operator -> ``parallel.sharded_dia_operator`` ->
    ``krylov.tridiag(K=30)``, one VJP with the all-ones cotangent per mesh,
    held to the unsharded fused route (K6/K7 on ``sparse_operator``)."""
    from lanczos_adjoints_tpu_torch import parallel
    from lanczos_adjoints_tpu_torch.krylov import lanczos
    from lanczos_adjoints_tpu_torch.ops import native, sparse
    from lanczos_adjoints_tpu_torch.utils import test_util
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    n, depth = HALO_N, HALO_DEPTH
    mat = test_util.five_diagonal(n, HALO_BANDWIDTH)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device=DEVICE)
    v0 = torch.ones(n, device=DEVICE)
    print(f"[slice-halo] 5-diagonal operator n={n} nnz={mat.nnz} offsets={dia.offsets} K={depth}, "
          f"meshes of {HALO_MESHES} partitions on one card, one VJP with the all-ones cotangent",
          flush=True)
    unsharded, want_grads, spreads, log_u = _halo_reference(mat, dia, vals, v0, depth)
    failures = [] if log_u == ["tridiag:dia_fused"] else [f"unsharded dispatch {log_u}"]
    want = {k: 0 for k in HALO_KERNELS}
    want["halo_dia_matvec"] = 2 * depth
    launches, times, routes = {}, {}, {}
    for parts in HALO_MESHES:
        log = []
        matvec = parallel.sharded_dia_operator(dia, parallel.device_mesh(parts, device=DEVICE))
        routes[parts] = lanczos.tridiag(matvec, depth, reortho="none", dispatch_log=log)
        native.reset_launches()
        grads = _one_vjp(routes[parts], v0, vals)
        torch.cuda.synchronize()
        launches[parts] = _launches(HALO_KERNELS)
        ok = launches[parts] == want and log == ["tridiag:generic"] and not hasattr(matvec, "dia_data")
        print(f"  P={parts}: launches per VJP {launches[parts]} (predicted {want}); dispatch log {log} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"P={parts} launches/dispatch")
        for label, i in (("dv", 0), ("dvals", 1)):
            _report_spread(f"P={parts} sharded vs unsharded fused {label}", _rel_err(grads[i], want_grads[i]),
                           _rel_err(spreads[0][i], spreads[1][i]), failures)
    if failures:
        raise RuntimeError(f"halo slice failed: {failures}")
    times["unsharded fused"] = events_ms(lambda: _one_vjp(unsharded, v0, vals), 5)
    for parts in HALO_MESHES:
        times[parts] = events_ms(lambda p=parts: _one_vjp(routes[p], v0, vals), 5)
    for key, ms in times.items():
        label = f"P={key}" if isinstance(key, int) else key
        print(f"  VJP wall time {label}: {ms:.3f} ms (CUDA events, mean of 5 after warm-up)", flush=True)
    profile = _print_profile(f"P={HALO_MESHES[-1]}", lambda: _one_vjp(routes[HALO_MESHES[-1]], v0, vals))
    return {"launches": launches, "vjp_ms": {str(k): v for k, v in times.items()}, "profile": profile,
            "n": n, "nnz": mat.nnz}


def _gp_value_and_grad(stack, params, X, y):
    """The training loss and its gradient at ``params``, probes drawn from seed 1."""
    p = params.clone().requires_grad_()
    value, info = stack.mll_lanczos(p, torch.Generator(device=DEVICE).manual_seed(1), X, y)
    (grad,) = torch.autograd.grad(value, [p])
    return value, grad, info


def phase_slice_mesh(n_train):
    """``train.gp.dryrun_multichip(8)`` with the fused policy, then one
    ``adj400k`` step over an 8-partition rows mesh against the unsharded
    step at the same parameters and probes."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    print("[slice-mesh] dryrun_multichip(8): the 4x2 per-probe and 8 blocked GP steps vs unsharded",
          flush=True)
    gram = ("gram_matvec", "gram_grads")
    native.reset_launches()
    start = time.perf_counter()
    reports = train_gp.dryrun_multichip(8, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _launches(gram)
    for r in reports:
        print(f"  {r['mesh']} {r['slq']} n={r['n']}: loss {r['loss']:.7f} vs unsharded "
              f"{r['loss_unsharded']:.7f}; loss error {r['loss_err_of_limit']:.3e} and gradient error "
              f"{r['grad_err_of_limit']:.3e} of their limits (rtol 1e-5, 1e-4 scaled); Adam step finite",
              flush=True)
    print(f"  dry run {seconds:.1f} s, launches K1 {counts['gram_matvec']} K2 {counts['gram_grads']}")
    if min(counts.values()) == 0:
        raise RuntimeError(f"the dry run launched no Gram kernel: {counts}")

    X, y = _data(n_train)
    print(f"  adj400k over an 8-partition rows mesh: N_train={n_train}, d=8, blocked SLQ 15 x 15, "
          f"PCG atol 1.0, rank 448; against the unsharded step", flush=True)
    params = torch.randn(11, generator=torch.Generator().manual_seed(1)).to(DEVICE)
    results, stacks = {}, {}
    for mesh in ("1", "8"):
        stacks[mesh] = stack = train_gp.assemble(n_train=n_train, ndim=8, mesh=mesh, device=DEVICE)
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value, grad, info = _gp_value_and_grad(stack, params, X, y)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        results[mesh] = (value.item(), grad, step_s, _launches(gram),
                         float(info["logpdf"]["solve"]["num_steps"]))
        print(f"  mesh {mesh}: loss {value.item():.7f}, CG steps {results[mesh][4]:.0f}, step {step_s:.3f} s, "
              f"launches K1 {results[mesh][3]['gram_matvec']} K2 {results[mesh][3]['gram_grads']}", flush=True)
    # The same sharded step once more under the profiler: device time by kernel.
    profile = _print_profile("adj400k mesh 8", lambda: _gp_value_and_grad(stacks["8"], params, X, y))
    value_1, grad_1, _s, counts_1, _cg = results["1"]
    value_8, grad_8, step_8, counts_8, _cg = results["8"]
    loss_rel = abs(value_8 - value_1) / abs(value_1)
    grad_err = float((grad_8 - grad_1).abs().max()) / float(grad_1.abs().max())
    eightfold = all(counts_8[k] == 8 * counts_1[k] for k in gram)
    print(f"  sharded vs unsharded: loss rel diff {loss_rel:.3e} (tol 1e-04), gradient {grad_err:.3e} of its "
          f"largest entry (tol 1e-03); launches 8x the unsharded step's: {eightfold}", flush=True)
    if not (loss_rel <= 1e-4 and grad_err <= 1e-3 and min(counts_8.values()) > 0
            and all(c % 8 == 0 for c in counts_8.values())):
        raise RuntimeError("the sharded adj400k step failed its gates")
    return {"dryrun": reports, "dryrun_launches": counts, "step_s": step_8, "launches": counts_8,
            "profile": profile, "unsharded": {"step_s": results["1"][2], "launches": counts_1}}


def _k11_traffic(n, num_diags, parts, halo):
    """K11's bytes: each array once (the values, v and the output; the
    bound), the parent kernel's schedule and this one's. Both read the
    2 P halo floats of the partitions' neighbours once more; the parent's
    also wrote them into receive buffers and read them back from there.
    Printed beside the bound, never part of the kernels line."""
    once = 4 * (num_diags + 2) * n
    halos = 4 * 2 * parts * halo
    return {"bytes_once": once, "bytes_parent_schedule": once + 3 * halos, "bytes_schedule": once + halos}


def phase_timing_halo(slice_run):
    """K11's time per launch at n = 2^20, D = 5, P = 8, 4, 2 and 1, beside
    its bound, its plain version, K4 on the whole vector and cuSPARSE; its
    kernels-line entry."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.ops import sparse
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh
    from lanczos_adjoints_tpu_torch.utils import test_util

    print("[timing-halo] K11 at the slice's shape (profiler and CUDA events); yardsticks K4 and cuSPARSE",
          flush=True)
    rows, failures = {}, []
    rng = np.random.default_rng(14)
    n = HALO_N
    mat = test_util.five_diagonal(n, HALO_BANDWIDTH)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device=DEVICE)
    offsets, num_diags = dia.offsets, len(dia.offsets)
    sets = [(_tensor(rng, n), vals.clone()) for _ in range(ROTATE_SETS)]
    csr = torch.sparse_csr_tensor(
        torch.tensor(mat.indptr, device=DEVICE), torch.tensor(mat.indices, device=DEVICE),
        torch.tensor(mat.data, dtype=torch.float32, device=DEVICE), size=mat.shape, check_invariants=True,
    )
    nbytes, ops = 4 * (num_diags + 2) * n, 2 * num_diags * n
    for parts in (8, 4, 2, 1):
        traffic = _k11_traffic(n, num_diags, parts, fh.halo_width(offsets))
        print(f"  P={parts} traffic: each array once {traffic['bytes_once']} B, this schedule "
              f"{traffic['bytes_schedule']} B, the parent's {traffic['bytes_parent_schedule']} B", flush=True)
        _record(rows, failures, parts, "halo_dia_kernel",
                [lambda s=s, p=parts: fh.halo_dia_rows(offsets, s[0], s[1], p) for s in sets],
                [lambda s=s, p=parts: fh.halo_dia_plain(offsets, s[0], s[1], p) for s in sets],
                nbytes, ops, 48, 8, tols=(TOL_DIA,), library=[lambda s=s: csr @ s[0] for s in sets])
    _record(rows, failures, "K4", "dia_matvec_kernel",
            [lambda s=s: fd.dia_matvec_rows(offsets, s[0], s[1]) for s in sets],
            [lambda s=s: fd.dia_matvec_plain(offsets, s[0], s[1]) for s in sets],
            nbytes, ops, 48, 8, tols=(TOL_DIA,))
    if failures:
        raise RuntimeError(f"K11 disagrees with its plain version in [timing-halo]: {failures}")
    profile = slice_run["profile"]
    return {
        "name": "halo_dia_matvec", "route": "cuda", "source": "lanczos_adjoints_tpu_torch/csrc/halo_dia.cu",
        "replaces": "lanczos_adjoints_tpu/parallel/pallas_halo.py:54",
        "launches": slice_run["launches"][HALO_MESHES[-1]]["halo_dia_matvec"], **rows[8], "n": n,
        "partitions": 8, "by_partitions": {str(p): rows[p] for p in (8, 4, 2, 1)}, "k4_global": rows["K4"],
        "ms_in_vjp": _per_launch_ms(profile["kernels"], "halo_dia_kernel") if profile else None,
        "launches_per_vjp": {f"P={p}": c["halo_dia_matvec"] for p, c in slice_run["launches"].items()},
    }


# The linearised-Laplace slice (train.laplace): held to the JAX drivers'
# float32 CPU run through its fixture, then run at full width.
LAPLACE_RANK_WIDE = 50
TOL_LAPLACE_F64 = {"loss": 1e-3, "grad": 1e-2}
# Calls that move a result to the host on purpose: the metrics' scores go
# to numpy for the AUROC.
HOST_CALLS = ("cpu", "numpy", "item", "tolist", "__float__", "__format__")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _OnCard(torch.overrides.TorchFunctionMode):
    """Every torch call inside it: counted, and recorded by name where a tensor
    it takes or gives lies off the card (the host calls of ``HOST_CALLS`` apart)."""

    def __init__(self):
        super().__init__()
        self.calls, self.host_calls, self.off_card = 0, 0, {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        name = getattr(func, "__name__", str(func))
        if name in HOST_CALLS:
            self.host_calls += 1
        elif any(not (t.is_cuda or t.is_meta) for t in _tensors((args, kwargs, out))):
            self.off_card[name] = self.off_card.get(name, 0) + 1
        return out

    def check(self, label):
        print(f"  {label}: {self.calls} torch calls, every tensor on the card: {not self.off_card} "
              f"({self.host_calls} host reads of results)", flush=True)
        if self.off_card:
            raise RuntimeError(f"{label}: tensors off the card in {self.off_card}")


def _laplace_tpu_file(name):
    """One of the JAX drivers' committed (TPU) outputs, or None."""
    from lanczos_adjoints_tpu_torch.train import laplace

    path = laplace.JAX_TPU_RESULTS / name
    if not path.exists():
        return None
    return json.loads(path.read_text()) if path.suffix == ".json" else np.load(path)


def _no_kernel_launched(label):
    from lanczos_adjoints_tpu_torch.ops import native

    launched = {k: c for k, c in native.launch_counts().items() if c}
    print(f"  {label}: launches of the port's kernels {launched or 'none'} (none expected: no function "
          f"of this path reaches a Pallas kernel in the JAX package)", flush=True)
    if launched:
        raise RuntimeError(f"{label}: unexpected kernel launches {launched}")


def phase_slice_laplace():
    """The linearised-Laplace drivers at the parity MLP (3,709 parameters), from
    the JAX drivers' float32 CPU run (``train.laplace.FIXTURE``): ``train_map``
    from JAX's initial parameters, 3 epochs of ``calibrate`` and 10 of
    ``calibrate_diag`` from JAX's MAP vector and probes, ``compute_metrics``
    from JAX's MAP vector, draws and Ritz-vector signs, each held to that
    run; the committed TPU files printed beside, without a gate."""
    from lanczos_adjoints_tpu_torch.models import bnn
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import laplace

    fix = laplace.fixture()
    card = lambda name: torch.tensor(fix[name], device=DEVICE)  # noqa: E731
    x, y = card("calib_x"), card("calib_y")
    init, apply = bnn.model_mlp(out_dims=y.shape[-1], activation=torch.tanh)
    _, unflatten, _ = bnn.vectorize_nn(apply, init(torch.Generator(device=DEVICE).manual_seed(0), x))
    jax_map = card("calib_map")
    print(f"[slice-laplace] the JAX drivers' float32 CPU run at {jax_map.shape[0]:,} parameters: MAP within "
          f"{laplace.TOL_MAP:.0e} (norm), curves and alphas within {laplace.TOL_CURVES:.1%}, metrics within "
          f"{laplace.TOL_METRICS_REL:.0%} at its Ritz-vector signs", flush=True)
    failures = []
    native.reset_launches()
    mode = _OnCard()
    with mode:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_map, map_loss = laplace.train_map(apply, card("calib_init"), unflatten, x, y)
        t_map = time.perf_counter() - t0
        curve, alpha = laplace.calibrate(apply, unflatten, jax_map, x, y, num_epochs=3,
                                         probes=card("calib_probes"))
        t_cal = time.perf_counter() - t0 - t_map
        curve_d, alpha_d = laplace.calibrate_diag(apply, unflatten, jax_map, x, y, num_epochs=10,
                                                  probes=card("diag_probes"))
        t_diag = time.perf_counter() - t0 - t_map - t_cal
        metrics = laplace.compute_metrics(apply, unflatten, card("metrics_map"), card("metrics_x"),
                                          card("metrics_y"), card("metrics_x_ood"), key=card("metrics_eps"),
                                          signs=card("metrics_signs"))
        torch.cuda.synchronize()
        t_metrics = time.perf_counter() - t0 - t_map - t_cal - t_diag
        on_card = params_map.is_cuda and jax_map.is_cuda
    mode.check("slice-laplace")
    if not on_card:
        failures.append("MAP off the card")
    _no_kernel_launched("slice-laplace")
    map_err = float(torch.linalg.vector_norm(params_map - jax_map) / torch.linalg.vector_norm(jax_map))
    print(f"  train_map (Adam 1e-2, 200 steps) from JAX's init: loss {map_loss:.6f} (JAX "
          f"{float(fix['calib_map_loss']):.6f}), MAP rel err in norm {map_err:.3e} (tol {laplace.TOL_MAP:.0e}); "
          f"{t_map:.2f} s wall", flush=True)
    if not map_err <= laplace.TOL_MAP:
        failures.append("MAP")
    gaps = {}
    for label, got, want, want64 in (
        ("calibrate curve", np.asarray(curve), fix["calib_curve"], fix["calib_curve_f64"]),
        ("calibrate alpha", np.asarray(alpha), fix["calib_alpha"], fix["calib_alpha_f64"]),
        ("calibrate_diag curve", np.asarray(curve_d), fix["diag_curve"], None),
        ("calibrate_diag alpha", np.asarray(alpha_d), fix["diag_alpha"], None),
    ):
        gap = float(np.max(np.abs(got / want - 1.0)))
        gaps[label] = gap
        beside = "" if want64 is None else f"; JAX float64 run {np.round(want64, 4).tolist()}, gap " \
            f"{float(np.max(np.abs(got / want64 - 1.0))):.2e}"
        print(f"  {label}: {np.round(got, 4).tolist()} vs JAX {np.round(want, 4).tolist()}: max rel gap "
              f"{gap:.2e} (tol {laplace.TOL_CURVES:.1e}){beside}", flush=True)
        if not gap <= laplace.TOL_CURVES:
            failures.append(label)
    print(f"  wall: calibrate 3 epochs {t_cal:.2f} s, calibrate_diag 10 epochs {t_diag:.2f} s, "
          f"compute_metrics {t_metrics:.2f} s", flush=True)
    table, tol = laplace.metrics_table(metrics), laplace.metric_tolerances(fix)
    spread = laplace.metric_spread(fix)
    gaps_ritz = laplace.relative_ritz_gaps(fix["metrics_ritz"])
    flips = int(np.sum(fix["metrics_signs"] != fix["metrics_signs_f64"]))
    print(f"  the sampler's smallest relative Ritz gap a sample (JAX float32 run): {np.round(gaps_ritz, 6).tolist()}; "
          f"its Ritz vectors of opposite sign in float32 and float64: {flips} of {fix['metrics_signs'].size}",
          flush=True)
    for row, name in enumerate(laplace.PREDICTIVES):
        for col, metric in enumerate(laplace.METRICS):
            err = abs(table[row, col] - fix["metrics"][row, col])
            ok = err <= tol[row, col]
            print(f"  {name} {metric}: {table[row, col]:.6f} vs JAX {fix['metrics'][row, col]:.6f} (|gap| "
                  f"{err:.2e}, tol {tol[row, col]:.2e}, JAX f32-vs-f64 spread {spread[row, col]:.2e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"{name} {metric}")
    tpu = {name: _laplace_tpu_file(name) for name in (
        "callibration/s1_curve.npy", "callibration/s1_alpha.npy", "callibration_diag/s1_curve.npy",
        "callibration_diag/s1_alpha.npy", "compute_metrics_lanczos/s1_metrics.json")}
    print("  the committed TPU files (JAX at the TPU's default matmul precision; no gate): "
          + "; ".join(f"{name} {np.round(v, 4).tolist() if isinstance(v, np.ndarray) else v}"
                      for name, v in tpu.items() if v is not None), flush=True)
    if failures:
        raise RuntimeError(f"slice-laplace failed: {failures}")
    return {"map_rel_err": map_err, "gaps": gaps, "metrics": metrics,
            "seconds": {"train_map": t_map, "calibrate": t_cal, "calibrate_diag": t_diag,
                        "compute_metrics": t_metrics}}


def phase_slice_laplace_grid():
    """``python -m lanczos_adjoints_tpu_torch.train.laplace gridsearch`` at the
    parity MLP (3,709 parameters) on the fixture's probes (the JAX grid
    search's own): the 9 x 5 losses against JAX's float64 and float32 CPU runs,
    the committed TPU ``s1_gridsearch.npz`` printed beside, without a gate."""
    import argparse

    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import laplace

    fix = laplace.fixture()
    failures = []
    with tempfile.TemporaryDirectory() as out:
        args = laplace.build_argparser(argparse.ArgumentParser(), "gridsearch").parse_args(
            ["--device", DEVICE, "--out", out, "--fixture", str(laplace.FIXTURE)])
        print(f"[slice-laplace-grid] train.laplace gridsearch: {len(args.log_alphas)} log alphas x "
              f"{args.num_loss_samples} probe sets from the fixture at the calibration run's MAP", flush=True)
        native.reset_launches()
        mode = _OnCard()
        with mode:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = laplace.run("gridsearch", args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        saved = np.load(f"{out}/s1_gridsearch.npz")
        files = {k: (str(saved[k].dtype), saved[k].shape) for k in saved.files}
    mode.check("slice-laplace-grid")
    _no_kernel_launched("slice-laplace-grid")
    values, losses, stds = result["values"], result["losses"], result["stds"]
    bias = laplace.jax_float32_dot_bias(fix["grid_probes"])
    jax32 = fix["grid_values"] - bias
    gap64 = np.abs(values / fix["grid_values_f64"] - 1.0)
    gap32 = np.abs(values / jax32 - 1.0)
    std_gap = np.abs(stds / fix["grid_stds_f64"] - 1.0)
    tpu = _laplace_tpu_file("plot_callibration_loss/s1_gridsearch.npz")
    for i, log_alpha in enumerate(args.log_alphas):
        print(f"  log alpha {log_alpha:+.1f}: loss {losses[i]:.4f} +- {stds[i]:.4f}; JAX f64 "
              f"{fix['grid_losses_f64'][i]:.4f} +- {fix['grid_stds_f64'][i]:.4f}, JAX f32 {fix['grid_losses'][i]:.4f} "
              f"+- {fix['grid_stds'][i]:.4f}; committed TPU {tpu['losses'][i]:.4f} +- {tpu['stds'][i]:.4f} (no gate)",
              flush=True)
    ok_loss, ok32 = bool(np.all(gap64 <= TOL_GRID_LOSS)), bool(np.all(gap32 <= TOL_GRID_F32))
    ok_std = bool(np.all(std_gap <= TOL_GRID_STD))
    print(f"  each of the 45 losses: max rel gap to JAX f64 {gap64.max():.3e} (tol {TOL_GRID_LOSS:.0e}) "
          f"{'ok' if ok_loss else 'FAIL'}; to JAX f32 less its start-vector dot bias {bias.min():.6f}-"
          f"{bias.max():.6f}: max rel gap {gap32.max():.3e} (tol {TOL_GRID_F32:.0e}; without the correction "
          f"{np.abs(values / fix['grid_values'] - 1.0).max():.3e}) {'ok' if ok32 else 'FAIL'}; "
          f"stds max rel gap to JAX f64 {std_gap.max():.3e} (tol {TOL_GRID_STD:.0e}) {'ok' if ok_std else 'FAIL'}; "
          f"{wall:.2f} s wall (45 losses at the fixture's MAP); file {files}", flush=True)
    failures += [label for label, ok in (("losses vs f64", ok_loss), ("losses vs f32", ok32), ("stds", ok_std))
                 if not ok]
    if failures:
        raise RuntimeError(f"slice-laplace-grid failed: {failures}")
    return {"wall_s": wall, "gap64": float(gap64.max()), "gap32": float(gap32.max()), "std_gap": float(std_gap.max())}


def phase_slice_laplace_full():
    """``python -m lanczos_adjoints_tpu_torch.train.laplace callibration`` at
    ``train.laplace.FULL_WIDTH_ARGS`` (the MLP 256 -> 2048 -> 1536 -> 10,
    3,688,970 parameters, 512 points, 200 MAP epochs, rank 10, 10 probes; the
    RMSprop epochs at 0.1 cut from 30 to ``LAPLACE_FULL_EPOCHS``, to make room
    for ``[slice]``'s epochs on the JAX draws) on the port's own data: finite, the final loss under
    half the first; one float32 step against the same step in float64 (same
    probes); one step at rank 50; the device's time per epoch (CUDA events),
    one profiled epoch and the peak memory."""
    import argparse

    from lanczos_adjoints_tpu_torch.models import bnn
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.train import laplace
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    failures = []
    with tempfile.TemporaryDirectory() as out:
        args = laplace.build_argparser(argparse.ArgumentParser(), "callibration").parse_args(
            [*laplace.FULL_WIDTH_ARGS, "--num_epochs", str(LAPLACE_FULL_EPOCHS), "--seed", "1", "--device",
             DEVICE, "--out", out])
        print(f"[slice-laplace-full] train.laplace callibration {' '.join(laplace.FULL_WIDTH_ARGS)} --num_epochs "
              f"{LAPLACE_FULL_EPOCHS} --seed 1 on the port's numpy data", flush=True)
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        mode = _OnCard()
        with mode:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = laplace.run("callibration", args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            on_card = result["params_map"].is_cuda
        files = sorted(os.listdir(out))
    mode.check("slice-laplace-full")
    _no_kernel_launched("slice-laplace-full")
    curve = np.asarray(result["curve"])
    print(f"  {result['n_params']:,} parameters; MAP loss {result['map_loss']:.4f}; curve {curve[0]:.1f} -> "
          f"{curve[-1]:.1f} over {len(curve)} epochs, alpha {result['alpha']:.5f}; run {wall:.2f} s wall; "
          f"files {files}", flush=True)
    committed = _laplace_tpu_file("callibration/s1_p3688970_rank10_curve.npy")
    if committed is not None:
        print(f"  the committed JAX run (TPU, its own data; no gate): {committed[0]:.1f} -> {committed[-1]:.1f}, "
              f"alpha {float(_laplace_tpu_file('callibration/s1_p3688970_rank10_alpha.npy')):.5f}", flush=True)
    if result["n_params"] != 3_688_970 or not on_card:
        failures.append(f"n_params {result['n_params']}, on the card {on_card}")
    if not (np.all(np.isfinite(curve)) and np.isfinite(result["alpha"])):
        failures.append("non-finite loss or alpha")
    if not curve[-1] < 0.5 * curve[0]:
        failures.append(f"final loss {curve[-1]} not under half of the first {curve[0]}")

    apply, unflatten, _init, x, y, _ = laplace.problem(args, "callibration", None)
    params = result["params_map"]
    n = params.shape[0]
    loss = bnn.callibration_loss(apply, unflatten, torch.exp, n, lanczos_rank=args.lanczos_rank,
                                 slq_num_samples=args.slq_num_samples)
    generator = torch.Generator(device=DEVICE).manual_seed(2)
    state = {"log_alpha": torch.zeros((), device=DEVICE)}
    optimizer = laplace.RMSprop(state["log_alpha"], args.learning_rate)

    def epoch():
        value, grad = laplace.value_and_grad(loss, state["log_alpha"], params, x, y, generator)
        state["log_alpha"] = optimizer.update(state["log_alpha"], grad)
        return float(value)

    epoch()
    epoch_ms = events_ms(epoch, 3)
    step_ms = laplace.time_step(args, apply, unflatten, params, x, y)
    print(f"  one epoch (value_and_grad over 10 probes x rank 10, the RMSprop update, the loss read back): "
          f"{epoch_ms:.2f} ms on the device (CUDA events, 3 epochs); the driver's --time reading of one "
          f"value_and_grad {step_ms:.2f} ms", flush=True)
    profile = _print_profile("one calibration epoch at 3,688,970 parameters", epoch)

    bits = torch.randint(0, 2, (args.slq_num_samples, n), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(3))
    probes = (2 * bits - 1).to(params.dtype)
    zero = torch.zeros((), device=DEVICE)
    v32, g32 = laplace.value_and_grad(loss, zero, params, x, y, probes)
    v64, g64 = laplace.value_and_grad(loss, zero.double(), params.double(), x.double(), y.double(),
                                      probes.double())
    errs = {"loss": abs(float(v32) / float(v64) - 1.0), "grad": abs(float(g32) / float(g64) - 1.0)}
    print(f"  one step at log alpha 0, float32 vs float64 (same probes): loss {float(v32):.4f} vs "
          f"{float(v64):.4f} (rel {errs['loss']:.2e}, tol {TOL_LAPLACE_F64['loss']:.0e}), d/dlog alpha "
          f"{float(g32):.4f} vs {float(g64):.4f} (rel {errs['grad']:.2e}, tol {TOL_LAPLACE_F64['grad']:.0e})",
          flush=True)
    failures += [f"float32 vs float64 {k}" for k, e in errs.items() if not e <= TOL_LAPLACE_F64[k]]

    wide = bnn.callibration_loss(apply, unflatten, torch.exp, n, lanczos_rank=LAPLACE_RANK_WIDE,
                                 slq_num_samples=args.slq_num_samples)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v50, g50 = laplace.value_and_grad(wide, zero, params, x, y, probes)
    torch.cuda.synchronize()
    t50 = time.perf_counter() - t0
    print(f"  one step at rank {LAPLACE_RANK_WIDE}: loss {float(v50):.4f}, d/dlog alpha {float(g50):.4f}, "
          f"finite {bool(torch.isfinite(v50) and torch.isfinite(g50))}; {t50:.2f} s wall", flush=True)
    if not bool(torch.isfinite(v50) and torch.isfinite(g50)):
        failures.append(f"rank {LAPLACE_RANK_WIDE} step not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory allocated over the phase: {peak:.2f} GiB", flush=True)
    if failures:
        raise RuntimeError(f"slice-laplace-full failed: {failures}")
    return {"curve": curve.tolist(), "alpha": result["alpha"], "epoch_ms": epoch_ms, "step_ms": step_ms,
            "wall_s": wall,
            "f64_errs": errs, "rank50_s": t50, "peak_gib": peak,
            "profile": None if profile is None else {k: profile[k] for k in ("wall_ms", "busy_ms", "top")}}


# The paper's studies (``lanczos_adjoints_tpu_torch.studies``), each run at its
# JAX script's defaults; the wall-time sweeps at the 128 x 128 Laplacian.
WALL_TIMES_SWEEPS = (("lanczos", "none"), ("lanczos", "full"), ("arnoldi", "none"))
STUDY_N = 16_384  # the Gram VJP and MLL studies' N
STUDY_GRAM_SIZES = (4096, 16_384, 65_536)
# vmap against partitioned(16) in the MLL study: the same arithmetic in
# another order, through 10 CG and 2 x 10 Lanczos steps in float32.
TOL_MLL_POLICIES = 1e-3


def phase_study_orthogonality():
    """``studies.loss_of_orthogonality measure`` in float64 on the card, at
    the JAX script's sizes; the rows of n = 4, 8, 12 held to the committed
    JAX rows within 10x JAX's own one-ulp spread (C10), those of n = 16
    and 24 to finite values and ``err_proj`` at most 2."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.studies import loss_of_orthogonality as study

    print(f"[study-orthogonality] Arnoldi adjoint with and without re-projection against backprop on "
          f"Hilbert matrices, float64 on the card, n in {study.SIZES}; rows held to the committed JAX rows "
          f"within {study.SPREAD_FACTOR:.0f}x JAX's one-ulp spread, the others to finite values and err_proj "
          f"at most {study.UNREFERENCED_PROJ_BOUND:g}", flush=True)
    native.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        start = time.perf_counter()
        rows = study.main(["measure", "--device", DEVICE, "--out", out])
        seconds = time.perf_counter() - start
        files = sorted(os.listdir(out))
    _no_kernel_launched("[study-orthogonality]")
    failures = [] if files == ["orthogonality.json"] else [f"files {files}"]
    for n, key, value, ref, tol, ok in study.check_rows(rows):
        held = (f"JAX committed {ref:.4e}, gap {abs(value - ref):.3e}, tol {tol:.3e}" if ref is not None
                else "no committed row: finite" + (f", at most {tol:g}" if np.isfinite(tol) else ""))
        print(f"  n={n} {key}: {value:.4e} ({held}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"n={n} {key}")
    print(f"  wall {seconds:.2f} s", flush=True)
    if failures:
        raise RuntimeError(f"study-orthogonality failed: {failures}")
    return rows


def _wall_times_events(which, reortho, custom):
    prefix = ["tridiag:arnoldi_full"] if which == "lanczos" and reortho == "full" else []
    if which == "lanczos" and reortho == "none":
        return ["tridiag:dia_fused" if custom else "tridiag:generic"]
    return sorted(prefix + ["hessenberg:dia_fused" if custom else "hessenberg:generic"])


def phase_study_wall_times():
    """``studies.wall_times_vjp benchmark`` at the 128 x 128 Laplacian and the
    JAX script's depths for each of ``WALL_TIMES_SWEEPS``: dispatch, launches
    of one call per depth and series against the prediction, finite times."""
    from lanczos_adjoints_tpu_torch.studies import wall_times_vjp as study

    totals, runs = {}, {}
    for which, reortho in WALL_TIMES_SWEEPS:
        tag = f"{which}_laplacian_2d_reortho_{reortho}"
        print(f"[study-wall-times] {tag}, {study.GRID}x{study.GRID}: forward, closed-form VJP and "
              f"backprop VJP (K <= 100) at K in {study.DEPTHS}, all-ones cotangent (CUDA events, median of "
              f"{study.OUTER} runs of {study.REPS} calls)", flush=True)
        with tempfile.TemporaryDirectory() as out:
            start = time.perf_counter()
            result = study.main(["benchmark", "--which", which, "--reortho", reortho, "--device", DEVICE,
                                 "--depths", *map(str, study.DEPTHS), "--out", out])
            seconds = time.perf_counter() - start
            files = sorted(os.listdir(out))
        failures = []
        want_files = sorted(f"{tag}_{s}.npy" for s in ("depths", "dispatch", "times_autodiff", "times_custom",
                                                          "times_fwdpass"))
        if files != want_files:
            failures.append(f"files {files}")
        by_series = result["dispatch_by_series"]
        want_events = {s: _wall_times_events(which, reortho, s != "autodiff") for s in study.SERIES}
        print(f"  dispatch {by_series} (JAX's names {[study.JAX_EVENTS[e] for e in result['dispatch']]})",
              flush=True)
        if by_series != want_events:
            failures.append(f"dispatch {by_series}, expected {want_events}")
        for (depth, series), got in sorted(result["launches"].items()):
            want = study.predicted_launches(which, reortho, depth, series)
            if got != want:
                failures.append(f"K={depth} {series} launches {got}, predicted {want}")
            for name, count in got.items():
                totals[name] = totals.get(name, 0) + count
        times = result["times"]
        for i, depth in enumerate(result["depths"]):
            row = {s: times[s][i] * 1e3 for s in study.SERIES if i < len(times[s])}
            calls = {s: result["launches"][(depth, s)] for s in row}
            values = {s: result["values"][(depth, s)] for s in ("custom", "autodiff") if s in row}
            # Values are held where backprop runs beside them; deeper, the
            # float32 Arnoldi adjoint is an open question (ROADMAP) and is timed only.
            gated = "autodiff" in values
            finite = all(bool(torch.isfinite(g).all()) for vals in values.values() for g in vals)
            text = ", ".join(f"{s} {ms:.3f} ms" for s, ms in row.items())
            if "autodiff" in values:
                gap = _rel_err(values["custom"][0], values["autodiff"][0])
                text += f"; backprop/adjoint {row['autodiff'] / row['custom']:.2f}x, dv adjoint vs backprop {gap:.2e}"
            text += f"; max|dv| {float(values['custom'][0].abs().max()):.4e}; launches {calls}"
            print(f"  K={depth}: {text}{'' if gated else ' (values timed, not gated)'}",
                  flush=True)
            if not all(np.isfinite(ms) and ms > 0 for ms in row.values()):
                failures.append(f"K={depth} times {row}")
            if gated and not finite:
                failures.append(f"K={depth} values not finite")
        print(f"  wall {seconds:.2f} s", flush=True)
        if failures:
            raise RuntimeError(f"study-wall-times {tag} failed: {failures}")
        runs[tag] = result["times"]
    print(f"  launches over the three sweeps (one call per depth and series): {totals}", flush=True)
    return {"launches": totals, "times": runs}


def phase_study_vjp_matvec():
    """``studies.vjp_through_matvec`` at its defaults (N = 16,384, d = 2):
    the recomputing backward pass against autodiff, the JAX script's 1e-3."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.studies import vjp_through_matvec as study

    print(f"[study-vjp-matvec] Gram matvec (rbf, N={STUDY_N}, d=2): autodiff through the plain policy against the "
          f"recompute-in-backward Function, gradients within {study.TOL_AGREEMENT:.0e}", flush=True)
    native.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        results, _grads, rel = study.main(["--num_data", str(STUDY_N), "--device", DEVICE, "--out", out])
        files = sorted(os.listdir(out))
    _no_kernel_launched("[study-vjp-matvec]")
    failures = [] if files == ["vjp_times.json"] else [f"files {files}"]
    if not rel < study.TOL_AGREEMENT:
        failures.append(f"agreement {rel:.3e}")
    if [r["variant"] for r in results] != ["autodiff", "custom_vjp"] or not all(
            np.isfinite(r["time_s"]) and r["time_s"] > 0 for r in results):
        failures.append(f"results {results}")
    print(f"  gradient agreement {rel:.3e}; " + ", ".join(f"{r['variant']} {r['time_s'] * 1e3:.3f} ms"
                                                         for r in results), flush=True)
    if failures:
        raise RuntimeError(f"study-vjp-matvec failed: {failures}")
    return results


def phase_study_mll():
    """``studies.value_and_grad_of_mll`` at its defaults (N = 16,384, d = 4, 10
    matvecs, 2 samples): both policies, finite, and agreeing."""
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.studies import value_and_grad_of_mll as study

    print(f"[study-mll] value_and_grad of the GP log-marginal likelihood (matern32, N={STUDY_N}, d=4, CG 10, SLQ 10 x "
          "2 probes from numpy) under vmap and partitioned(16)", flush=True)
    native.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        results, outputs = study.main(["--num_data", str(STUDY_N), "--device", DEVICE, "--out", out])
        files = sorted(os.listdir(out))
    _no_kernel_launched("[study-mll]")
    failures = [] if files == ["mll_times.json"] else [f"files {files}"]
    if [r["policy"] for r in results] != ["vmap", "partitioned(16)"] or not all(
            np.isfinite(r["time_s"]) and r["time_s"] > 0 for r in results):
        failures.append(f"results {results}")
    for name, (value, grads) in outputs.items():
        print(f"  {name}: -logml {float(value):.6f}, grads "
              f"{ {k: g.cpu().numpy().round(6).tolist() for k, g in grads.items()} }", flush=True)
        if not (torch.isfinite(value) and all(bool(torch.isfinite(g).all()) for g in grads.values())):
            failures.append(f"{name} not finite")
    if len(outputs) == 2:
        (v1, g1), (v2, g2) = outputs.values()
        gaps = [abs(float(v2) / float(v1) - 1.0)] + [_rel_err(g2[k], g1[k]) for k in g1]
        print(f"  partitioned vs vmap: value {gaps[0]:.3e}, grads {max(gaps[1:]):.3e} (tol {TOL_MLL_POLICIES:.0e})",
              flush=True)
        if not max(gaps) <= TOL_MLL_POLICIES:
            failures.append(f"policies disagree {gaps}")
    print("  " + ", ".join(f"{r['policy']} {r['time_s'] * 1e3:.1f} ms" for r in results), flush=True)
    if failures:
        raise RuntimeError(f"study-mll failed: {failures}")
    return results


def phase_study_gram_matvec():
    """``studies.gram_matvec benchmark`` at its defaults (N = 4,096, 16,384,
    65,536, d = 1): K1 at every N, held to the plain policies that ran."""
    from lanczos_adjoints_tpu_torch.studies import gram_matvec as study

    print(f"[study-gram-matvec] rbf Gram matvec, d=1, N in {STUDY_GRAM_SIZES}: vmap, partitioned(16) and K1 "
          f"(CUDA events, median of {study.OUTER} runs of {study.REPS} matvecs; a plain policy out of memory is "
          "recorded as failed)", flush=True)
    with tempfile.TemporaryDirectory() as out:
        rows, outputs, launches = study.main(["benchmark", "--data_sizes", *map(str, STUDY_GRAM_SIZES),
                                              "--device", DEVICE, "--out", out])
        table = study.show_table(out)
    failures = []
    for n in STUDY_GRAM_SIZES:
        fused = outputs.get(("synthetic", n, study.FUSED))
        if fused is None or launches.get(("synthetic", n)) != 1:
            failures.append(f"N={n}: K1 did not run once ({launches.get(('synthetic', n))})")
            continue
        for policy in ("vmap", "partitioned(16)"):
            plain = outputs.get(("synthetic", n, policy))
            if plain is None:
                print(f"  N={n} {policy}: failed (no output to hold K1 to)", flush=True)
                continue
            err = _rel_err(fused, plain)
            _report(f"K1 vs {policy} N={n}", err, TOL_K1, failures)
    if not all(np.isfinite(r["time_s"]) and r["time_s"] > 0 for r in rows):
        failures.append("times")
    print(f"  table rows {len(table.splitlines()) - 2}; K1 launches (one call a size) {launches}", flush=True)
    if failures:
        raise RuntimeError(f"study-gram-matvec failed: {failures}")
    return {"rows": rows, "launches": sum(launches.values())}


# The sparse-format and roofline studies (A17) and the scaling study (A18),
# at their JAX scripts' defaults: the roofline at both committed sizes.
ROOFLINE_SIDES = (1024, 2048)
# K12 is held bit for bit to its plain version on these besides the
# roofline's shapes: n % 4 != 0 (the scalar tail) at 5 diagonals.
K12_TAIL_N = 1_000_003
# K4 L2-cold in [study-dia-roofline] against its [timing-sparse] time.
TOL_K4_AGREEMENT = 0.2
TOL_FORMATS = 1e-5  # dia_kernel vs dia, bsr_kernel vs bsr (TOL_DIA, TOL_BSR)


def _k12_bitwise(study, n, num_diags, rng, failures):
    """K12 (``speed_of_light``) against ``dia_ceiling_plain``, bit for bit, at
    every block size: aligned operands, x and the output one float off 16
    bytes (the scalar loop), and the values one float off (their rows read as
    scalars in the vector loop). Returns the largest absolute error."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd

    x = _tensor(rng, n)
    vals = _tensor(rng, (num_diags, n))
    x_off = _offset_by_one(x)
    vals_off = torch.empty(num_diags * n + 1, device=DEVICE)[1:].view(num_diags, n)
    vals_off.copy_(vals)
    worst = 0.0
    for label, (xs, vs) in {"aligned": (x, vals), "x misaligned": (x_off, vals),
                            "values misaligned": (x, vals_off)}.items():
        want = fd.dia_ceiling_plain(xs, vs)
        for threads in fd.CEILING_THREADS:
            got = study.speed_of_light(n, num_diags, threads)(xs, vs)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                failures.append(f"K12 n={n} {label} threads={threads}: max abs err {err:.3e}")
    print(f"  K12 n={n} D={num_diags}: aligned, x misaligned, values misaligned at threads "
          f"{fd.CEILING_THREADS}: {'bit for bit' if worst == 0.0 else f'max abs err {worst:.3e}'}", flush=True)
    return worst


def _roofline_line(label, row):
    return (f"{label} {row['time_s'] * 1e6:.2f} us L2-warm, {row['time_s_l2_cold'] * 1e6:.2f} us L2-cold "
            f"({row['clock']})")


def phase_study_dia_roofline(k4_timing_ms):
    """``studies.dia_roofline`` at n_side 1024 and 2048: K12 at every block
    size, K4, the plain matvec and cuSPARSE, L2-warm and L2-cold, with the
    launches against the prediction; K12 bit for bit against its plain
    version; K4 L2-cold at 1024^2 within 20 % of [timing-sparse]'s K4.
    Returns K12's kernels-line entry."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.ops import native
    from lanczos_adjoints_tpu_torch.studies import dia_roofline as study

    print(f"[study-dia-roofline] K12 (csrc/dia_ceiling.cu) at threads {fd.CEILING_THREADS} against K4, plain "
          f"and cuSPARSE at n_side {ROOFLINE_SIDES}; device time per call (events behind a held stream, {study.REPS} calls), "
          f"L2-warm (one operand set) and L2-cold ({study.OPERAND_SETS} sets)", flush=True)
    native.reset_launches()
    artifacts = {}
    with tempfile.TemporaryDirectory() as out:
        for side in ROOFLINE_SIDES:
            artifacts[side] = study.main(["--n_side", str(side), "--device", DEVICE, "--out", out])
        files = sorted(os.listdir(out))
    torch.cuda.synchronize()
    counts = native.launch_counts()
    want = {k: c * len(ROOFLINE_SIDES) for k, c in study.predicted_launches().items()}
    got = {k: c for k, c in counts.items() if c}
    failures = [] if files == sorted(f"dia_roofline_n{s}.json" for s in ROOFLINE_SIDES) else [f"files {files}"]
    print(f"  launches {got} (predicted {want}) {'ok' if got == want else 'FAIL'}", flush=True)
    if got != want:
        failures.append(f"launches {got}")
    for side, art in artifacts.items():
        bound_us = 1e6 * art["bytes_per_matvec"] / PEAK_BYTES
        print(f"  n_side={side}: n={art['n']} D={art['num_diags']} {art['bytes_per_matvec']} B "
              f"({art['bytes_per_nnz']:.4f} B/nnz), bound {bound_us:.2f} us", flush=True)
        for threads, row in art["ceiling"].items():
            print("    " + _roofline_line(f"K12 threads={threads}:", row)
                  + f", {100 * bound_us * 1e-6 / row['time_s_l2_cold']:.1f} % of the bound L2-cold", flush=True)
        print("    " + _roofline_line("K12 plain:", art["ceiling_plain"]) + "; "
              + _roofline_line("library x + vals.sum(0):", art["ceiling_library"]), flush=True)
        for row in art["sweep"]:
            print("    " + _roofline_line(f"{row['matvec']}:", row), flush=True)
        for suffix, label in (("", "L2-warm"), ("_l2_cold", "L2-cold")):
            ratio = art[f"pct_of_attainable{suffix}_unclamped"]
            note = ("; the ceiling is no ceiling: the matvec beat K12" if ratio > 1.0 else "")
            print(f"    {label}: pct_of_attainable {art[f'pct_of_attainable{suffix}']:.4f} (unclamped {ratio:.4f}, "
                  f"best {art[f'best{suffix}']['matvec']}){note}", flush=True)
        print(f"    hbm floor {art['hbm_floor_s'] * 1e6:.2f} us at {art['hbm_spec_gb_per_s']:.0f} GB/s; "
              f"l2_resident_regime {art['l2_resident_regime']}", flush=True)
        times = [r[k] for r in [*art["ceiling"].values(), art["ceiling_plain"], art["ceiling_library"],
                                *art["sweep"]] for k in ("time_s", "time_s_l2_cold")]
        if not all(np.isfinite(t) and t > 0 for t in times):
            failures.append(f"n_side={side} times")
    main = artifacts[ROOFLINE_SIDES[0]]  # the 1024^2 Laplacian, [timing-sparse]'s K4 shape
    k4_cold_ms = 1e3 * next(r for r in main["sweep"] if r["matvec"] == "k4")["time_s_l2_cold"]
    gap = abs(k4_cold_ms - k4_timing_ms) / k4_timing_ms
    print(f"  K4 L2-cold at 1024^2: {k4_cold_ms * 1e3:.2f} us here, {k4_timing_ms * 1e3:.2f} us in [timing-sparse]: "
          f"{100 * gap:.1f} % apart (limit {100 * TOL_K4_AGREEMENT:.0f} %) "
          f"{'ok' if gap <= TOL_K4_AGREEMENT else 'FAIL'}", flush=True)
    if not gap <= TOL_K4_AGREEMENT:
        failures.append("K4 against [timing-sparse]")
    rng = np.random.default_rng(19)
    worst = max(_k12_bitwise(study, n, 5, rng, failures) for n in [s * s for s in ROOFLINE_SIDES] + [K12_TAIL_N])
    if failures:
        raise RuntimeError(f"study-dia-roofline failed: {failures}")
    n, num_diags, nbytes = main["n"], main["num_diags"], main["bytes_per_matvec"]
    bound_ms, by = _bound(nbytes, num_diags * n)
    row = main["ceiling"]["256"]
    return {
        "name": "dia_ceiling", "route": "cuda", "source": "lanczos_adjoints_tpu_torch/csrc/dia_ceiling.cu",
        "replaces": "experiments/benchmarks/spmv_formats/dia_roofline.py:62",
        "launches": got.get("dia_ceiling", 0), "max_abs_err": worst,
        "ms": 1e3 * row["time_s_l2_cold"], "ms_l2_warm": 1e3 * row["time_s"], "clock": row["clock"],
        "plain_ms": 1e3 * main["ceiling_plain"]["time_s_l2_cold"], "bound_ms": bound_ms, "bound_by": by,
        "library_ms": 1e3 * main["ceiling_library"]["time_s_l2_cold"],
        "library_call": main["ceiling_library"]["calls"], "n": n, "threads": 256,
        "by_threads": {side: {t: {"ms_l2_cold": 1e3 * r["time_s_l2_cold"], "ms_l2_warm": 1e3 * r["time_s"]}
                              for t, r in art["ceiling"].items()} for side, art in artifacts.items()},
        "bound_ms_by_side": {side: _bound(art["bytes_per_matvec"], art["num_diags"] * art["n"])[0]
                             for side, art in artifacts.items()},
        "pct_of_attainable": {side: {"l2_warm": art["pct_of_attainable_unclamped"],
                                     "l2_cold": art["pct_of_attainable_l2_cold_unclamped"]}
                              for side, art in artifacts.items()},
        "launches_other": {k: c for k, c in got.items() if k != "dia_ceiling"},
    }


def phase_study_spmv_formats():
    """``studies.spmv_formats`` at its defaults: every row timed, the kernels'
    rows within 1e-5 of the plain ones (matvec and VJP in x), one matvec and
    one VJP launching exactly the predicted kernels."""
    from lanczos_adjoints_tpu_torch.studies import spmv_formats as study

    print("[study-spmv-formats] DIA (plain, K4), BSR (plain, K10) and ELL at the JAX script's cases: grid 1024 and "
          "256, FEM 24 plain and RCM, random 65,536 x 8; matvec and VJP in x, device time per call", flush=True)
    with tempfile.TemporaryDirectory() as out:
        rows, outputs, launches = study.main(["--device", DEVICE, "--out", out])
        files = sorted(os.listdir(out))
    failures = [] if files == ["formats.json"] else [f"files {files}"]
    want_rows = [(c, f) for c, fmts in (("laplacian_2d", ("dia", "dia_kernel")),
                                         ("laplacian_2d_small", ("dia", "dia_kernel", "ell")),
                                         ("fem_3dof", ("bsr", "bsr_kernel")), ("fem_3dof_rcm", ("bsr", "bsr_kernel")),
                                         ("random", ("ell", "ell_gather"))) for f in fmts]
    if [(r["case"], r["format"]) for r in rows] != want_rows:
        failures.append(f"rows {[(r['case'], r['format']) for r in rows]}")
    for r in rows:
        if not all(r[k] is not None and np.isfinite(r[k]) and r[k] > 0 for k in ("time_s", "time_vjp_s")):
            failures.append(f"{r['case']}/{r['format']} times")
    gather = next(r for r in rows if r["format"] == "ell_gather")
    if gather.get("same_as") != "ell":
        failures.append("ell_gather not labelled as ell")
    for (case, fmt), counts in launches.items():
        want = study.predicted_launches(fmt)
        ok = counts == want
        print(f"  {case}/{fmt}: launches {counts} (predicted {want}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{case}/{fmt} launches")
    for case, plain, kernel in (("laplacian_2d", "dia", "dia_kernel"), ("laplacian_2d_small", "dia", "dia_kernel"),
                                ("fem_3dof", "bsr", "bsr_kernel"), ("fem_3dof_rcm", "bsr", "bsr_kernel")):
        for i, what in enumerate(("matvec", "VJP in x")):
            _report(f"{case} {kernel} vs {plain} {what}", _rel_err(outputs[(case, kernel)][i],
                                                                   outputs[(case, plain)][i]),
                    TOL_FORMATS, failures)
    for r in rows:
        print(f"  {r['case']}/{r['format']}: {r['time_s'] * 1e3:.4f} ms/matvec, vjp {r['time_vjp_s'] * 1e3:.4f} ms, "
              f"{r['nnz_per_s'] / 1e9:.2f} Gnnz/s, fill {r['fill']:.4f}"
              + (" (the same function as ell)" if r.get("same_as") else "")
              + (" (unresolved: the host held the device back; upper bounds)" if r.get("unresolved") else ""),
              flush=True)
    if failures:
        raise RuntimeError(f"study-spmv-formats failed: {failures}")
    totals = {}
    for (case, fmt), counts in launches.items():
        if fmt != "ell_gather":
            for part in counts.values():
                for k, c in part.items():
                    totals[k] = totals.get(k, 0) + c
    return {"rows": rows, "launches": totals}


def phase_study_multihost():
    """``studies.multihost_scaling``: ``--measure_local`` (K1 and K4 local
    tables, the link stand-ins, the model on the card), then the measured
    path on 1-16 partitions of one card, its ``dv`` and ``dvals`` held to the
    unsharded fused route, 2 x depth K11 launches a VJP."""
    from lanczos_adjoints_tpu_torch.ops import native, sparse
    from lanczos_adjoints_tpu_torch.studies import multihost_scaling as study
    from lanczos_adjoints_tpu_torch.utils import test_util

    depth = HALO_DEPTH
    print(f"[study-multihost] --measure_local (K1 matern32 at 65,536 x d=9 and K4 at n=2^20 / P over "
          f"{study.MEASURE_GRID}), the model, then the measured path on {study.MESH_SIZES} partitions of one card "
          f"(K={depth}, reps 4)", flush=True)
    failures = []
    with tempfile.TemporaryDirectory() as out:
        native.reset_launches()
        artifact, _ = study.main(["--measure_local", "--device", DEVICE, "--out", out])
        torch.cuda.synchronize()
        local = _launches(("gram_matvec", "dia_matvec"))
        per_point = {"gram_matvec": 1 + study.MEASURE_REPEATS * study.REPS, "dia_matvec": 1 + study.REPS}
        want = {k: c * len(study.MEASURE_GRID) for k, c in per_point.items()}
        print(f"  local launches {local} (predicted {want}) {'ok' if local == want else 'FAIL'}", flush=True)
        if local != want:
            failures.append("local launches")
        artifact, (rows, grads, launches) = study.main(["--device", DEVICE, "--out", out])
        files = sorted(os.listdir(out))
    if files != ["scaling.json"]:
        failures.append(f"files {files}")
    model, link = artifact["comm_model"], artifact["local_steps"]["link"]
    fits = model["assumptions"]["local_cost_fit"]
    print(f"  link stand-ins ({link['device']}): copy_ {link['copy_bytes_per_s'] / 1e9:.1f} GB/s, launch + "
          f"synchronise {link['launch_sync_latency_s'] * 1e6:.2f} us", flush=True)
    for name in ("gram", "dia"):
        fit = fits[name]
        print(f"  {name} fit: {fit}", flush=True)
        if fit.get("unresolved"):
            failures.append(f"{name} fit unresolved")
    print(f"  80 % regimes: {model['efficiency_80_regime']}", flush=True)
    if not (model["gram_flagship"] and model["dia_lanczos"]):
        failures.append("model rows missing")
    n = HALO_N  # the script's --num_rows and --bandwidth defaults
    mat = test_util.five_diagonal(n, HALO_BANDWIDTH)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device=DEVICE)
    v0 = torch.ones(n, device=DEVICE)
    _unsharded, want_grads, spreads, log_u = _halo_reference(mat, dia, vals, v0, depth)
    if log_u != ["tridiag:dia_fused"]:
        failures.append(f"unsharded dispatch {log_u}")
    want_launches = {"halo_dia_matvec": 2 * depth}
    for row in rows:
        p = row["devices"]
        ok = launches[p] == want_launches
        print(f"  P={p}: {row['time_s'] * 1e3:.3f} ms a VJP, efficiency {row['efficiency']:.3f}, "
              f"{row['many_over_one']:.2f}x for 4 VJPs over one; launches {launches[p]} (predicted "
              f"{want_launches}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"P={p} launches")
        if not (np.isfinite(row["time_s"]) and row["time_s"] > 0):
            failures.append(f"P={p} time")
        for label, i in (("dv", 0), ("dvals", 1)):
            _report_spread(f"P={p} measured path vs unsharded fused {label}", _rel_err(grads[p][i], want_grads[i]),
                           _rel_err(spreads[0][i], spreads[1][i]), failures)
    if failures:
        raise RuntimeError(f"study-multihost failed: {failures}")
    totals = {**local}
    totals["halo_dia_matvec"] = sum(c.get("halo_dia_matvec", 0) for c in launches.values())
    return {"rows": rows, "launches": totals}


def phase_study_mtx_parser(n=MTX_PARSER_ROWS, nnz_per_row=8):
    """``studies.mtx_parser`` at ``MTX_PARSER_ROWS`` rows (the JAX script's
    1,000,000 cut in half) and its 8 entries a row: the synthetic
    ``.mtx`` file read by scipy, the port's C++ parser (``native/``, built
    here by the host compiler) and numpy, the same CSR from all three (the
    study raises otherwise), each path's MB/s. Host work on the machine
    that holds the card: no tensor, no kernel."""
    from lanczos_adjoints_tpu_torch import native
    from lanczos_adjoints_tpu_torch.studies import mtx_parser

    print(f"[study-mtx-parser] studies.mtx_parser --n {n} --nnz_per_row {nnz_per_row}: scipy (best of 3), the C++ "
          f"parser (scipy off), numpy (native.DISABLE); file to CSR on the host", flush=True)
    start = time.perf_counter()
    library = native.build()
    print(f"  parser library {library.name} ready in {time.perf_counter() - start:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as out:
        result = mtx_parser.main(["--n", str(n), "--nnz_per_row", str(nnz_per_row),
                                  "--out", os.path.join(out, "mtx_parser.json")])
    rates = result["mb_per_s"]
    print(f"  {result['file_bytes'] / 1e6:.1f} MB, {result['nnz']} nnz after duplicates: scipy {rates['scipy']:.1f} "
          f"MB/s, C++ {rates['native']:.1f} MB/s, numpy {rates['numpy']:.1f} MB/s; the three CSRs equal",
          flush=True)
    times = list(result["seconds"].values())
    if not all(np.isfinite(t) and t > 0 for t in times) or result["nnz"] <= 0:
        raise RuntimeError(f"study-mtx-parser: seconds {result['seconds']}, nnz {result['nnz']}")
    return {k: v for k, v in result.items() if k != "csr"}


def phase_slice_gp_report(results, driver):
    """``train.gp_report``'s table of the ``[slice-driver]`` run's files, its
    rows labelled with the card's name, and the figure where matplotlib is."""
    from lanczos_adjoints_tpu_torch.train import gp_report

    label = torch.cuda.get_device_name(0)
    print(f"[slice-gp-report] train.gp_report table --name adj400k on the [slice-driver] run's files, "
          f"--label {label!r}", flush=True)
    text = gp_report.show_table("adj400k", results, label=label)
    rmse, nll = (f"{driver[key]:.3f} +/- 0.000" for key in ("test_rmse", "test_nll"))
    want = f"{'synthetic_gp500k':>18} | {label:>22} | {rmse:>16} | {nll:>16} |"
    if not any(line.startswith(want) for line in text.splitlines()):
        raise RuntimeError(f"slice-gp-report: no row {want!r} in\n{text}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("  figure: matplotlib is not installed here; not drawn", flush=True)
    else:
        gp_report.plot_training("adj400k", results, results)
    return text


def _phase(fn, *args):
    """``fn(*args)``, with its wall time printed after it."""
    start = time.perf_counter()
    out = fn(*args)
    print(f"[phase-time] {fn.__name__}: {time.perf_counter() - start:.1f} s", flush=True)
    return out


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"[card] {card}", flush=True)
    from lanczos_adjoints_tpu_torch.utils.precision import pin_float32

    pin_float32()
    _phase(phase_build)
    _phase(phase_parity)
    _phase(phase_oracle)
    counts = _phase(phase_slice, N_TRAIN)
    with tempfile.TemporaryDirectory() as driver_out:
        driver = _phase(phase_slice_driver, driver_out)
        _phase(phase_slice_gp_report, driver_out, driver)
    _phase(phase_slice_auto)
    _phase(phase_slice_fixed)
    _phase(phase_parity_dgrads)
    dgrads = _phase(phase_slice_dgrads, N_TRAIN)
    entries = _phase(phase_timing, N_TRAIN, counts, dgrads, driver)
    _phase(phase_parity_dia)
    _phase(phase_parity_lanczos)
    slices = {m: _phase(phase_slice_sparse, m) for m in SLICE_GRIDS}
    entries += _phase(phase_timing_sparse, slices)
    _phase(phase_parity_arnoldi)
    arnoldi_runs = {shape: _phase(phase_slice_arnoldi, *shape) for shape in ARNOLDI_SLICE}
    slq_run = _phase(phase_slice_slq)
    _phase(phase_slice_pde)
    _phase(phase_slice_pde_driver)
    _phase(phase_slice_pde_workprecision)
    _phase(phase_slice_pde_diffrax)
    _phase(phase_slice_pde_data)
    entries.append(_phase(phase_timing_arnoldi, arnoldi_runs))
    _phase(phase_parity_bsr)
    bsr_run = _phase(phase_slice_bsr)
    entries.append(_phase(phase_timing_bsr, bsr_run))
    _phase(phase_parity_halo)
    halo_run = _phase(phase_slice_halo)
    _phase(phase_slice_mesh, N_TRAIN)
    entries.append(_phase(phase_timing_halo, halo_run))
    _phase(phase_slice_laplace)
    _phase(phase_slice_laplace_grid)
    _phase(phase_slice_laplace_full)
    _phase(phase_study_orthogonality)
    wall_times = _phase(phase_study_wall_times)
    _phase(phase_study_vjp_matvec)
    _phase(phase_study_mll)
    gram_study = _phase(phase_study_gram_matvec)
    k4_timing_ms = next(e for e in entries if e["name"] == "dia_matvec")["ms"]
    roofline = _phase(phase_study_dia_roofline, k4_timing_ms)
    entries.append(roofline)
    formats = _phase(phase_study_spmv_formats)
    multihost = _phase(phase_study_multihost)
    _phase(phase_study_mtx_parser)
    main_arnoldi = arnoldi_runs[ARNOLDI_MAIN]["launches"]["fused"]
    # The studies' launches: one call per depth and series of the three
    # wall-time sweeps (K4-K7, K9), one matvec a size of the Gram study (K1),
    # the roofline's timed calls (K12, K4), one matvec and one VJP a row of
    # the formats study (K4, K10), the scaling study's local tables (K1, K4)
    # and one VJP a mesh of its measured path (K11).
    studies = {**wall_times["launches"], "gram_matvec": gram_study["launches"]}
    for extra in ({"dia_ceiling": roofline["launches"], **roofline["launches_other"]}, formats["launches"],
                  multihost["launches"]):
        for name, count in extra.items():
            studies[name] = studies.get(name, 0) + count
    for entry in entries:
        # The DIA kernels' launches in the Arnoldi adjoint (main path) and SLQ.
        if entry["name"] in ("dia_matvec", "dia_dvals"):
            key = "dia_matvec_transposed" if entry["name"] == "dia_matvec" else "dia_dvals"
            entry["launches_arnoldi_vjp"] = main_arnoldi[key]
            entry["launches_slq"] = slq_run["launches"][key]
        entry["launches_studies"] = studies.get(entry["name"], 0)
        if entry["name"] == "dia_matvec":
            entry["launches_studies_transposed"] = studies.get("dia_matvec_transposed", 0)
    print(f"[total] {time.perf_counter() - start:.1f} s of wall time, the kernels' build included", flush=True)
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
