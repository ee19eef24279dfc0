"""Trace the loss-of-orthogonality rows of the JAX package and of the port, on the CPU.

The study (``experiments/benchmarks/loss_of_orthogonality/measure.py``,
``lanczos_adjoints_tpu_torch.studies.loss_of_orthogonality``) compares the
Arnoldi adjoint, with and without re-projection, against backprop through
``hessenberg(reortho="full")`` on Hilbert matrices in float64. This
script shows what decides its rows:

1. ``--trace N`` (default 12): the two packages' backprop oracles held
   step by step: each step's basis vector ``q`` (the matvec's input), the
   subdiagonal entry of H (zero where the DGKS test truncates) and the
   cotangent that backprop sends into the matvec's input.
2. The JAX package's own spread: its ``err_proj`` and ``err_noproj`` at
   each size under one-ulp perturbations of A (``perturbed`` of the
   study, seeds 0-7), and the spread against its committed rows that the
   study's ``JAX_SPREAD`` keeps, beside the port's rows.
3. At the sizes without a committed row (``UNREFERENCED``: 16 and 24),
   the range of both packages' rows under the same perturbations, which
   ``UNREFERENCED_PROJ_BOUND`` of the study bounds.

Run from the repository root: ``python scripts/c10_orthogonality_spread.py``
(about 40 s).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # the recorded steps stay float64
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu import krylov as jkrylov  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import arnoldi  # noqa: E402
from lanczos_adjoints_tpu_torch.studies import loss_of_orthogonality as study  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import exp_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

SEEDS = range(8)
UNREFERENCED = (16, 24)


def jax_gradients(*, jit: bool):
    """``grads(A)``: the JAX package's three gradients (backprop, proj, noproj)."""
    cache = {}

    def grads(A):
        n = A.shape[0]
        if n not in cache:
            v = jnp.arange(1.0, n + 1.0)
            fns = []
            for custom_vjp, reortho_vjp in study.VARIANTS.values():
                f = jkrylov.hessenberg(lambda s, p: (p + p.T) @ s, n, reortho="full",
                                       custom_vjp=custom_vjp, reortho_vjp=reortho_vjp)

                def loss(p, f=f, v=v):
                    Q, H, _r, _c = f(v, p)
                    return jnp.sum(H**2) + jnp.sum(Q**2)

                g = jax.grad(loss)
                fns.append(jax.jit(g) if jit else g)
            cache[n] = fns
        return [np.asarray(g(jnp.asarray(A))) for g in cache[n]]

    return grads


def jax_errors(A, grads):
    gb, gp, gn = grads(A)
    scale = np.linalg.norm(gb)
    return {"err_proj": float(np.linalg.norm(gp - gb) / scale),
            "err_noproj": float(np.linalg.norm(gn - gb) / scale)}


def jax_spread(sizes, reference):
    """Per size: JAX's rows under the perturbations, and the largest move from ``reference``."""
    grads = jax_gradients(jit=True)
    spread, rows = {}, {}
    for n in sizes:
        A = exp_util.hilbert(n, dtype=torch.float64).numpy()
        rows[n] = [jax_errors(study.perturbed(A, seed), grads) for seed in SEEDS]
        spread[n] = {key: max(abs(r[key] - reference[n][key]) for r in rows[n])
                     for key in ("err_proj", "err_noproj")}
    return spread, rows


def trace(n):
    A_np = exp_util.hilbert(n, dtype=torch.float64).numpy()
    jq, jct = [], []

    @jax.custom_vjp
    def tap(q):
        return q

    def tap_bwd(_residuals, ct):
        jax.debug.callback(lambda c: jct.append(np.asarray(c)), ct, ordered=True)
        return (ct,)

    tap.defvjp(lambda q: (q, None), tap_bwd)

    def mv(s, p):
        jax.debug.callback(lambda q: jq.append(np.asarray(q)), s, ordered=True)
        return (p + p.T) @ tap(s)

    f = jkrylov.hessenberg(mv, n, reortho="full", custom_vjp=False)
    v = jnp.arange(1.0, n + 1.0)
    H_j = np.asarray(f(v, jnp.asarray(A_np))[1])
    jq.clear()
    jax.grad(lambda p: (lambda o: jnp.sum(o[1] ** 2) + jnp.sum(o[0] ** 2))(f(v, p)))(jnp.asarray(A_np))
    jct = jct[::-1]  # backprop visits the steps in reverse

    tq, tct = [], []

    def mv_t(s, p):
        tq.append(s.detach().numpy().copy())
        s_in = s * 1.0  # the matvec's own input: its cotangent is the matvec path's alone
        if s_in.requires_grad:
            s_in.register_hook(lambda g: tct.append(g.numpy().copy()))
        return (p + p.T) @ s_in

    p = torch.tensor(A_np, requires_grad=True)
    Q, H, _r, _c = arnoldi.hessenberg(mv_t, n, reortho="full", custom_vjp=False)(
        torch.arange(1.0, n + 1.0, dtype=torch.float64), p)
    (torch.sum(H**2) + torch.sum(Q**2)).backward()
    # q_0 = v / |v| does not depend on A: the port's autograd has no cotangent for it.
    tct = [np.zeros(n)] + tct[::-1]
    H_t = H.detach().numpy()
    print(f"[trace] n={n}: backprop through hessenberg(reortho='full'), float64, step by step")
    print("  step  |q_jax - q_port|  H[i+1,i] jax      H[i+1,i] port     |ct| jax    |ct| port   ct rel diff")
    for i in range(n):
        sub_j = H_j[i + 1, i] if i + 1 < n else float("nan")
        sub_t = H_t[i + 1, i] if i + 1 < n else float("nan")
        scale = np.abs(jct[i]).max()
        rel = np.abs(jct[i] - tct[i]).max() / scale if i else float("nan")
        print(f"  {i:4d}  {np.abs(jq[i] - tq[i]).max():.3e}        {sub_j:.9e}  {sub_t:.9e}  "
              f"{scale:.3e}   {np.abs(tct[i]).max():.3e}   {rel:.3e}")
    truncated = [i for i in range(n - 1) if H_j[i + 1, i] == 0.0 or H_t[i + 1, i] == 0.0]
    print(f"  DGKS truncations (H[i+1,i] == 0): {truncated or 'none'}")
    g_j = jax_gradients(jit=False)(A_np)[0]
    g_t = p.grad.numpy()
    print(f"  backprop gradients: relative difference {np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j):.3e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=int, default=12)
    parser.add_argument("--sizes", type=int, nargs="+", default=[4, 8, 12])
    args = parser.parse_args(argv)
    pin_float32()
    trace(args.trace)

    committed = {r["n"]: r for r in study.load_rows()}
    spread, rows = jax_spread(args.sizes, committed)
    port = {r["n"]: r for r in study.measure(args.sizes, device="cpu")}
    for n in args.sizes:
        print(f"[spread] n={n}: JAX committed {committed[n]['err_proj']:.4e} / {committed[n]['err_noproj']:.4e}; "
              f"port {port[n]['err_proj']:.4e} / {port[n]['err_noproj']:.4e} (err_proj / err_noproj)")
        for seed, r in zip(SEEDS, rows[n]):
            flag = "  re-projection worse" if r["err_proj"] > r["err_noproj"] else ""
            print(f"  JAX, perturbation seed {seed}: {r['err_proj']:.4e} / {r['err_noproj']:.4e}{flag}")
        print(f"  spread: err_proj {spread[n]['err_proj']:.4e}, err_noproj {spread[n]['err_noproj']:.4e}")
    print("JAX_SPREAD =", json.dumps({n: {k: float(f"{v:.4g}") for k, v in s.items()} for n, s in spread.items()}))

    grads = jax_gradients(jit=True)
    for n in UNREFERENCED:
        A = exp_util.hilbert(n, dtype=torch.float64).numpy()
        perturbed = [A] + [study.perturbed(A, seed) for seed in SEEDS]
        for name, rows_n in (("JAX", [jax_errors(B, grads) for B in perturbed]),
                             ("port", [study.errors(torch.from_numpy(B)) for B in perturbed])):
            ranges = {key: (min(r[key] for r in rows_n), max(r[key] for r in rows_n))
                      for key in ("err_proj", "err_noproj")}
            print(f"[unreferenced] n={n} {name}, A and seeds 0-7: "
                  + ", ".join(f"{key} {lo:.3g} to {hi:.3g}" for key, (lo, hi) in ranges.items()))


if __name__ == "__main__":
    main()
