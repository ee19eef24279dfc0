"""A Gram matvec whose backward pass recomputes, against autodiff through it.

Counterpart of ``experiments/benchmarks/vjp_through_matvec/benchmark.py``:
the gradient in the kernel's raw parameters of ``sum((K(theta) v)**2)``,
K the scaled RBF Gram matrix of N points in d dimensions, (a) by
autodiff through the plain ``ops.gram.gram_matvec()`` (which keeps the
N x N intermediates for the backward pass) and (b) through
``gram_matvec_custom_vjp``, whose backward pass recomputes the two
kernel matvecs (O(N) memory). The two gradients must agree to a relative
1e-3, as the JAX script asserts. The JAX script runs no Pallas kernel
here, so neither does this one.

``python -m lanczos_adjoints_tpu_torch.studies.vjp_through_matvec
[--num_data 16384] [--data_dim 2] [--seed 0] [--device cuda] --out DIR``
writes ``vjp_times.json`` (``{"variant", "time_s", "n"}``: the median
over 5 gradients after a warm-up, CUDA events on the card). The points
and v are standard normal, drawn with numpy from ``--seed``.
"""

import argparse
import json
import os

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import gp
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import median_seconds

TOL_AGREEMENT = 1e-3
TIMED_RUNS = 5


class _RecomputedGramMatvec(torch.autograd.Function):
    """``K(x, x; params) @ v`` whose backward pass recomputes instead of storing.

    For symmetric K: the cotangent of v is ``K u``, and those of the
    parameters and of x come from one VJP of ``u^T K(x, x; params) v``.
    """

    @staticmethod
    def forward(ctx, kernel, x, v, *params):
        ctx.kernel = kernel
        ctx.save_for_backward(x, v, *params)
        return gp.gram_matvec()(kernel)(x, x, v, *params)

    @staticmethod
    def backward(ctx, u):
        x, v, *params = ctx.saved_tensors
        matvec = gp.gram_matvec()(ctx.kernel)
        dv = matvec(x, x, u, *params) if ctx.needs_input_grad[2] else None
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[3:]) if need]
        dx, dparams = None, [None] * len(params)
        if wanted or ctx.needs_input_grad[1]:
            with torch.enable_grad():
                xg = x.detach().requires_grad_(ctx.needs_input_grad[1])
                pg = [p.detach().requires_grad_(i in wanted) for i, p in enumerate(params)]
                quadform = torch.dot(u, matvec(xg, xg, v, *pg))
                inputs = [pg[i] for i in wanted] + ([xg] if ctx.needs_input_grad[1] else [])
                grads = torch.autograd.grad(quadform, inputs)
            for i, g in zip(wanted, grads):
                dparams[i] = g
            if ctx.needs_input_grad[1]:
                dx = grads[-1]
        return None, dx, dv, *dparams


def gram_matvec_custom_vjp(kernel_factory):
    """``mv(x, v, params) -> K(x, x; params) @ v`` with the recomputing backward pass."""

    def mv(x, v, params: dict):
        kernel = kernel_factory(**params)  # k(x, y, raw_lengthscale, raw_outputscale)
        return _RecomputedGramMatvec.apply(kernel, x, v, params["raw_lengthscale"],
                                           params["raw_outputscale"])

    return mv


def problem(num_data, data_dim, *, seed=0, device="cuda"):
    """``(x, v, params)``: standard-normal points and vector from numpy, zero raw parameters."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((num_data, data_dim)), dtype=torch.float32, device=device)
    v = torch.tensor(rng.standard_normal(num_data), dtype=torch.float32, device=device)
    params = {"raw_lengthscale": torch.zeros(data_dim, device=device),
              "raw_outputscale": torch.zeros((), device=device)}
    return x, v, params


def losses(data_dim):
    """``{"autodiff": loss(x, v, params), "custom_vjp": ...}``: ``sum((K v)**2)`` each way."""
    kernel_factory, _ = gp.kernel_scaled_rbf(shape_in=(data_dim,), shape_out=())
    mv_custom = gram_matvec_custom_vjp(kernel_factory)

    def loss_autodiff(x, v, params):
        kernel = kernel_factory(**params)
        return torch.sum(gp.gram_matvec()(kernel)(x, x, v) ** 2)

    def loss_custom(x, v, params):
        return torch.sum(mv_custom(x, v, params) ** 2)

    return {"autodiff": loss_autodiff, "custom_vjp": loss_custom}


def gradient(loss, x, v, params) -> dict:
    p = {k: t.detach().requires_grad_() for k, t in params.items()}
    names = sorted(p)
    grads = torch.autograd.grad(loss(x, v, p), [p[k] for k in names])
    return dict(zip(names, grads))


def flat(grads: dict) -> torch.Tensor:
    return torch.cat([grads[k].reshape(-1) for k in sorted(grads)])


def run(num_data, data_dim, *, seed=0, device="cuda"):
    """Returns ``(results, grads, rel)``: the JSON rows, each variant's
    gradient and their relative disagreement."""
    x, v, params = problem(num_data, data_dim, seed=seed, device=device)
    results, grads = [], {}
    for name, loss in losses(data_dim).items():
        grads[name] = gradient(loss, x, v, params)  # also the warm-up
        t = median_seconds(lambda loss=loss: gradient(loss, x, v, params), device=device, reps=1,
                           outer=TIMED_RUNS)
        print(f"{name}: {t * 1e3:.1f} ms per gradient", flush=True)
        results.append({"variant": name, "time_s": t, "n": num_data})
    f1, f2 = flat(grads["autodiff"]), flat(grads["custom_vjp"])
    rel = float(torch.linalg.norm(f1 - f2) / torch.linalg.norm(f1))
    print(f"gradient agreement: rel-err {rel:.2e}", flush=True)
    return results, grads, rel


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_data", type=int, default=16384)
    parser.add_argument("--data_dim", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    print(args)
    pin_float32()
    results, grads, rel = run(args.num_data, args.data_dim, seed=args.seed, device=args.device)
    if not rel < TOL_AGREEMENT:
        msg = f"the two gradients disagree: rel-err {rel:.2e} (tolerance {TOL_AGREEMENT:.0e})"
        raise AssertionError(msg)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "vjp_times.json"), "w") as fp:
        json.dump(results, fp, indent=2)
    return results, grads, rel


if __name__ == "__main__":
    main()
