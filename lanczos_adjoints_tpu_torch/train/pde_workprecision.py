"""Work-precision of the gradient of the wave-PDE matrix exponential.

Counterpart of ``experiments/applications/partial_differential_equation/workprecision.py``:
the relative error of ``d/d scale mean(u(1)^2)`` for the Arnoldi
exponential at several Krylov depths (through the closed-form Arnoldi
adjoint) and for RK4 at several step counts (backprop through the steps),
each against RK4 with 512 steps, on a bell at rest under a constant wave
speed of 0.035 (``t * omega ~ 6``).

``python -m lanczos_adjoints_tpu_torch.train.pde_workprecision --out DIR
[--x64]`` takes the JAX script's arguments plus ``--device`` (default
``cuda``) and ``--out DIR``, and writes ``workprecision{_x64}_s{seed}.json``
with the JAX keys in the JAX order. ``--x64`` runs in float64 on the
device asked for (the JAX script moves to the CPU for it) and adds depths
26 and 32.
"""

import argparse
import json
import os

import torch

from lanczos_adjoints_tpu_torch.models import pde
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32

DEPTHS = (4, 6, 8, 10, 14, 20)
DEPTHS_X64 = (26, 32)
RK4_STEPS = (8, 16, 32, 64)
REFERENCE_STEPS = 512
WAVE_SPEED = 0.035


def rk4(num_steps, vector_field, *, dtype=torch.float32, device="cuda"):
    """RK4 with ``num_steps`` steps over ``[0, 1]``: ``solve(y0, *p) -> (y1, info)``."""
    ts = torch.linspace(0.0, 1.0, num_steps + 1, dtype=dtype, device=device)
    steps = pde.solver_rk4(ts, vector_field)

    def solve(y0, *p):
        return steps(y0, *p), {"num_matvecs": 4 * num_steps}

    return solve


def problem(resolution=64, *, dtype=torch.float32, device="cuda"):
    """``(y0, scale, vector_field)`` of the JAX script at ``resolution``."""
    mesh, stencil = pde.mesh_and_stencil(resolution, dtype=dtype, device=device)
    parametrize, _ = pde.pde_wave_anisotropic(mesh[0], stencil, constrain=torch.square,
                                              boundary=pde.boundary_dirichlet())
    init_bell, _ = pde.pde_init_bell(5.0)
    u0 = init_bell(center_logits=torch.zeros(2, dtype=dtype, device=device))(mesh)
    y0 = torch.stack([u0, torch.zeros_like(u0)])
    scale = WAVE_SPEED * torch.ones((resolution, resolution), dtype=dtype, device=device)
    return y0, scale, lambda y, s: parametrize(scale=s)(y)


def value_and_grad_of(solve, y0, scale):
    """``mean(u(1)^2)`` and its gradient in ``scale``, with the solver's info."""
    s = scale.detach().clone().requires_grad_()
    y1, info = solve(y0, s)
    value = torch.mean(y1[0] ** 2)
    (grad,) = torch.autograd.grad(value, s)
    return float(value.detach()), grad.detach(), info


def sweep(resolution=64, *, x64=False, device="cuda", depths=None, rk4_steps=RK4_STEPS):
    """The JAX script's rows: ``[{"method", "num_matvecs", "error"}, ...]``."""
    dtype = torch.float64 if x64 else torch.float32
    y0, scale, vf = problem(resolution, dtype=dtype, device=device)
    _, g_ref, _ = value_and_grad_of(rk4(REFERENCE_STEPS, vf, dtype=dtype, device=device), y0, scale)
    g_ref_norm = torch.linalg.vector_norm(g_ref)

    def error(g):
        return float(torch.linalg.vector_norm(g - g_ref) / g_ref_norm)

    if depths is None:
        depths = DEPTHS + (DEPTHS_X64 if x64 else ())
    results = []
    for depth in depths:
        solve = pde.solver_expm(0.0, 1.0, vf, pde.expm_arnoldi(depth))
        _, g, _ = value_and_grad_of(solve, y0, scale)
        results.append({"method": "arnoldi", "num_matvecs": depth, "error": error(g)})
        print(f"arnoldi depth {depth}: grad rel-err {results[-1]['error']:.3e}", flush=True)
    for steps in rk4_steps:
        _, g, info = value_and_grad_of(rk4(steps, vf, dtype=dtype, device=device), y0, scale)
        results.append({"method": "rk4", "num_matvecs": info["num_matvecs"], "error": error(g)})
        print(f"rk4 steps {steps} ({4 * steps} matvecs): grad rel-err {results[-1]['error']:.3e}", flush=True)
    return results


def build_argparser():
    """The JAX script's arguments plus ``--device`` and ``--out``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--x64", action="store_true", help="float64 on --device; adds depths 26 and 32")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True, help="directory for the .json file")
    return parser


def run(args) -> list:
    results = sweep(args.resolution, x64=args.x64, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = f"{args.out}/workprecision{'_x64' if args.x64 else ''}_s{args.seed}.json"
    with open(path, "w") as fp:
        json.dump(results, fp, indent=2)
    print("saved", path)
    return results


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    print(args)
    pin_float32()
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
