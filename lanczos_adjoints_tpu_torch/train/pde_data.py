"""The wave-PDE data generator: random wave-speed fields, bell initial conditions, RK4 targets.

Counterpart of ``experiments/applications/partial_differential_equation/make_data.py``:
a wave-speed field is drawn from a Gaussian random field over the mesh
(covariance ``exp(-|x - x'|^2 / 0.02) + 1e-4 I``, sampled by
``models.pde.sampler_lanczos`` at Lanczos rank 30) and scaled by 0.007;
``num_data`` initial conditions are bells (``pde_init_bell(10.0)``) at
normal centre logits, at rest; each is integrated over ``t in [0, 1]`` by
classical RK4 (``models.pde.solver_rk4``) on ``linspace(0, 1, num_steps)``,
all pairs as one batched ``(B, 2, n, n)`` state through one ``conv2d`` a
stage.

``python -m lanczos_adjoints_tpu_torch.train.pde_data --resolution 128
--num_data 80 --out DIR`` takes the JAX script's arguments plus
``--device`` (default ``cuda``), ``--out DIR`` and ``--fixture PATH``
(an ``.npz`` of the normal draws, ``field_draws`` ``(1, n * n)`` and
``centers`` ``(num_data, 2)``, in place of the generator's), and writes
``{n}x{n}_data_{inputs,targets,parameter}.npy`` under ``--out`` (never
over the bundled files). JAX draws from keys, so its draws cannot be
matched here; ``bundled_miss`` holds the solver to the bundled data.
"""

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import pde
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32

DATA = (
    Path(__file__).resolve().parents[2]
    / "data" / "applications" / "partial_differential_equation" / "make_data"
)
FIELD_AMPLITUDE = 0.007  # the reference GRF's raw output scale -10: a field ~0.007
LANCZOS_RANK = 30
BELL_WIDTH = 10.0


def _rhs(stencil, scale_field):
    """``rhs(y)``: the wave equation under ``scale_field`` on a ``(2, n, n)``
    state or a ``(B, 2, n, n)`` batch (``models.pde.pde_wave_anisotropic``)."""
    parametrize, _ = pde.pde_wave_anisotropic(scale_field, stencil, constrain=torch.square,
                                              boundary=pde.boundary_dirichlet())
    return parametrize(scale=scale_field)


def rbf_covariance(mesh):
    """``exp(-|x - x'|^2 / 0.02) + 1e-4 I`` over the mesh points, ``(n^2, n^2)``."""
    c0, c1 = mesh.reshape(2, -1)
    sq = (c0[:, None] - c0[None, :]) ** 2 + (c1[:, None] - c1[None, :]) ** 2
    cov = torch.exp(-sq / 0.02)
    del sq
    cov.diagonal().add_(1e-4)
    return cov


def sample_field(mesh, key):
    """``0.007`` x one GRF draw over the mesh, ``(n, n)``; ``key`` a generator or
    the ``(1, n^2)`` normal draws."""
    n = mesh.shape[-1]
    cov = rbf_covariance(mesh)
    sample = pde.sampler_lanczos(mean=torch.zeros(n * n, dtype=mesh.dtype, device=mesh.device),
                                 cov_matvec=lambda v: cov @ v, num=1, lanczos_rank=LANCZOS_RANK)
    return FIELD_AMPLITUDE * sample(key)[0].reshape(n, n)


def initial_conditions(mesh, centers):
    """Bells at ``centers`` (``(B, 2)`` logits), at rest: ``(B, 2, n, n)``."""
    init_bell, _ = pde.pde_init_bell(BELL_WIDTH)
    u0 = torch.stack([init_bell(center_logits=c)(mesh) for c in centers])
    return torch.stack([u0, torch.zeros_like(u0)], dim=1)


def make_data(resolution=128, num_data=80, *, key=None, draws=None, num_steps=400, device="cuda"):
    """``make_data.py``'s pairs: ``(inputs, targets, parameter)``.

    The field's draws and the bells' centres come, in that order, from the
    ``torch.Generator`` ``key``, or from ``draws`` (``{"field_draws": (1,
    n^2), "centers": (num_data, 2)}``).
    """
    mesh, stencil = pde.mesh_and_stencil(resolution, device=device)
    if draws is None:
        field_key = key
        centers = None
    else:
        field_key = torch.as_tensor(np.asarray(draws["field_draws"]), dtype=torch.float32, device=device)
        centers = torch.as_tensor(np.asarray(draws["centers"]), dtype=torch.float32, device=device)
    scale_field = sample_field(mesh, field_key)
    if centers is None:
        centers = torch.randn((num_data, 2), generator=key, device=device)
    if centers.shape != (num_data, 2):
        raise ValueError(f"expected centers of shape {(num_data, 2)}, got {tuple(centers.shape)}")
    y0s = initial_conditions(mesh, centers)
    ts = torch.linspace(0.0, 1.0, num_steps, device=device)
    y1s = pde.solver_rk4(ts, _rhs(stencil, scale_field))(y0s)
    return y0s, y1s, scale_field


def bundled(resolution, *, device="cuda"):
    """The bundled ``(inputs, targets, parameter)`` at ``resolution``, float32."""
    prefix = DATA / f"{resolution}x{resolution}"
    return tuple(torch.tensor(np.load(f"{prefix}_data_{name}.npy"), dtype=torch.float32, device=device)
                 for name in ("inputs", "targets", "parameter"))


def bundled_miss(resolution, *, num_steps=400, device="cuda"):
    """RK4 from the bundled inputs and parameter against the bundled targets:
    ``(max |diff| / max |target|, |diff| / |target|, the RK4 solution)``."""
    inputs, targets, parameter = bundled(resolution, device=device)
    _, stencil = pde.mesh_and_stencil(resolution, device=device)
    ts = torch.linspace(0.0, 1.0, num_steps, device=device)
    y1s = pde.solver_rk4(ts, _rhs(stencil, parameter))(inputs)
    diff = (y1s - targets).double()
    return (float(diff.abs().max() / targets.abs().max()),
            float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(targets.double())), y1s)


def build_argparser():
    """The JAX script's arguments plus ``--device``, ``--out`` and ``--fixture``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--num_data", type=int, default=80)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--num_steps", type=int, default=400)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True, help="directory for the three .npy files")
    parser.add_argument("--fixture", type=str, default=None,
                        help="take the normal draws (field_draws, centers) from this .npz")
    return parser


def run(args) -> dict:
    """One run of ``python -m lanczos_adjoints_tpu_torch.train.pde_data``."""
    if Path(args.out).resolve() == DATA.resolve():
        msg = f"--out {args.out} is the bundled data's directory: write elsewhere"
        raise ValueError(msg)
    draws = None
    if args.fixture:
        with np.load(args.fixture) as data:
            draws = {name: data[name] for name in ("field_draws", "centers")}
    key = torch.Generator(device=args.device).manual_seed(args.seed)
    y0s, y1s, scale_field = make_data(args.resolution, args.num_data, key=key, draws=draws,
                                      num_steps=args.num_steps, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    n = args.resolution
    prefix = f"{args.out}/{n}x{n}"
    arrays = {"inputs": y0s, "targets": y1s, "parameter": scale_field}
    for name, value in arrays.items():
        np.save(f"{prefix}_data_{name}.npy", value.cpu().numpy().astype(np.float32))
    print("saved:", prefix, tuple(y0s.shape), tuple(y1s.shape))
    return arrays


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    print(args)
    pin_float32()
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
