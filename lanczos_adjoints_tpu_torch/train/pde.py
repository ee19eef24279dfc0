"""The wave-PDE driver: an MLP wave-speed field fitted through the PDE solve.

Counterpart of ``experiments/applications/partial_differential_equation/train.py``:
an MLP over the mesh gives the wave-speed field ``scale``; each training
pair ``(y0, y1)`` of the bundled data is solved from ``y0`` over
``t in [0, 1]`` by the Arnoldi matrix exponential (``models.pde.expm_arnoldi``,
differentiated through the closed-form Arnoldi adjoint) or by explicit
Euler; the loss is the mean relative MSE over all pairs, and Adam takes
one step an epoch. The JAX script's ``vmap`` over pairs is a loop here.

``python -m lanczos_adjoints_tpu_torch.train.pde --resolution 32
--num_matvecs 4 --num_epochs 4 --out DIR`` takes the JAX script's
arguments plus ``--device`` (default ``cuda``), ``--out DIR`` (the
results directory mirrored from the script's path in the JAX package)
and ``--fixture PATH`` (the flax MLP's initial weights of the JAX run,
``pde_s1.npz``, written by ``scripts/export_pde_s1.py``; seed 1 only),
and writes ``{n}x{n}_{method}_s{seed}_{convergence,timestamps,matvecs,scale_field}.npy``
under the JAX names and dtypes. ``--steps_per_call`` groups the epochs
into chunks that share the chunk's end time, as the JAX script's
timestamps do.
"""

import argparse
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import pde
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32

OUTPUT_SCALE_RAW = -5.0  # the training script's default: covers the data's wave speeds
LEARNING_RATE = 1e-2
DATA = (
    Path(__file__).resolve().parents[2]
    / "data" / "applications" / "partial_differential_equation" / "make_data"
)
FIXTURE = Path(__file__).with_name("pde_s1.npz")
# The JAX drivers' committed outputs (the training series from a TPU);
# accuracy references only.
JAX_TPU_RESULTS = Path(__file__).resolve().parents[2] / "results/applications/partial_differential_equation"
FIXTURE_SEED = 1


def load_fixture(path=FIXTURE) -> dict:
    """The JAX PDE drivers' seed-1 weights and CPU results (``scripts/export_pde_s1.py``)."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def flax_variables(fix) -> dict:
    """The fixture's flax MLP variables in flax's tree, for ``pde.params_from_jax``."""
    return {"params": {f"Dense_{i}": {leaf: fix[f"mlp/Dense_{i}/{leaf}"] for leaf in ("kernel", "bias")}
                       for i in range(3)}}


def load_data(resolution: int, *, device="cuda"):
    """The bundled ``(inputs, targets)`` pairs, ``(B, 2, n, n)`` float32 each."""
    prefix = DATA / f"{resolution}x{resolution}"
    inputs = np.load(f"{prefix}_data_inputs.npy")
    targets = np.load(f"{prefix}_data_targets.npy")
    return (torch.tensor(inputs, dtype=torch.float32, device=device),
            torch.tensor(targets, dtype=torch.float32, device=device))


def assemble(
    resolution: int,
    *,
    num_matvecs: int = 10,
    method: str = "arnoldi",
    seed: int = 1,
    custom_vjp: bool = True,
    output_scale_raw: float = OUTPUT_SCALE_RAW,
    learning_rate: float = LEARNING_RATE,
    device="cuda",
):
    """Build the training problem of the JAX training script at ``resolution``.

    Returns a namespace with ``inputs``, ``targets``, ``mesh``, the MLP
    ``model`` (flax's initialisation drawn from ``seed``; use
    ``pde.params_from_jax`` to carry a flax model's weights), ``solve``,
    ``loss`` and the Adam ``optimizer``. ``custom_vjp=False``
    differentiates the Arnoldi solve by backprop through the loop (the
    oracle).
    """
    inputs, targets = load_data(resolution, device=device)
    mesh, stencil = pde.mesh_and_stencil(resolution, device=device)
    parametrize, _ = pde.pde_wave_anisotropic(
        mesh[0], stencil, constrain=lambda s: s**2, boundary=pde.boundary_dirichlet()
    )

    def vector_field(y, scale):
        return parametrize(scale=scale)(y)

    if method == "arnoldi":
        solve = pde.solver_expm(
            0.0, 1.0, vector_field, pde.expm_arnoldi(num_matvecs, custom_vjp=custom_vjp)
        )
    elif method == "euler":
        solve = pde.solver_euler(torch.linspace(0.0, 1.0, num_matvecs + 1, device=device), vector_field)
    else:
        msg = f"method={method!r} not in ('arnoldi', 'euler')"
        raise ValueError(msg)

    model = pde.model_mlp(
        mesh, (500, 500, 1), activation=torch.tanh, output_scale_raw=output_scale_raw, seed=seed
    )
    # capturable: Adam's step count and bias corrections stay on the card
    # (PyTorch keeps them on the host otherwise; the CPU has no such mode).
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 capturable=torch.device(device).type == "cuda")
    return SimpleNamespace(
        inputs=inputs, targets=targets, mesh=mesh, model=model, solve=solve,
        loss=pde.loss_mse_relative(nugget=1e-4), optimizer=optimizer,
    )


def loss_fn(stack):
    """Mean loss over all training pairs and the info of the last solve."""
    scale = stack.model(stack.mesh)
    losses, info = [], None
    for y0, y1 in zip(stack.inputs, stack.targets):
        sol, info = stack.solve(y0, scale)
        losses.append(stack.loss(sol, targets=y1))
    return torch.mean(torch.stack(losses)), info


def train_step(stack):
    """One Adam step on ``loss_fn``: ``(loss, info)`` before the step."""
    stack.optimizer.zero_grad()
    value, info = loss_fn(stack)
    value.backward()
    stack.optimizer.step()
    return value.detach(), info


def label(args) -> str:
    return f"{args.resolution}x{args.resolution}_{args.method}_s{args.seed}"


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(args, *, fixture=None) -> dict:
    """The JAX training script's epoch loop, as ``python -m lanczos_adjoints_tpu_torch.train.pde``.

    ``fixture``: the dict of ``load_fixture()`` (or ``args.fixture``, its path),
    whose flax weights replace the initialisation drawn from ``--seed``.
    Returns the four series (``convergence``, ``timestamps``, ``matvecs``,
    ``scale_field``) as written, and the ``stack``.
    """
    if fixture is None and getattr(args, "fixture", None):
        fixture = load_fixture(args.fixture)
    stack = assemble(args.resolution, num_matvecs=args.num_matvecs, method=args.method, seed=args.seed,
                     output_scale_raw=args.output_scale_raw, learning_rate=args.learning_rate,
                     device=args.device)
    if fixture is not None:
        if args.seed != FIXTURE_SEED:
            msg = f"the fixture holds the flax weights of seed {FIXTURE_SEED}, not {args.seed}"
            raise ValueError(msg)
        pde.params_from_jax(stack.model, flax_variables(fixture))
    print("data:", tuple(stack.inputs.shape), tuple(stack.targets.shape), flush=True)

    spc = max(1, args.steps_per_call)
    num_pairs = len(stack.inputs)
    convergence, timestamps, matvecs = [], [], []
    _synchronize(args.device)
    start = time.perf_counter()
    for chunk_start in range(0, args.num_epochs, spc):
        try:
            values, num_mvs = [], []
            for _ in range(spc):
                value, info = train_step(stack)
                values.append(value)
                num_mvs.append(info["num_matvecs"])
            values = [float(v) for v in values]
            now = time.perf_counter() - start
            convergence.extend(values)
            # Chunk-granular timestamps: each epoch in the chunk shares the
            # chunk-end wall-clock.
            timestamps.extend([now] * len(values))
            matvecs.extend(int(mv) * num_pairs for mv in num_mvs)
            print(f"epoch {chunk_start}: loss {values[-1]:.3e}", flush=True)
        except KeyboardInterrupt:
            break

    print(f"final loss {convergence[-1]:.3e} after {timestamps[-1]:.1f}s")
    os.makedirs(args.out, exist_ok=True)
    prefix = f"{args.out}/{label(args)}"
    with torch.no_grad():
        scale_field = (stack.model(stack.mesh) ** 2).cpu().numpy()
    series = {
        "convergence": np.asarray(convergence, dtype=np.float64),
        "timestamps": np.asarray(timestamps, dtype=np.float64),
        "matvecs": np.asarray(matvecs, dtype=np.int64),
        "scale_field": scale_field.astype(np.float32),
    }
    for name, values in series.items():
        np.save(f"{prefix}_{name}.npy", values)
    return {**series, "stack": stack}


def build_argparser():
    """The JAX script's arguments plus ``--device``, ``--out`` and ``--fixture``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--method", type=str, default="arnoldi", choices=["arnoldi", "euler"])
    parser.add_argument("--num_matvecs", type=int, default=10)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--learning_rate", type=float, default=LEARNING_RATE)
    parser.add_argument("--output_scale_raw", type=float, default=OUTPUT_SCALE_RAW,
                        help="raw (pre-softplus) output scale of the field MLP; must cover the "
                        "wave-speed magnitude of the data")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="epochs a chunk; the epochs of a chunk share its end time")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True, help="directory for the .npy series")
    parser.add_argument("--fixture", type=str, default=None,
                        help="take the flax MLP's initial weights from this .npz "
                        "(scripts/export_pde_s1.py; seed 1) instead of drawing them")
    return parser


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    print(args)
    pin_float32()
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
