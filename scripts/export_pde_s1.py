"""Export the JAX wave-PDE drivers' seed-1 weights and CPU results as a fixture.

Runs the drivers of ``experiments/applications/partial_differential_equation/``
with the JAX package on the CPU and writes what the PyTorch port needs to
be held to them without JAX:

- ``mlp/Dense_{0,1,2}/{kernel,bias}``: the flax MLP's variables from
  ``init(jax.random.PRNGKey(1))`` (``train.py:83``; 252,501 float32
  values; the same at every resolution);
- for each training configuration (``32x32_arnoldi`` at depth 4 for 4
  epochs, ``128x128_arnoldi`` at depth 10 and ``128x128_euler`` with 40
  matvecs for 5 epochs each): ``{label}/convergence`` (float32 losses
  from ``train.py`` itself, run unmodified), ``{label}/convergence_f64``
  (the same loss and Adam steps rebuilt here in float64 under a scoped
  ``jax.enable_x64``, from the same weights: the JAX package's own
  float32-vs-float64 spread), ``{label}/matvecs`` and
  ``{label}/scale_field`` (the learned field after the last epoch);
- ``workprecision/{method,num_matvecs,error}``: ``workprecision.py``'s
  float32 sweep at 64 x 64, run unmodified;
- ``rk4_miss/{32,128}``: ``make_data.solver_rk4`` over
  ``linspace(0, 1, 400)`` from the bundled ``_data_inputs`` and
  ``_data_parameter``, against the bundled ``_data_targets``: the largest
  difference over the targets' largest value, and the norm of the
  difference over the targets' norm.

The drivers run as ``__main__`` (``runpy``) with their results directory
pointed at a temporary one; the float32 rebuild of the training loss must
give the driver's epoch-0 loss.

Run from the repository root (about two minutes on 8 cores)::

    python scripts/export_pde_s1.py [--out PATH]

The default ``--out`` is ``lanczos_adjoints_tpu_torch/train/pde_s1.npz``.
"""

import argparse
import json
import runpy
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DRIVERS = REPO / "experiments/applications/partial_differential_equation"
DATA = REPO / "data/applications/partial_differential_equation/make_data"
FIXTURE = REPO / "lanczos_adjoints_tpu_torch/train/pde_s1.npz"
SEED = 1
# (resolution, method, num_matvecs, epochs)
RUNS = ((32, "arnoldi", 4, 4), (128, "arnoldi", 10, 5), (128, "euler", 40, 5))
MLP_KEYS = tuple(f"Dense_{i}/{leaf}" for i in range(3) for leaf in ("kernel", "bias"))
MLP_SHAPES = {"Dense_0/kernel": (2, 500), "Dense_0/bias": (500,), "Dense_1/kernel": (500, 500),
              "Dense_1/bias": (500,), "Dense_2/kernel": (500, 1), "Dense_2/bias": (1,)}
RK4_STEPS = 400


def label(resolution, method):
    return f"{resolution}x{resolution}_{method}"


def _run_driver(name, *argv):
    """Run a driver as ``__main__`` with its results in a temporary directory:
    ``{file name: array or JSON}``."""
    from lanczos_adjoints_tpu.utils import exp_util

    original = exp_util.matching_directory
    with tempfile.TemporaryDirectory() as out:
        def matching(file, where, **kwargs):
            return out + "/" if where == "results/" else original(file, where, **kwargs)

        with mock.patch.object(exp_util, "matching_directory", matching), \
                mock.patch.object(sys, "argv", [f"{name}.py", *argv]):
            runpy.run_path(str(DRIVERS / f"{name}.py"), run_name="__main__")
        return {p.name: (json.loads(p.read_text()) if p.suffix == ".json" else np.load(p))
                for p in Path(out).iterdir()}


def _variables(jax, jnp, pde):
    """``train.py``'s flax variables, as ``{"Dense_i/kernel": array}``."""
    xs = jnp.linspace(0.0, 1.0, 32)
    init, _ = pde.model_mlp(pde.mesh_tensorproduct(xs, xs), (500, 500, 1), activation=jnp.tanh,
                            output_scale_raw=-5.0)
    flat, unflatten = init(jax.random.PRNGKey(SEED))
    tree = unflatten(flat)["params"]
    return {key: np.asarray(tree[key.split("/")[0]][key.split("/")[1]]) for key in MLP_KEYS}


def _series(jax, jnp, optax, pde, variables, resolution, method, num_matvecs, epochs, dtype):
    """``train.py``'s losses before each of ``epochs`` Adam steps, in ``dtype``,
    from ``variables``: ``(losses, learned field)``."""
    inputs = jnp.asarray(np.load(DATA / f"{resolution}x{resolution}_data_inputs.npy"), dtype)
    targets = jnp.asarray(np.load(DATA / f"{resolution}x{resolution}_data_targets.npy"), dtype)
    xs_1d = jnp.linspace(0.0, 1.0, resolution, dtype=dtype)
    mesh = pde.mesh_tensorproduct(xs_1d, xs_1d)
    stencil = pde.stencil_laplacian(float(xs_1d[1] - xs_1d[0])).astype(dtype)
    parametrize, _ = pde.pde_wave_anisotropic(mesh[0], stencil, constrain=lambda s: s**2,
                                              boundary=pde.boundary_dirichlet())
    if method == "arnoldi":
        solve = pde.solver_expm(0.0, 1.0, lambda y, scale: parametrize(scale=scale)(y),
                                pde.expm_arnoldi(num_matvecs))
    else:
        solve = pde.solver_euler(jnp.linspace(0.0, 1.0, num_matvecs + 1, dtype=dtype),
                                 lambda y, scale: parametrize(scale=scale)(y))
    _, apply = pde.model_mlp(mesh, (500, 500, 1), activation=jnp.tanh, output_scale_raw=-5.0)
    tree = {"params": {f"Dense_{i}": {leaf: jnp.asarray(variables[f"Dense_{i}/{leaf}"], dtype)
                                      for leaf in ("kernel", "bias")} for i in range(3)}}
    params, unflatten = jax.flatten_util.ravel_pytree(tree)
    loss_mse = pde.loss_mse_relative(nugget=1e-4)

    def loss_fn(p):
        scale = apply(unflatten(p), mesh)
        losses = jax.vmap(lambda y0, y1: loss_mse(solve(y0, scale)[0], targets=y1))(inputs, targets)
        return jnp.mean(losses)

    optimizer = optax.adam(1e-2)
    state = optimizer.init(params)

    @jax.jit
    def step(p, state):
        value, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = optimizer.update(grads, state)
        return optax.apply_updates(p, updates), state, value

    losses = []
    for _ in range(epochs):
        params, state, value = step(params, state)
        losses.append(float(value))
    return np.asarray(losses), np.asarray(apply(unflatten(params), mesh)) ** 2


def _rk4_miss(jax, jnp, pde, make_data, resolution):
    """``make_data.solver_rk4`` from the bundled inputs and parameter against the
    bundled targets: ``(max |diff| / max |target|, |diff| / |target|)``."""
    prefix = DATA / f"{resolution}x{resolution}"
    inputs = jnp.asarray(np.load(f"{prefix}_data_inputs.npy"))
    targets = np.load(f"{prefix}_data_targets.npy")
    scale_field = jnp.asarray(np.load(f"{prefix}_data_parameter.npy"))
    xs_1d = jnp.linspace(0.0, 1.0, resolution)
    stencil = pde.stencil_laplacian(float(xs_1d[1] - xs_1d[0]))
    parametrize, _ = pde.pde_wave_anisotropic(scale_field, stencil, constrain=lambda s: s**2,
                                              boundary=pde.boundary_dirichlet())
    rhs = parametrize(scale=scale_field)
    solve = make_data.solver_rk4(jnp.linspace(0.0, 1.0, RK4_STEPS), lambda y: rhs(y))
    y1s = np.asarray(jax.jit(jax.vmap(solve))(inputs), np.float64)
    diff = y1s - targets
    return np.asarray([np.max(np.abs(diff)) / np.max(np.abs(targets)),
                       np.linalg.norm(diff) / np.linalg.norm(targets)])


def export() -> dict:
    """Every array of the fixture, from the JAX drivers run on the CPU."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import importlib.util

    import jax.flatten_util
    import jax.numpy as jnp
    import optax

    from lanczos_adjoints_tpu.models import pde

    out = {}
    variables = _variables(jax, jnp, pde)
    for key, shape in MLP_SHAPES.items():
        if variables[key].shape != shape or variables[key].dtype != np.float32:
            msg = f"flax variable {key}: {variables[key].shape} {variables[key].dtype}, expected {shape} float32"
            raise RuntimeError(msg)
        out[f"mlp/{key}"] = variables[key]

    for resolution, method, num_matvecs, epochs in RUNS:
        t0 = time.perf_counter()
        files = _run_driver("train", "--resolution", str(resolution), "--method", method, "--num_matvecs",
                            str(num_matvecs), "--num_epochs", str(epochs), "--seed", str(SEED))
        name = label(resolution, method)
        driver = files[f"{name}_s{SEED}_convergence.npy"]
        rebuilt, _ = _series(jax, jnp, optax, pde, variables, resolution, method, num_matvecs, 1, jnp.float32)
        if not np.allclose(rebuilt[0], driver[0], rtol=1e-6):
            msg = f"{name}: the rebuilt epoch-0 loss {rebuilt[0]} differs from the driver's {driver[0]}"
            raise RuntimeError(msg)
        with jax.enable_x64(True):
            series64, _ = _series(jax, jnp, optax, pde, variables, resolution, method, num_matvecs, epochs,
                                  jnp.float64)
        out[f"{name}/convergence"] = driver
        out[f"{name}/convergence_f64"] = series64
        out[f"{name}/matvecs"] = files[f"{name}_s{SEED}_matvecs.npy"]
        out[f"{name}/scale_field"] = files[f"{name}_s{SEED}_scale_field.npy"]
        print(f"{name}: float32 {driver}, float64 {series64} ({time.perf_counter() - t0:.1f} s)", flush=True)

    rows = _run_driver("workprecision", "--seed", str(SEED))[f"workprecision_s{SEED}.json"]
    out["workprecision/method"] = np.asarray([row["method"] for row in rows])
    out["workprecision/num_matvecs"] = np.asarray([row["num_matvecs"] for row in rows], np.int64)
    out["workprecision/error"] = np.asarray([row["error"] for row in rows])

    spec = importlib.util.spec_from_file_location("_pde_make_data", DRIVERS / "make_data.py")
    make_data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_data)
    for resolution in (32, 128):
        out[f"rk4_miss/{resolution}"] = _rk4_miss(jax, jnp, pde, make_data, resolution)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=FIXTURE)
    args = parser.parse_args(argv)
    arrays = export()
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")
    for method, mv, err in zip(arrays["workprecision/method"], arrays["workprecision/num_matvecs"],
                               arrays["workprecision/error"]):
        print(f"work-precision float32 64x64: {method} {mv} matvecs: {err:.4e}")
    for resolution in (32, 128):
        miss = arrays[f"rk4_miss/{resolution}"]
        print(f"RK4 from the bundled inputs at {resolution}^2: max {miss[0]:.4e}, norm {miss[1]:.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
