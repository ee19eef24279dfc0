"""Export the JAX linearised-Laplace drivers' seed-1 draws and results as a fixture.

Runs the four drivers of ``experiments/applications/linearised_laplace/``
(``callibration.py --num_epochs 3``, ``callibration_diag.py --num_epochs 10``,
``compute_metrics_lanczos.py`` and ``plot_callibration_loss.py``, seed 1,
the parity MLP of 3,709 parameters) with the JAX package on the CPU, and
writes what the PyTorch port needs to be held to them without JAX:

- the data of both drivers (``compute_metrics_lanczos.py`` splits its key
  five ways, so its ``x`` is not ``callibration.py``'s), the flax initial
  and MAP parameter vectors;
- the Rademacher probes of each calibration epoch and the two levels of
  Hutchinson probes of the diagonal loss, as int8 signs, and the normal
  draws of ``lanczos_sampler``;
- the drivers' outputs: both calibration curves and alphas, the MAP and
  Laplace metrics;
- the grid search of ``plot_callibration_loss.py`` (its default 9
  ``log_alphas`` x 5 loss samples, from the calibration run's MAP vector):
  the Rademacher probes of each of its 45 loss evaluations
  (``grid_probes``, ``(9, 5, 10, P)`` int8 signs, drawn by its own key
  splits, ``plot_callibration_loss.py:55-58``), each evaluation's loss
  (``grid_values``), their means and standard deviations
  (``grid_losses``, ``grid_stds``: the driver's ``s1_gridsearch.npz``),
  and the same 45 evaluations in float64 (``grid_*_f64``);
- the sign of each Ritz vector of each of ``lanczos_sampler``'s samples
  (``(num_samples, lanczos_rank)``, int8), relative to the port's
  convention (``models/bnn.py::_fixed_signs``: the largest-magnitude entry
  positive), and each sample's Ritz values, for the float32 run and the
  float64 one: eigh leaves the signs to its LAPACK build, and a sample
  moves along each Ritz vector by its own draw;
- the same calibration loop (``callibration.py``'s RMSprop over the SLQ
  loss) and the same metrics run again in float64 from the float32 MAP
  vector and the same probes and draws: the JAX package's own
  float32-vs-float64 spread, and a reference closer to exact arithmetic
  (the float32 run's loss is 6e-4 from it at the first epoch).

The drivers run unmodified (``runpy``), with their results directory
pointed at a temporary one; the draws are taken again under the drivers'
own key splits, and the float32 metrics recomputed here must equal the
driver's.

Run from the repository root::

    python scripts/export_laplace_s1.py [--out PATH]

The default ``--out`` is ``lanczos_adjoints_tpu_torch/train/laplace_s1.npz``.
"""

import argparse
import importlib.util
import json
import runpy
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DRIVERS = REPO / "experiments/applications/linearised_laplace"
FIXTURE = REPO / "lanczos_adjoints_tpu_torch/train/laplace_s1.npz"
METRICS = ("nll", "accuracy", "confidence", "ece", "ood_auroc")
PREDICTIVES = ("map", "laplace")
SEED = 1
CALIB_EPOCHS = 3
DIAG_EPOCHS = 10
GRID_LOG_ALPHAS = (-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0)
GRID_SAMPLES = 5


def _driver(name):
    spec = importlib.util.spec_from_file_location(f"_laplace_{name}", DRIVERS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_driver(name, *argv):
    """Run a driver as ``__main__`` with its results in a temporary directory."""
    from lanczos_adjoints_tpu.utils import exp_util

    with tempfile.TemporaryDirectory() as out, mock.patch.object(
        exp_util, "matching_directory", lambda *_a, **_k: out + "/"
    ), mock.patch.object(sys, "argv", [f"{name}.py", *argv]):
        runpy.run_path(str(DRIVERS / f"{name}.py"), run_name="__main__")
        return {p.name: _load(p) for p in Path(out).iterdir() if p.suffix in (".json", ".npy", ".npz")}


def _load(path):
    if path.suffix == ".json":
        return json.loads(path.read_text())
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {name: data[name] for name in data.files}
    return np.load(path)


def _signs(probes):
    return np.asarray(probes).astype(np.int8)


def _calibration_curve(jax, jnp, bnn, optax, apply, unflatten, map_vec, x, y, probes):
    """``callibration.py``'s loop over the given per-epoch probes: ``(curve, alpha)``.

    The probes travel in the key's place: ``jax.random.rademacher`` is
    replaced by a cast of its key while the loss is traced.
    """
    loss = bnn.callibration_loss(apply, unflatten, jnp.exp, len(map_vec))
    with mock.patch.object(jax.random, "rademacher", lambda key, _shape, dtype: key.astype(dtype)):
        value_and_grad = jax.jit(jax.value_and_grad(loss, argnums=0)).lower(
            jnp.asarray(0.0, map_vec.dtype), map_vec, x, y, jnp.asarray(probes[0], map_vec.dtype)).compile()
    log_alpha = jnp.asarray(0.0, map_vec.dtype)
    optimizer = optax.rmsprop(1e-1)
    state = optimizer.init(log_alpha)
    curve = []
    for epoch_probes in probes:
        value, grad = value_and_grad(log_alpha, map_vec, x, y, jnp.asarray(epoch_probes, map_vec.dtype))
        updates, state = optimizer.update(grad, state)
        log_alpha = optax.apply_updates(log_alpha, updates)
        curve.append(float(value))
    return np.asarray(curve), float(jnp.exp(log_alpha))


def _grid_values(jax, jnp, bnn, apply, unflatten, map_vec, x, y, probes):
    """``plot_callibration_loss.py``'s loss at each ``GRID_LOG_ALPHAS`` entry and
    each of its probe sets ``probes[i, j]``: ``(alphas, samples)``, the probes
    in the key's place as in ``_calibration_curve``."""
    loss = bnn.callibration_loss(apply, unflatten, jnp.exp, len(map_vec))
    with mock.patch.object(jax.random, "rademacher", lambda key, _shape, dtype: key.astype(dtype)):
        loss_jit = jax.jit(loss).lower(jnp.asarray(0.0, map_vec.dtype), map_vec, x, y,
                                       jnp.asarray(probes[0, 0], map_vec.dtype)).compile()
    return np.asarray([[float(loss_jit(jnp.asarray(log_alpha, map_vec.dtype), map_vec, x, y,
                                       jnp.asarray(sample, map_vec.dtype))) for sample in row]
                       for log_alpha, row in zip(GRID_LOG_ALPHAS, probes)])


def _ritz(jnp, jax, bnn, ggn_vp, eps, rank, map_vec, samples):
    """The sampler's Ritz values and the signs of its Ritz vectors, relative to
    the largest-magnitude entry of each (the port's ``_fixed_signs``).

    The decomposition of ``bnn.lanczos_sampler`` again, under the same
    ``vmap``; the samples rebuilt from it must equal the sampler's.
    """
    from lanczos_adjoints_tpu.krylov import lanczos

    def decompose(single):
        (q, tridiag_), _ = lanczos.tridiag(ggn_vp, rank, reortho="full")(single)
        w, v = jnp.linalg.eigh(bnn._dense_tridiag(*tridiag_))
        inv_sqrt = jnp.sqrt(jnp.where(w < 1e-9, 0.0, 1.0 / jnp.where(w < 1e-9, 1.0, w)))
        return w, v, map_vec + (q.T @ v) @ (inv_sqrt * single[:rank])

    w, v, rebuilt = jax.vmap(decompose)(eps)
    np.testing.assert_allclose(np.asarray(rebuilt), np.asarray(samples), rtol=0, atol=1e-6,
                               err_msg="the rebuilt samples differ from lanczos_sampler's")
    v = np.asarray(v)
    rows = np.argmax(np.abs(v), axis=1)
    signs = np.sign(np.take_along_axis(v, rows[:, None, :], axis=1)[:, 0, :])
    return np.asarray(w), np.where(signs == 0, 1, signs).astype(np.int8)


def _metrics(jnp, jax, bnn, auroc, apply, unflatten, map_vec, x, y, x_ood, eps, *, rank=20, alpha=1.0):
    """``compute_metrics_lanczos.py``'s metrics from a MAP vector and the sampler's draws:
    ``(table, ritz_values, ritz_signs)``."""
    gvp = bnn.ggn_vp_parallel(loss_single=bnn.loss_training_cross_entropy_single,
                              model_fun=apply, param_unflatten=unflatten)

    def ggn_vp(v):
        return jax.flatten_util.ravel_pytree(gvp(v, map_vec, x, y))[0] + alpha * v

    with mock.patch.object(jax.random, "normal", lambda *_a, **_k: eps):
        samples = bnn.lanczos_sampler(ggn_vp=ggn_vp, num_samples=eps.shape[0], lanczos_rank=rank,
                                      key=None, params_vec=map_vec)
    ritz_values, ritz_signs = _ritz(jnp, jax, bnn, ggn_vp, eps, rank, map_vec, samples)

    def predictive_probs(sample_vecs, inputs):
        return jnp.mean(jax.vmap(lambda p: jax.nn.softmax(apply(unflatten(p), inputs), axis=-1))(
            sample_vecs), axis=0)

    table = np.zeros((len(PREDICTIVES), len(METRICS)))
    for row, name in enumerate(PREDICTIVES):
        if name == "map":
            probs = jax.nn.softmax(apply(unflatten(map_vec), x), axis=-1)
            probs_ood = jax.nn.softmax(apply(unflatten(map_vec), x_ood), axis=-1)
        else:
            probs, probs_ood = predictive_probs(samples, x), predictive_probs(samples, x_ood)
        nll = bnn.metric_nll(logits=jnp.log(probs + 1e-12), labels_hot=y, sum_or_mean_fun=jnp.mean)
        table[row] = (
            float(nll), float(bnn.metric_accuracy(probs=probs, labels_hot=y)),
            float(bnn.metric_confidence(probs=probs)),
            float(bnn.metric_ece(probs=probs, labels_hot=y, num_bins=10)[0]),
            auroc(np.asarray(jnp.max(probs, axis=-1)), np.asarray(jnp.max(probs_ood, axis=-1))),
        )
    return table, ritz_values, ritz_signs


def export() -> dict:
    """Every array of the fixture, from the JAX drivers run on the CPU."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.flatten_util
    import jax.numpy as jnp
    import optax

    from lanczos_adjoints_tpu.models import bnn
    from lanczos_adjoints_tpu.trace.hutchinson import sampler_rademacher

    sys.path.insert(0, str(DRIVERS))  # callibration_diag.py imports callibration
    try:
        calib = _driver("callibration")
        metrics_driver = _driver("compute_metrics_lanczos")
        runs = {
            "calib": _run_driver("callibration", "--seed", str(SEED), "--num_epochs", str(CALIB_EPOCHS),
                                 "--cpu"),
            "diag": _run_driver("callibration_diag", "--seed", str(SEED), "--num_epochs", str(DIAG_EPOCHS)),
            "metrics": _run_driver("compute_metrics_lanczos", "--seed", str(SEED), "--cpu"),
            "grid": _run_driver("plot_callibration_loss", "--seed", str(SEED)),
        }
    finally:
        sys.path.remove(str(DRIVERS))
    out = {}

    # callibration.py (and callibration_diag.py: the same key splits and defaults).
    init, apply = bnn.model_mlp(out_dims=4, activation=jnp.tanh, hidden=calib._parse_hidden(""))
    key = jax.random.PRNGKey(SEED)
    key, k_data, k_init = jax.random.split(key, 3)
    x, y = calib.make_data(k_data)
    params_vec, unflatten, _ = bnn.vectorize_nn(apply, init(k_init, x))
    map_vec, map_loss = calib.train_map(key, apply, params_vec, unflatten, x, y, num_epochs=200)
    n_params = len(params_vec)
    sampler = sampler_rademacher(jnp.ones((n_params,), dtype=float), num=10)
    grid_key = key
    probes = []
    for _ in range(CALIB_EPOCHS):
        key, subkey = jax.random.split(key)
        probes.append(sampler(subkey))
    diag_probes = [
        [jax.random.rademacher(k, (n_params,), dtype=params_vec.dtype) for k in jax.random.split(level, 20)]
        for level in jax.random.split(jax.random.PRNGKey(0), 2)
    ]
    curve32, _ = _calibration_curve(jax, jnp, bnn, optax, apply, unflatten, map_vec, x, y, _signs(probes))
    if not np.allclose(curve32, runs["calib"][f"s{SEED}_curve.npy"], rtol=1e-6):
        msg = f"the replicated calibration loop {curve32} differs from the driver's"
        raise RuntimeError(msg)
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
        curve64, alpha64 = _calibration_curve(jax, jnp, bnn, optax, apply, unflatten, f64(map_vec), f64(x),
                                              f64(y), _signs(probes))
    out.update(
        calib_curve_f64=curve64, calib_alpha_f64=np.asarray(alpha64),
        calib_x=np.asarray(x), calib_y=np.asarray(y), calib_init=np.asarray(params_vec),
        calib_map=np.asarray(map_vec), calib_map_loss=np.asarray(map_loss),
        calib_probes=_signs(probes), calib_curve=runs["calib"][f"s{SEED}_curve.npy"],
        calib_alpha=runs["calib"][f"s{SEED}_alpha.npy"],
        diag_probes=_signs(diag_probes), diag_curve=runs["diag"][f"s{SEED}_curve.npy"],
        diag_alpha=runs["diag"][f"s{SEED}_alpha.npy"],
    )

    # plot_callibration_loss.py: the calibration run's data and MAP, its own
    # probe draws (one key split per loss evaluation).
    grid_probes = []
    for _ in GRID_LOG_ALPHAS:
        row = []
        for _ in range(GRID_SAMPLES):
            grid_key, subkey = jax.random.split(grid_key)
            row.append(sampler(subkey))
        grid_probes.append(row)
    grid_probes = _signs(grid_probes)
    values32 = _grid_values(jax, jnp, bnn, apply, unflatten, map_vec, x, y, grid_probes)
    driver_grid = runs["grid"][f"s{SEED}_gridsearch.npz"]
    if not (np.array_equal(driver_grid["log_alphas"], GRID_LOG_ALPHAS)
            and np.allclose(values32.mean(axis=1), driver_grid["losses"], rtol=1e-6)
            and np.allclose(values32.std(axis=1), driver_grid["stds"], rtol=1e-4, atol=1e-6)):
        msg = f"the replicated grid search {values32} differs from the driver's {driver_grid}"
        raise RuntimeError(msg)
    with jax.enable_x64(True):
        values64 = _grid_values(jax, jnp, bnn, apply, unflatten, f64(map_vec), f64(x), f64(y), grid_probes)
    out.update(
        grid_log_alphas=np.asarray(GRID_LOG_ALPHAS), grid_probes=grid_probes, grid_values=values32,
        grid_losses=driver_grid["losses"], grid_stds=driver_grid["stds"], grid_values_f64=values64,
        grid_losses_f64=values64.mean(axis=1), grid_stds_f64=values64.std(axis=1),
    )

    # compute_metrics_lanczos.py: its own five-way split.
    key = jax.random.PRNGKey(SEED)
    key, k_data, k_init, k_ood, k_sample = jax.random.split(key, 5)
    x, y = calib.make_data(k_data)
    x_ood = 4.0 * jax.random.normal(k_ood, x.shape)
    params_vec, unflatten, _ = bnn.vectorize_nn(apply, init(k_init, x))
    map_vec, _ = calib.train_map(key, apply, params_vec, unflatten, x, y, num_epochs=200)
    eps = jax.random.normal(k_sample, (16, n_params))
    table, ritz, signs = _metrics(jnp, jax, bnn, metrics_driver.auroc, apply, unflatten, map_vec, x, y, x_ood,
                                  eps)
    driver_table = np.asarray([[runs["metrics"][f"s{SEED}_metrics.json"][p][m] for m in METRICS]
                               for p in PREDICTIVES])
    if not np.allclose(table, driver_table, rtol=1e-6, atol=1e-7):
        msg = f"recomputed metrics {table} differ from the driver's {driver_table}"
        raise RuntimeError(msg)
    with jax.enable_x64(True):
        table64, ritz64, signs64 = _metrics(jnp, jax, bnn, metrics_driver.auroc, apply, unflatten, f64(map_vec),
                                            f64(x), f64(y), f64(x_ood), f64(eps))
    out.update(
        metrics_x=np.asarray(x), metrics_y=np.asarray(y), metrics_x_ood=np.asarray(x_ood),
        metrics_init=np.asarray(params_vec), metrics_map=np.asarray(map_vec), metrics_eps=np.asarray(eps),
        metrics=driver_table, metrics_f64=table64, metrics_signs=signs, metrics_signs_f64=signs64,
        metrics_ritz=ritz, metrics_ritz_f64=ritz64,
    )
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=FIXTURE)
    args = parser.parse_args(argv)
    arrays = export()
    from lanczos_adjoints_tpu_torch.train.laplace import relative_ritz_gaps

    np.savez_compressed(args.out, **arrays)
    spread = np.abs(arrays["metrics"] - arrays["metrics_f64"])
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")
    print(f"calibration curve {arrays['calib_curve']}, alpha {float(arrays['calib_alpha']):.6f}; in float64 "
          f"{arrays['calib_curve_f64']}, alpha {float(arrays['calib_alpha_f64']):.6f}")
    print(f"diagonal curve {arrays['diag_curve'][[0, -1]]}, alpha {float(arrays['diag_alpha']):.6f}")
    print(f"grid search losses {arrays['grid_losses']}, stds {arrays['grid_stds']}; in float64 "
          f"{arrays['grid_losses_f64']}, {arrays['grid_stds_f64']}")
    for row, name in enumerate(PREDICTIVES):
        print(name, dict(zip(METRICS, arrays["metrics"][row].round(6))),
              "f32-vs-f64 spread", dict(zip(METRICS, spread[row])))
    flips = int(np.sum(arrays["metrics_signs"] != arrays["metrics_signs_f64"]))
    print(f"Ritz vectors of opposite sign in float32 and float64: {flips} of {arrays['metrics_signs'].size}; "
          f"smallest relative Ritz gap a sample {relative_ritz_gaps(arrays['metrics_ritz']).round(6)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
