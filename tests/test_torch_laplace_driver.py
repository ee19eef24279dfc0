"""The port's linearised-Laplace drivers against the JAX package's, on the CPU.

``python -m lanczos_adjoints_tpu_torch.train.laplace`` runs each driver
through its argument parser with ``--device cpu --fixture`` (the JAX
drivers' data, initial parameters and probes) and is held to the JAX
drivers of ``experiments/applications/linearised_laplace/``, run in this
process by ``scripts/export_laplace_s1.py`` (loaded by path), which also
regenerates every array of the committed fixture.

Tolerances: the calibration curve and alpha within 1e-4 of the JAX
package's float64 run of the same loop (its float32 run is itself 6e-4
from that; the port's float32 run is within 1e-5 of it), and within
``TOL_CURVES`` (0.5 %) of the float32 run; the diagonal calibration within
1e-4 of the float32 run (no Lanczos in it); the metrics within
``metric_tolerances`` (1 %) at the JAX run's Ritz-vector signs
(``metrics_signs``), the MAP's within 1e-5.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu_torch.train import laplace  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
EXPORT = REPO / "scripts/export_laplace_s1.py"
DRAWS = ("calib_x", "calib_y", "calib_init", "calib_probes", "diag_probes", "metrics_x", "metrics_y",
         "metrics_x_ood", "metrics_init", "metrics_eps")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX drivers run now, in this process: every array of the fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield _load(EXPORT, "_export_laplace_s1").export()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fix():
    return laplace.fixture()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _run(tmp_path, *argv):
    assert laplace.main([*argv, "--device", "cpu", "--out", str(tmp_path),
                         "--fixture", str(laplace.FIXTURE)]) == 0


def test_fixture_is_a_fresh_export(jax_run, fix):
    assert sorted(jax_run) == sorted(fix)
    for name in DRAWS:  # integer threefry draws: the same bits on any CPU
        np.testing.assert_array_equal(jax_run[name], fix[name], err_msg=name)
    for name in sorted(set(fix) - set(DRAWS)):  # computed: rounding may differ between CPUs
        np.testing.assert_allclose(jax_run[name], fix[name], rtol=1e-5, atol=1e-7, err_msg=name)
    assert fix["calib_init"].shape == (3709,) and fix["metrics_eps"].shape == (16, 3709)
    assert laplace.FIXTURE.stat().st_size < 1 << 20


def test_callibration_driver_matches_jax(jax_run, tmp_path):
    _run(tmp_path, "callibration", "--num_epochs", "3")
    curve, alpha = np.load(tmp_path / "s1_curve.npy"), float(np.load(tmp_path / "s1_alpha.npy"))
    assert _rel(curve, jax_run["calib_curve_f64"]) < 1e-4
    assert _rel(alpha, jax_run["calib_alpha_f64"]) < 1e-4
    assert _rel(curve, jax_run["calib_curve"]) < laplace.TOL_CURVES
    assert _rel(alpha, jax_run["calib_alpha"]) < laplace.TOL_CURVES


def test_callibration_diag_driver_matches_jax(jax_run, tmp_path):
    _run(tmp_path, "callibration_diag", "--num_epochs", "10")
    assert _rel(np.load(tmp_path / "s1_curve.npy"), jax_run["diag_curve"]) < 1e-4
    assert _rel(np.load(tmp_path / "s1_alpha.npy"), jax_run["diag_alpha"]) < 1e-4


def test_compute_metrics_driver_matches_jax(jax_run, tmp_path):
    _run(tmp_path, "compute_metrics_lanczos")
    table = laplace.metrics_table(json.loads((tmp_path / "s1_metrics.json").read_text()))
    np.testing.assert_allclose(table[0], jax_run["metrics"][0], rtol=1e-5, atol=1e-7)
    tol = laplace.metric_tolerances(jax_run)
    np.testing.assert_allclose(tol, 1e-2 * np.abs(jax_run["metrics"]))
    assert np.all(np.abs(table - jax_run["metrics"]) <= tol)
    # The samples have no Ritz pair close enough to rotate in float32.
    assert np.all(laplace.relative_ritz_gaps(jax_run["metrics_ritz"]) > 1e-3)


def test_train_map_matches_the_jax_map(fix):
    x, y = torch.tensor(fix["calib_x"]), torch.tensor(fix["calib_y"])
    from lanczos_adjoints_tpu_torch.models import bnn

    init, apply = bnn.model_mlp(out_dims=4, activation=torch.tanh)
    _, unflatten, _ = bnn.vectorize_nn(apply, init(torch.Generator().manual_seed(0), x))
    params, loss = laplace.train_map(apply, torch.tensor(fix["calib_init"]), unflatten, x, y)
    want = torch.tensor(fix["calib_map"])
    assert float(torch.linalg.norm(params - want) / torch.linalg.norm(want)) < 1e-4
    assert abs(loss / float(fix["calib_map_loss"]) - 1) < 1e-4


def test_make_data_at_full_width():
    x, y = laplace.make_data(1, num=512, dim=256, num_classes=10)
    assert x.shape == (512, 256) and x.dtype == np.float32
    assert y.shape == (512, 10) and y.dtype == np.float32
    np.testing.assert_array_equal(y.argmax(axis=1), np.arange(512) % 10)
    np.testing.assert_array_equal(y.sum(axis=1), 1.0)
    again, _ = laplace.make_data(1, num=512, dim=256, num_classes=10)
    np.testing.assert_array_equal(x, again)
    assert not np.array_equal(x, laplace.make_data(2, num=512, dim=256, num_classes=10)[0])
    # Clusters: each class's mean lies near its centre, 2 N(0, I) away from the origin.
    centres = np.stack([x[y.argmax(axis=1) == c].mean(axis=0) for c in range(10)])
    assert 1.5 < float(np.sqrt((centres**2).mean())) < 2.5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rmsprop_and_adam_match_optax(dtype):
    rng = np.random.default_rng(0)
    params0 = rng.standard_normal(7).astype(dtype)
    grads = [rng.standard_normal(7).astype(dtype) * 10.0 ** k for k in (-1, 0, 1, 0, -1)]
    for ours, theirs in ((laplace.RMSprop, optax.rmsprop(0.1)), (laplace.Adam, optax.adam(0.1))):
        with jax.enable_x64(dtype == np.float64):
            p_j = jnp.asarray(params0)
            state = theirs.init(p_j)
            for g in grads:
                updates, state = theirs.update(jnp.asarray(g), state)
                p_j = optax.apply_updates(p_j, updates)
        p = torch.tensor(params0)
        optimizer = ours(p, 0.1)
        for g in grads:
            p = optimizer.update(p, torch.tensor(g))
        rtol = 1e-6 if dtype == np.float32 else 1e-13
        np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=rtol, atol=rtol)
    # Not torch.optim.RMSprop: decay 0.99, eps outside the root.
    p = torch.tensor(params0, requires_grad=True)
    torch_rms = torch.optim.RMSprop([p], lr=0.1)
    p.grad = torch.tensor(grads[0])
    torch_rms.step()
    ours = laplace.RMSprop(torch.tensor(params0), 0.1).update(torch.tensor(params0), torch.tensor(grads[0]))
    assert not torch.allclose(p.detach(), ours)


def test_auroc_matches_the_jax_driver(monkeypatch):
    drivers = REPO / "experiments/applications/linearised_laplace"
    monkeypatch.syspath_prepend(str(drivers))  # it imports callibration.py
    driver = _load(drivers / "compute_metrics_lanczos.py", "_compute_metrics_lanczos")
    rng = np.random.default_rng(1)
    scores_id, scores_ood = rng.uniform(0.5, 1.0, 40), rng.uniform(0.3, 0.9, 60)
    assert laplace.auroc(scores_id, scores_ood) == driver.auroc(scores_id, scores_ood)


def test_fixture_runs_only_the_parity_configuration(tmp_path):
    with pytest.raises(ValueError, match="parity configuration"):
        _run(tmp_path, "callibration", "--num_epochs", "1", "--hidden", "8")
    with pytest.raises(ValueError, match="epochs, probes"):
        _run(tmp_path, "callibration", "--num_epochs", "4")
    with pytest.raises(ValueError, match="CUDA events"):
        laplace.main(["callibration", "--num_epochs", "1", "--map_epochs", "1", "--num_data", "16",
                      "--time", "--device", "cpu", "--out", str(tmp_path)])
