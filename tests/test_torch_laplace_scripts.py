"""The last two linearised-Laplace scripts of the port against the JAX ones, on the CPU.

- ``train.laplace gridsearch`` (``plot_callibration_loss.py``) at the
  parity MLP of 3,709 parameters, from the calibration run's MAP vector,
  on the grid search's own probes (``train/laplace_s1.npz``, written by
  ``scripts/export_laplace_s1.py``): in float64 each loss within 1e-6 of
  JAX's float64 run; in float32 each within 1e-4 of JAX's float64 run and
  of its float32 run less ``laplace.jax_float32_dot_bias`` (that run sits
  0.117-0.122 above its float64 run at every alpha, 1.9e-3 at the
  smallest: its Arnoldi start divides by an ordered float32 sum of 3,709
  equal squares, 3.2e-5 short of 1; so corrected it is within 3.0e-5 of
  its float64 run), every tensor of the port's float32 loss float32; the
  command's file against the committed ``s1_gridsearch.npz`` in names,
  dtypes and shapes, and its figure.
- ``train.laplace_table`` (``create_dataframe.py``) byte for byte against
  the committed ``dataframe.csv`` and ``table.tex`` and against the JAX
  script run from a copy under ``tmp_path``, on the files it ran on; the
  ``ValueError`` naming the file on today's results.

A subset of the 9 x 5 grid runs here (each loss takes ~0.5 s on one
thread); the whole grid runs on the card (``chip_smoke.py``). A fixture
that lacks the asked probes is refused before the MAP training.
"""

import runpy
import shutil
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lanczos_adjoints_tpu_torch.models import bnn  # noqa: E402
from lanczos_adjoints_tpu_torch.train import laplace, laplace_table  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "experiments/applications/linearised_laplace"
RESULTS = REPO / "results/applications/linearised_laplace"
# The files create_dataframe.py ran on when it wrote the committed table.
TABLE_FILES = ("callibration/s1_alpha.npy", "callibration/s1_curve.npy", "callibration_diag/s1_alpha.npy",
               "callibration_diag/s1_curve.npy", "compute_metrics_lanczos/s1_metrics.json")


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fix():
    return laplace.fixture()


def _grid(fix, rows, samples, dtype):
    x = torch.tensor(fix["calib_x"], dtype=dtype)
    init, apply = bnn.model_mlp(out_dims=4, activation=torch.tanh)
    _, unflatten, _ = bnn.vectorize_nn(apply, init(torch.Generator().manual_seed(0), x))
    probes = torch.tensor(fix["grid_probes"][rows][:, :samples], dtype=dtype)
    return laplace.gridsearch(apply, unflatten, torch.tensor(fix["calib_map"], dtype=dtype), x,
                              torch.tensor(fix["calib_y"], dtype=dtype), fix["grid_log_alphas"][rows],
                              num_loss_samples=samples, probes=probes)


def test_gridsearch_float32_against_the_jax_runs(fix):
    rows, samples = [0, 8], 3
    values, losses, stds = _grid(fix, rows, samples, torch.float32)
    want32, want64 = fix["grid_values"][rows][:, :samples], fix["grid_values_f64"][rows][:, :samples]
    assert np.max(np.abs(values / want64 - 1.0)) < 1e-4
    bias = laplace.jax_float32_dot_bias(fix["grid_probes"][rows][:, :samples])
    assert np.max(np.abs(values / (want32 - bias) - 1.0)) < 1e-4
    np.testing.assert_allclose(losses, want64.mean(axis=1), rtol=1e-4)
    np.testing.assert_allclose(stds, want64.std(axis=1), rtol=1e-2)
    np.testing.assert_allclose(fix["grid_losses"], fix["grid_values"].mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(fix["grid_stds_f64"], fix["grid_values_f64"].std(axis=1), rtol=1e-12)


def test_jax_float32_grid_offset_is_its_start_vectors_ordered_dot(fix):
    bias = laplace.jax_float32_dot_bias(fix["grid_probes"])
    assert bias.shape == (9, 5) and np.all((0.11 < bias) & (bias < 0.13))
    spread = fix["grid_values"] / fix["grid_values_f64"] - 1.0
    assert np.max(np.abs(spread)) > 1e-3
    assert np.max(np.abs((fix["grid_values"] - bias) / fix["grid_values_f64"] - 1.0)) < 1e-4


def test_gridsearch_float32_computes_in_float32_throughout(fix):
    seen = set()

    class Dtypes(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    seen.add(t.dtype)
            return out

    with Dtypes():
        _grid(fix, [4], 1, torch.float32)
    assert seen == {torch.float32}


def test_gridsearch_float64_against_the_jax_float64_run(fix):
    rows = [0, 8]
    values, _, _ = _grid(fix, rows, 1, torch.float64)
    np.testing.assert_allclose(values, fix["grid_values_f64"][rows][:, :1], rtol=1e-6)


def test_gridsearch_command_writes_the_jax_file(fix, tmp_path):
    argv = ["gridsearch", "--device", "cpu", "--out", str(tmp_path), "--fixture", str(laplace.FIXTURE),
            "--log_alphas", "2.0", "--num_loss_samples", "1", "--figures", str(tmp_path / "figures"),
            "--calibrated", str(RESULTS / "callibration/s1_alpha.npy")]
    assert laplace.main(argv) == 0
    got = np.load(tmp_path / "s1_gridsearch.npz")
    committed = np.load(RESULTS / "plot_callibration_loss/s1_gridsearch.npz")
    assert got.files == committed.files
    for name in got.files:
        assert got[name].dtype == committed[name].dtype and got[name].ndim == committed[name].ndim == 1
    np.testing.assert_array_equal(got["log_alphas"], [2.0])
    np.testing.assert_allclose(got["losses"], fix["grid_values_f64"][[8], 0], rtol=1e-4)
    np.testing.assert_array_equal(got["stds"], [0.0])
    for suffix in ("pdf", "png"):
        assert (tmp_path / "figures" / f"s1_callibration_loss.{suffix}").stat().st_size > 0
    with pytest.raises(ValueError, match="log_alphas"):
        laplace.main([*argv[:7], "--log_alphas", "0.25"])


def _original_results(root):
    for name in TABLE_FILES:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(RESULTS / name, root / name)
    return root


def test_table_is_byte_equal_to_the_committed_one(tmp_path):
    base = _original_results(tmp_path / "results/applications/linearised_laplace")
    assert laplace_table.main(["--results", str(base), "--out", str(tmp_path / "port")]) == 0
    script = tmp_path / "experiments/applications/linearised_laplace/create_dataframe.py"
    script.parent.mkdir(parents=True)
    shutil.copy(SCRIPTS / "create_dataframe.py", script)
    with mock.patch.object(sys, "argv", ["create_dataframe.py"]):
        runpy.run_path(str(script), run_name="__main__")
    for name in ("dataframe.csv", "table.tex"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (RESULTS / "create_dataframe" / name).read_bytes(), name
        assert got == (base / "create_dataframe" / name).read_bytes(), name


def test_table_refuses_a_file_its_pattern_cannot_parse(tmp_path):
    with pytest.raises(ValueError, match="s1_p3688970_rank10_alpha.npy"):
        laplace_table.main(["--results", str(RESULTS), "--out", str(tmp_path)])
    assert not (tmp_path / "dataframe.csv").exists()


def test_table_writes_missing_values_as_pandas_does():
    rows = {"a": {"x": 1.5, "n": 3}, "b": {"y": 0.25}}
    assert laplace_table.to_csv(rows) == ",x,n,y\na,1.5,3.0,\nb,,,0.25\n"
    assert laplace_table.to_latex(rows).splitlines()[:5] == [
        r"\begin{tabular}{lccc}", r"\toprule", r" & x & n & y \\", r"\midrule", r"a & 1.500 & 3.000 & -- \\"]
