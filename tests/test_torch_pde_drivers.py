"""The wave-PDE drivers of the port (``train.pde``, ``train.pde_data``,
``train.pde_workprecision``, ``train.pde_report``) against the JAX drivers
of ``experiments/applications/partial_differential_equation/`` on the CPU.

- The epoch loop at 32 x 32 (Arnoldi depth 4, 4 epochs) from the JAX run's
  flax weights (``train/pde_s1.npz``) against the committed
  ``32x32_arnoldi_s1`` series: losses within 1e-5 relative, the learned
  field within 1e-4 of its largest value, the files' names, dtypes and
  shapes; Euler for 2 epochs against the JAX loss and optax's Adam steps
  rebuilt from the JAX package, within 1e-4.
- ``models.pde.pde_wave_anisotropic`` on a ``(3, 2, 2, n, n)`` batch of
  states against the JAX package's under two ``vmap``s, and each state
  against its own unbatched call.
- ``solver_rk4`` against ``make_data.solver_rk4`` on the bundled 32 x 32
  pairs within 1e-5 of the targets' largest value, and both RK4 misses
  against the bundled targets against the fixture's (JAX's) within 1e-6.
- ``make_data`` at 32 x 32 (4 pairs, 100 RK4 steps) with the same numpy
  draws given to both GRF samplers (and as the bells' centres), the JAX
  script run from a copy under ``tmp_path``: the field and the pairs
  within 1e-4 of their largest values.
- The work-precision sweep (Arnoldi depth 4 and RK4 with 8 steps, against
  RK4 with 512 steps) against JAX's: in float64 at 32 x 32 each error
  within 1e-6 relative; in float32 at 64 x 64 Arnoldi depth 4 (truncation error,
  1.5e-4) within 1 % relative, and RK4 (at the float32 rounding floor,
  ~1.2e-5) at most 2e-5 in both.
- ``show_table``'s text equal to JAX's on the committed series; each
  figure written as a non-empty file.
- No new module imports jax, the JAX package, matplotlib or pandas when
  imported.

Everything runs on one intra-op thread.
"""

import ast
import importlib.util
import json
import runpy
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.models import pde as jpde  # noqa: E402
from lanczos_adjoints_tpu.utils import exp_util  # noqa: E402
from lanczos_adjoints_tpu_torch.train import pde as train_pde  # noqa: E402
from lanczos_adjoints_tpu_torch.train import pde_data, pde_report, pde_workprecision  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DRIVERS = REPO / "experiments/applications/partial_differential_equation"
RESULTS = REPO / "results/applications/partial_differential_equation"
# The float32 work-precision errors that are rounding, not truncation, stay below this.
WP_F32_FLOOR = 2e-5
NEW_MODULES = ("train.pde", "train.pde_data", "train.pde_workprecision", "train.pde_report",
               "train.laplace", "train.laplace_table")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _driver_args(tmp_path, *extra):
    return ["--resolution", "32", "--num_matvecs", "4", "--num_epochs", "4", "--device", "cpu",
            "--out", str(tmp_path), "--fixture", str(train_pde.FIXTURE), *extra]


def test_driver_at_32_reproduces_the_committed_series(tmp_path):
    assert train_pde.main(_driver_args(tmp_path)) == 0
    committed = RESULTS / "train"
    for name in ("convergence", "timestamps", "matvecs", "scale_field"):
        got = np.load(tmp_path / f"32x32_arnoldi_s1_{name}.npy")
        want = np.load(committed / f"32x32_arnoldi_s1_{name}.npy")
        assert (got.dtype, got.shape) == (want.dtype, want.shape), name
    conv = np.load(tmp_path / "32x32_arnoldi_s1_convergence.npy")
    want = np.load(committed / "32x32_arnoldi_s1_convergence.npy")
    assert np.max(np.abs(conv / want - 1.0)) < 1e-5
    np.testing.assert_array_equal(np.load(tmp_path / "32x32_arnoldi_s1_matvecs.npy"),
                                  np.load(committed / "32x32_arnoldi_s1_matvecs.npy"))
    field = np.load(tmp_path / "32x32_arnoldi_s1_scale_field.npy")
    want_field = np.load(committed / "32x32_arnoldi_s1_scale_field.npy")
    assert np.max(np.abs(field - want_field)) < 1e-4 * np.max(np.abs(want_field))
    stamps = np.load(tmp_path / "32x32_arnoldi_s1_timestamps.npy")
    assert np.all(np.diff(stamps) > 0)


def test_steps_per_call_shares_the_chunk_end_time(tmp_path):
    out = train_pde.run(train_pde.build_argparser().parse_args(_driver_args(tmp_path, "--steps_per_call", "2")))
    stamps = out["timestamps"]
    assert stamps.shape == (4,) and stamps[0] == stamps[1] and stamps[2] == stamps[3] > stamps[1]
    want = np.load(RESULTS / "train/32x32_arnoldi_s1_convergence.npy")
    assert np.max(np.abs(out["convergence"] / want - 1.0)) < 1e-5
    with pytest.raises(ValueError, match="seed"):
        train_pde.run(train_pde.build_argparser().parse_args(_driver_args(tmp_path, "--seed", "2")))


def _jax_euler_series(variables, epochs, num_matvecs=10):
    """``train.py``'s losses before each Adam step (Euler, 32 x 32), from the JAX package and optax."""
    import optax

    inputs, targets = (jnp.asarray(a) for a in train_pde.load_data(32, device="cpu"))
    xs_1d = jnp.linspace(0.0, 1.0, 32)
    mesh = jpde.mesh_tensorproduct(xs_1d, xs_1d)
    stencil = jpde.stencil_laplacian(float(xs_1d[1] - xs_1d[0]))
    parametrize, _ = jpde.pde_wave_anisotropic(mesh[0], stencil, constrain=lambda s: s**2,
                                               boundary=jpde.boundary_dirichlet())
    solve = jpde.solver_euler(jnp.linspace(0.0, 1.0, num_matvecs + 1),
                              lambda y, scale: parametrize(scale=scale)(y))
    _, apply = jpde.model_mlp(mesh, (500, 500, 1), activation=jnp.tanh, output_scale_raw=-5.0)
    params, unflatten = jax.flatten_util.ravel_pytree(jax.tree_util.tree_map(jnp.asarray, variables))
    loss_mse = jpde.loss_mse_relative(nugget=1e-4)

    def loss_fn(p):
        scale = apply(unflatten(p), mesh)
        return jnp.mean(jax.vmap(lambda y0, y1: loss_mse(solve(y0, scale)[0], targets=y1))(inputs, targets))

    optimizer = optax.adam(1e-2)
    state = optimizer.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(epochs):
        value, grads = value_and_grad(params)
        updates, state = optimizer.update(grads, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(value))
    return np.asarray(losses)


def test_euler_at_32_matches_the_jax_training_loss(tmp_path):
    fix = train_pde.load_fixture()
    want = _jax_euler_series(train_pde.flax_variables(fix), 2)
    args = train_pde.build_argparser().parse_args(
        ["--resolution", "32", "--method", "euler", "--num_epochs", "2", "--device", "cpu", "--out", str(tmp_path)])
    out = train_pde.run(args, fixture=fix)
    assert np.max(np.abs(out["convergence"] / want - 1.0)) < 1e-4
    np.testing.assert_array_equal(out["matvecs"], [80, 80])
    assert (tmp_path / "32x32_euler_s1_scale_field.npy").exists()


def test_rk4_solver_matches_make_data_on_the_bundled_pairs():
    make_data = _load(DRIVERS / "make_data.py", "_pde_make_data")
    inputs, targets, parameter = (np.asarray(a) for a in pde_data.bundled(32, device="cpu"))
    xs_1d = jnp.linspace(0.0, 1.0, 32)
    parametrize, _ = jpde.pde_wave_anisotropic(
        jnp.asarray(parameter), jpde.stencil_laplacian(float(xs_1d[1] - xs_1d[0])), constrain=lambda s: s**2,
        boundary=jpde.boundary_dirichlet())
    rhs = parametrize(scale=jnp.asarray(parameter))
    want = np.asarray(jax.jit(jax.vmap(make_data.solver_rk4(jnp.linspace(0.0, 1.0, 400), lambda y: rhs(y))))(
        jnp.asarray(inputs)))
    max_rel, norm_rel, got = pde_data.bundled_miss(32, device="cpu")
    assert np.max(np.abs(got.numpy() - want)) < 1e-5 * np.max(np.abs(want))
    fix = train_pde.load_fixture()
    np.testing.assert_allclose([max_rel, norm_rel], fix["rk4_miss/32"], rtol=0, atol=1e-6)
    assert fix["rk4_miss/32"][0] > 1e-2  # the bundled targets are not this RK4's (see the fixture's export)


def test_batched_wave_equation_matches_the_jax_vmap():
    from lanczos_adjoints_tpu_torch.models import pde

    n = 12
    rng = np.random.default_rng(3)
    states, scale = rng.standard_normal((3, 2, 2, n, n)).astype(np.float32), rng.standard_normal((n, n))
    scale = scale.astype(np.float32)
    stencil_j = jpde.stencil_laplacian(0.2)
    rhs_j = jpde.pde_wave_anisotropic(jnp.asarray(scale), stencil_j, constrain=jnp.square,
                                      boundary=jpde.boundary_dirichlet())[0](scale=jnp.asarray(scale))
    want = np.asarray(jax.vmap(jax.vmap(rhs_j))(jnp.asarray(states)))
    rhs = pde.pde_wave_anisotropic(torch.tensor(scale), pde.stencil_laplacian(0.2), constrain=torch.square,
                                   boundary=pde.boundary_dirichlet())[0](scale=torch.tensor(scale))
    got = rhs(torch.tensor(states))
    assert got.shape == (3, 2, 2, n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for i in range(3):
        one = rhs(torch.tensor(states[i, 1])).numpy()
        np.testing.assert_allclose(one, got[i, 1].numpy(), rtol=0, atol=1e-6 * np.abs(one).max())
    with pytest.raises(ValueError, match="state shape"):
        rhs(torch.tensor(states).reshape(3, 4, n, n))


def test_make_data_at_32_with_numpy_draws_matches_the_jax_script(tmp_path):
    n, num = 32, 4
    rng = np.random.default_rng(7)
    field_draws = rng.standard_normal((1, n * n)).astype(np.float32)
    centers = rng.standard_normal((num, 2)).astype(np.float32)
    script_dir = tmp_path / "experiments/applications/partial_differential_equation"
    script_dir.mkdir(parents=True)
    shutil.copy(DRIVERS / "make_data.py", script_dir / "make_data.py")
    split = jax.random.split

    def fake_split(key, num_keys=2):
        if num_keys == num:  # the bells' keys: each an index into ``centers``
            return jnp.stack([jnp.arange(num, dtype=jnp.uint32)] * 2, axis=1)
        return split(key, num_keys)

    def fake_normal(key, shape, *args, **kwargs):
        return jnp.asarray(centers)[key[0]] if tuple(shape) == (2,) else jnp.asarray(field_draws)

    with mock.patch.object(jax.random, "split", fake_split), mock.patch.object(jax.random, "normal", fake_normal), \
            mock.patch.object(sys, "argv", ["make_data.py", "--resolution", str(n), "--num_data", str(num),
                                            "--num_steps", "100"]):
        runpy.run_path(str(script_dir / "make_data.py"), run_name="__main__")
    jax_dir = exp_util.matching_directory(str(script_dir / "make_data.py"), "data/")
    np.savez(tmp_path / "draws.npz", field_draws=field_draws, centers=centers)
    assert pde_data.main(["--resolution", str(n), "--num_data", str(num), "--num_steps", "100", "--device", "cpu",
                          "--out", str(tmp_path / "port"), "--fixture", str(tmp_path / "draws.npz")]) == 0
    for name in ("parameter", "inputs", "targets"):
        want = np.load(f"{jax_dir}{n}x{n}_data_{name}.npy")
        got = np.load(tmp_path / "port" / f"{n}x{n}_data_{name}.npy")
        assert (got.dtype, got.shape) == (want.dtype, want.shape), name
        assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want)), name
    with pytest.raises(ValueError, match="bundled"):
        pde_data.main(["--resolution", str(n), "--device", "cpu", "--out", str(pde_data.DATA)])


def _jax_sweep(resolution, depths, rk4_steps, reference_steps=512):
    """``workprecision.py``'s sweep from the JAX package (its ``rk4``), reduced."""
    rk4 = _load(DRIVERS / "workprecision.py", "_pde_workprecision").rk4
    xs_1d = jnp.linspace(0.0, 1.0, resolution)
    mesh = jpde.mesh_tensorproduct(xs_1d, xs_1d)
    parametrize, _ = jpde.pde_wave_anisotropic(mesh[0], jpde.stencil_laplacian(float(xs_1d[1] - xs_1d[0])),
                                               constrain=jnp.square, boundary=jpde.boundary_dirichlet())
    init_bell, _ = jpde.pde_init_bell(5.0)
    u0 = init_bell(center_logits=jnp.zeros(2))(mesh)
    y0 = jnp.stack([u0, jnp.zeros_like(u0)])
    scale = 0.035 * jnp.ones((resolution, resolution))
    vf = lambda y, s: parametrize(scale=s)(y)  # noqa: E731

    def grad_of(solve):
        return np.asarray(jax.jit(jax.grad(lambda s: jnp.mean(solve(y0, s)[0][0] ** 2)))(scale))

    g_ref = grad_of(rk4(reference_steps, vf))
    errors = [grad_of(jpde.solver_expm(0.0, 1.0, vf, jpde.expm_arnoldi(d))) for d in depths]
    errors += [grad_of(rk4(steps, vf)) for steps in rk4_steps]
    return [float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)) for g in errors]


@pytest.mark.parametrize("x64", [False, True])
def test_workprecision_sweep_at_32_matches_jax(x64):
    # float32 at 64 x 64 (the JAX script's default), where Arnoldi depth 4 is
    # truncation error (1.5e-4 against a float32 floor of ~1.2e-5); at 32 x 32
    # both are ~5e-5. float64 at 32 x 32.
    depths, rk4_steps, resolution = (4,), (8,), 32 if x64 else 64
    with jax.enable_x64(x64):
        want = _jax_sweep(resolution, depths, rk4_steps)
    rows = pde_workprecision.sweep(resolution, x64=x64, device="cpu", depths=depths, rk4_steps=rk4_steps)
    assert [(r["method"], r["num_matvecs"]) for r in rows] == [("arnoldi", 4), ("rk4", 32)]
    got = [r["error"] for r in rows]
    if x64:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        # Arnoldi depth 4 is truncation error: 1 %, as on the card. RK4 with 8
        # steps sits at the float32 rounding floor, where only a bound holds.
        np.testing.assert_allclose(got[0], want[0], rtol=1e-2)
        assert max(got[1], want[1]) <= WP_F32_FLOOR


def test_workprecision_command_writes_the_jax_file(tmp_path):
    assert pde_workprecision.main(["--resolution", "16", "--device", "cpu", "--out", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "workprecision_s1.json").read_text())
    committed = json.loads((RESULTS / "workprecision/workprecision_s1.json").read_text())
    assert [list(r) for r in rows] == [list(r) for r in committed]
    assert [(r["method"], r["num_matvecs"]) for r in rows] == [(r["method"], r["num_matvecs"]) for r in committed]
    assert all(np.isfinite(r["error"]) for r in rows)


def test_show_table_prints_what_the_jax_script_prints(capsys):
    from lanczos_adjoints_tpu.utils import exp_util as jexp_util

    with mock.patch.object(jexp_util, "matching_directory", lambda *_a, **_k: f"{RESULTS}/show_table/"), \
            mock.patch.object(sys, "argv", ["show_table.py"]):
        runpy.run_path(str(DRIVERS / "show_table.py"), run_name="__main__")
    want = capsys.readouterr().out
    got = pde_report.show_table(RESULTS / "train")
    assert capsys.readouterr().out == got == want
    assert "128x128" in got and "euler" in got


def test_figures_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    paths = [
        pde_report.plot_workprecision(RESULTS / "workprecision", tmp_path),
        pde_report.plot_solution(32, RESULTS / "train", tmp_path),
    ]
    assert pde_report.main(["plot", "--what", "training", "--resolution", "128", "--results",
                            str(RESULTS / "train"), "--figures", str(tmp_path / "cli")]) == 0
    paths.append(tmp_path / "cli" / "training_128.pdf")
    for path in paths:
        assert Path(path).stat().st_size > 0, path


def _module_level_imports(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_new_modules_import_no_jax_matplotlib_or_pandas():
    banned = ("jax", "jaxlib", "lanczos_adjoints_tpu", "matplotlib", "pandas")
    for module in NEW_MODULES:
        path = REPO / "lanczos_adjoints_tpu_torch" / (module.replace(".", "/") + ".py")
        for name in _module_level_imports(path):
            assert name.split(".")[0] not in banned, f"{module} imports {name} at module level"
    code = ("import sys; before = set(sys.modules)\n"
            + "".join(f"import lanczos_adjoints_tpu_torch.{m}\n" for m in NEW_MODULES)
            + "print(sorted({m.split('.')[0] for m in set(sys.modules) - before}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=REPO)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(banned), loaded & set(banned)


def test_the_fixture_holds_what_the_export_asserts():
    fix = train_pde.load_fixture()
    sizes = {key: fix[f"mlp/{key}"].size for key in
             ("Dense_0/kernel", "Dense_0/bias", "Dense_1/kernel", "Dense_1/bias", "Dense_2/kernel", "Dense_2/bias")}
    assert sum(sizes.values()) == 252_501
    for label, epochs in (("32x32_arnoldi", 4), ("128x128_arnoldi", 5), ("128x128_euler", 5)):
        assert fix[f"{label}/convergence"].shape == fix[f"{label}/convergence_f64"].shape == (epochs,)
    np.testing.assert_allclose(fix["32x32_arnoldi/convergence"],
                               np.load(RESULTS / "train/32x32_arnoldi_s1_convergence.npy"), rtol=1e-6)
