"""The port's utilities (ROADMAP A11) against the JAX package's, on the CPU.

``utils.data`` and ``utils.uci`` read ``.npy`` and ``.csv.gz`` files that
each test writes under ``tmp_path`` and equal the JAX loaders on the same
files; ``utils.timing``, ``utils.test_util``, ``utils.exp_util``,
``precond.low_rank.cholesky_partial``, ``krylov.deprecated`` and
``train.nll_study`` are held to the JAX package at the tolerances of its
own tests (``tests/test_utils``, ``tests/test_precond/test_low_rank.py``,
``tests/test_krylov/test_deprecated_integrands.py``). The JAX recursive-VJP
integrand cannot be differentiated (its tier-1 test fails), so the port's
is held to backprop through ``tridiag(custom_vjp=False)`` in float64 at
that test's tolerance. Last, the Laplace metrics at the JAX run's
Ritz-vector signs (ROADMAP C7) against the committed fixture.
"""

import argparse
import gzip
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu import trace as jtrace  # noqa: E402
from lanczos_adjoints_tpu.krylov import deprecated as jdeprecated  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.utils import data as jdata  # noqa: E402
from lanczos_adjoints_tpu.utils import exp_util as jexp_util  # noqa: E402
from lanczos_adjoints_tpu.utils import test_util as jtest_util  # noqa: E402
from lanczos_adjoints_tpu.utils import uci as juci  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import deprecated, lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.precond import low_rank  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.train import laplace, nll_study  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import data, exp_util, test_util, timing, uci  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# utils.data and utils.uci, on files written under tmp_path
# ---------------------------------------------------------------------------


def _write_csv_gz(path, table, fmt):
    os.makedirs(path.parent, exist_ok=True)
    with gzip.open(path, "wt") as fp:
        np.savetxt(fp, table, delimiter=",", fmt=fmt)


@pytest.fixture
def uci_files(tmp_path, monkeypatch):
    """A ``.npy`` cache for ``concrete`` and a Wu-et-al. csv for ``elevators``, under ``./data``."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "data/uci_processed/concrete")
    np.save(tmp_path / "data/uci_processed/concrete/inputs.npy", rng.standard_normal((40, 8)) * 3 + 1)
    np.save(tmp_path / "data/uci_processed/concrete/targets.npy", rng.standard_normal(40) + 5)
    table = np.concatenate([rng.standard_normal((30, 5)) * 2, 7 + rng.standard_normal((30, 1))], axis=1)
    table[:, 2] = 1.5  # a constant column: z-scored by 1
    masks = (rng.random((30, 3)) < 0.3).astype(np.int64)
    _write_csv_gz(tmp_path / "data/uci/elevators/data.csv.gz", table, "%.17g")
    _write_csv_gz(tmp_path / "data/uci/elevators/test_mask.csv.gz", masks, "%d")
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("normalize", [True, "standardize", False])
@pytest.mark.parametrize("name", ["concrete", "elevators"])
def test_uci_loaders_match_jax(uci_files, name, normalize):
    got = getattr(uci, f"uci_{name}")(normalize=normalize)
    want = getattr(juci, f"uci_{name}")(normalize=normalize)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(FileNotFoundError, match="song"):
        uci.uci_song()
    # The driver takes every uci_* name; the missing one raises the loader's error.
    np.testing.assert_allclose(train_gp.load_data(name)[0], juci.__dict__[f"uci_{name}"]()[0], rtol=1e-12)
    with pytest.raises(FileNotFoundError, match="protein"):
        train_gp.load_data("protein")


def test_uci_loader_names_match_jax():
    names = sorted(n for n in dir(juci) if n.startswith("uci_"))
    assert sorted(n for n in dir(uci) if n.startswith("uci_")) == names and len(names) == 20


@pytest.mark.parametrize("split", [0, 2])
def test_load_uci_data_matches_jax(uci_files, split):
    root = str(uci_files / "data/uci")
    got = data.load_uci_data("elevators", split=split, root=root)
    want = jdata.load_uci_data("elevators", split=split, root=root)
    for part_got, part_want in zip(got[:2], want[:2]):
        for a, b in zip(part_got, part_want):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for key in want[2]:
        np.testing.assert_allclose(got[2][key], want[2][key], rtol=1e-12)
    with pytest.raises(FileNotFoundError, match="not found"):
        data.load_uci_data("kin40k", root=root)


def test_splits_collate_and_seed_match_jax():
    x, y = np.arange(100.0)[:, None], np.arange(100.0)
    for a, b in zip(data.split_train_test(x, y, train_fraction=0.8),
                    jdata.split_train_test(jnp.asarray(x), jnp.asarray(y), train_fraction=0.8)):
        np.testing.assert_array_equal(a[0], np.asarray(b[0]))
    batch = [(np.full((3, 2), float(i)), np.eye(4)[i % 4]) for i in range(5)]
    got, want = data.numpy_collate_fn(batch), jdata.numpy_collate_fn(batch)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    data.set_seed(3)
    first = (np.random.rand(), torch.rand(()).item())
    data.set_seed(3)
    assert (np.random.rand(), torch.rand(()).item()) == first


# ---------------------------------------------------------------------------
# utils.timing: the JAX package's tests of its timing helpers
# ---------------------------------------------------------------------------


def test_slope_time_positive_and_reasonable():
    A = torch.ones((256, 256))
    t = timing.slope_time(lambda x: A @ x, torch.ones((256,)), reps=4, outer=2)
    assert isinstance(t, float)
    assert -1.0 < t < 1.0


def test_wallclock_time_positive():
    assert timing.wallclock_time(lambda x: torch.sum(x**2), torch.ones((64,))) >= 0.0


def test_slope_time_budget_fallback_never_escalates():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    t, info = timing.slope_time(fn, torch.ones((8,)), budget_s=0.0, return_info=True)
    assert t > 0.0
    assert info["fallback_wallclock"] is True and info["budget_exhausted"] is True
    assert info["resolved"] is False and info["reps"] == 1
    assert len(calls) <= 2


def test_slope_time_budget_stops_escalation():
    A = torch.ones((1024, 1024))
    with pytest.warns(UserWarning, match="stayed below"):
        _t, info = timing.slope_time(lambda x: A @ x, torch.ones((1024, 1024)), reps=2, outer=2,
                                     min_window=1e9, budget_s=0.5, return_info=True)
    assert info["resolved"] is False and info["budget_exhausted"] is True
    assert info["reps"] < 4096


def test_profile_to_writes_a_trace(tmp_path):
    with timing.profile_to(str(tmp_path / "trace")):
        torch.ones(16) @ torch.ones(16)
    trace = json.loads((tmp_path / "trace/trace.json").read_text())
    assert trace["traceEvents"]


# ---------------------------------------------------------------------------
# utils.test_util and utils.exp_util
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matrices_from_eigenvalues_have_jax_s_spectra(dtype):
    n = 7
    eigvals = np.linspace(1.0, 3.0, n)
    g = torch.Generator().manual_seed(n)
    sym = test_util.symmetric_matrix_from_eigenvalues(torch.tensor(eigvals, dtype=dtype), generator=g)
    sym_j = np.asarray(jtest_util.symmetric_matrix_from_eigenvalues(jnp.asarray(eigvals, jnp.float32)))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert torch.allclose(sym, sym.T, atol=tol)
    np.testing.assert_allclose(torch.linalg.eigvalsh(sym).numpy(), np.linalg.eigvalsh(sym_j), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.eigvalsh(sym).numpy(), eigvals, atol=10 * tol)
    asym = test_util.asymmetric_matrix_from_eigenvalues(torch.tensor(eigvals, dtype=dtype), generator=g)
    assert not torch.allclose(asym, asym.T)
    np.testing.assert_allclose(np.sort(np.linalg.eigvals(asym.numpy()).real), eigvals, atol=1e-4)
    q, _ = torch.linalg.qr(torch.randn((9, 4), generator=g, dtype=dtype))
    test_util.assert_columns_orthonormal(q)
    with pytest.raises(AssertionError):
        test_util.assert_columns_orthonormal(2 * q)
    test_util.assert_allclose(q, q + 1e-9)
    with pytest.raises(AssertionError):
        test_util.assert_allclose(q, q + 1e-2)


def test_exp_util_matches_jax(tmp_path):
    np.testing.assert_allclose(exp_util.hilbert(5).numpy(), np.asarray(jexp_util.hilbert(5)), rtol=1e-7)
    tree = {"b": (torch.zeros((2, 2)),), "a": torch.zeros((3,)), "c": [torch.zeros(()), torch.zeros((1, 2))]}
    sample = exp_util.tree_random_like(torch.Generator().manual_seed(0), tree)
    assert sample["a"].shape == (3,) and sample["b"][0].shape == (2, 2) and isinstance(sample["b"], tuple)
    assert not torch.allclose(sample["a"], torch.zeros(3))
    # One flat draw, in ravel_pytree's order.
    tree_j = {"b": (jnp.zeros((2, 2)),), "a": jnp.zeros((3,)), "c": [jnp.zeros(()), jnp.zeros((1, 2))]}
    _flat, unravel = ravel_pytree(tree_j)
    flat = torch.randn((10,), generator=torch.Generator().manual_seed(0))
    want = unravel(jnp.asarray(flat.numpy()))
    for got_leaf, want_leaf in zip(jax.tree_util.tree_leaves(
            {k: [t.numpy() for t in v] if isinstance(v, (list, tuple)) else v.numpy() for k, v in sample.items()}),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(got_leaf, np.asarray(want_leaf))
    path = "/repo/experiments/foo/bar.py"
    assert exp_util.matching_directory(path, "results/") == jexp_util.matching_directory(path, "results/")
    for bad in (("junk/", {}), ("results/", {"replace": "nothere/"})):
        with pytest.raises(ValueError):
            exp_util.matching_directory(path, bad[0], **bad[1])
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax, ax_j) = plt.subplots(1, 2)
    exp_util.plt_spy_coo(ax, [0, 1, 2], [0, 2, 1], shape=(3, 4), markersize=2.0)
    jexp_util.plt_spy_coo(ax_j, [0, 1, 2], [0, 2, 1], shape=(3, 4), markersize=2.0)
    assert ax.get_xlim() == ax_j.get_xlim() and ax.get_ylim() == ax_j.get_ylim()
    np.testing.assert_array_equal(ax.collections[0].get_offsets(), ax_j.collections[0].get_offsets())
    plt.close(fig)


# ---------------------------------------------------------------------------
# precond.low_rank.cholesky_partial
# ---------------------------------------------------------------------------


def _spd(n, decay):
    rng = np.random.default_rng(n)
    basis, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((basis * (np.exp(-decay * np.arange(n)) + 1e-3)) @ basis.T).astype(np.float32)


@pytest.mark.parametrize(("n", "rank"), [(8, 8), (20, 4), (30, 11)])
def test_cholesky_partial_matches_jax(n, rank):
    A = _spd(n, 0.3)
    L, info = low_rank.cholesky_partial(rank=rank)(lambda i, j: torch.tensor(A)[i, j], n)
    L_j, _ = jprecond.cholesky_partial(rank=rank)(lambda i, j: jnp.asarray(A)[i, j], n)
    assert info == {} and L.shape == (n, rank)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), atol=1e-5, rtol=1e-5)
    if rank == n:
        np.testing.assert_allclose((L @ L.T).numpy(), A, atol=1e-5, rtol=1e-5)


def test_cholesky_partial_is_beaten_by_pivoting_and_refuses_a_gradient():
    n, rank = 20, 4
    A = torch.tensor(_spd(n, 1.0))
    L_plain, _ = low_rank.cholesky_partial(rank=rank)(lambda i, j: A[i, j], n)
    L_pivot, _ = low_rank.cholesky_partial_pivot(rank=rank)(lambda i, j: A[i, j], n)
    assert torch.linalg.norm(A - L_pivot @ L_pivot.T) <= 1.001 * torch.linalg.norm(A - L_plain @ L_plain.T)
    raw = A.clone().requires_grad_()

    def element(i, j):
        return raw[i, j]

    element.params = (raw,)
    L, _ = low_rank.cholesky_partial(rank=3)(element, n)
    with pytest.raises(RuntimeError, match="differentiated"):
        torch.sum(L**2).backward()
    with pytest.raises(ValueError, match="Rank exceeds"):
        low_rank.cholesky_partial(rank=10)(element, 5)
    with pytest.raises(ValueError, match="positive"):
        low_rank.cholesky_partial(rank=0)(element, 5)


# ---------------------------------------------------------------------------
# krylov.deprecated
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spd_problem():
    """The JAX test's problem: ``A = p + p^T`` with eigenvalues in [1, 2], n = 8."""
    n = 8
    rng = np.random.default_rng(0)
    basis, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (basis * np.linspace(1.0, 2.0, n)) @ basis.T
    A_half = np.triu(A) - np.diag(0.5 * np.diag(A))
    return n, A_half, rng.standard_normal(n)


def _matvec(s, p):
    return (p + p.T) @ s


def test_value_and_grad_integrand_matches_jax(spd_problem):
    n, A_half, v = spd_problem
    v_unit = (v / np.linalg.norm(v)).astype(np.float32)
    value, grad = deprecated.integrand_spd_value_and_grad(torch.log, n, _matvec)(
        torch.tensor(v_unit), torch.tensor(A_half, dtype=torch.float32))
    value_j, grad_j = jdeprecated.integrand_spd_value_and_grad(jnp.log, n, _matvec)(
        jnp.asarray(v_unit), jnp.asarray(A_half, jnp.float32))
    # The JAX test's tolerances against the exact quadratic form; against JAX the same.
    assert abs(float(value) - float(value_j)) <= 1e-4 + 1e-4 * abs(float(value_j))
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=1e-2, atol=1e-2)
    w, V = np.linalg.eigh(A_half + A_half.T)
    z = V.T @ v_unit
    assert abs(float(value) - n * z @ (np.log(w) * z)) <= 1e-4 + 1e-4 * abs(n * z @ (np.log(w) * z))


def test_recursive_vjp_integrand_matches_backprop(spd_problem):
    n, A_half, v = spd_problem
    v_t = torch.tensor(v)
    p = torch.tensor(A_half, requires_grad=True)
    value = deprecated.integrand_spd_custom_vjp_recursive(torch.log, n, _matvec)(v_t, p)
    (grad,) = torch.autograd.grad(value, [p])

    # Backprop through the float64 tridiagonalisation and eigh.
    p_bp = torch.tensor(A_half, requires_grad=True)
    scale = torch.linalg.vector_norm(v_t)
    (_basis, (d, o)), _ = lanczos.tridiag(_matvec, n, reortho="full", custom_vjp=False)(v_t / scale, p_bp)
    w, V = torch.linalg.eigh(torch.diag(d) + torch.diag(o, 1) + torch.diag(o, -1))
    want = scale**2 * torch.dot(V[0], torch.log(w) * V[0])
    (grad_bp,) = torch.autograd.grad(want, [p_bp])
    assert abs(value.item() - want.item()) <= 1e-4 + 1e-4 * abs(want.item())
    np.testing.assert_allclose(grad.numpy(), grad_bp.numpy(), rtol=0.15, atol=0.1)
    # The polarisation identity: the VJP is that of v^T f'(A) (A(p) v) with f'(A) fixed.
    w_all, V_all = np.linalg.eigh(A_half + A_half.T)
    fv = V_all @ ((1.0 / w_all) * (V_all.T @ v))
    np.testing.assert_allclose(grad.numpy(), np.outer(fv, v) + np.outer(v, fv), rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# train.nll_study against the JAX script's three estimators
# ---------------------------------------------------------------------------


def _jax_estimators(test_x, test_y, params, probes, num_matvecs):
    """``nll_study.py``'s three estimators, on the given test set and probes."""
    ndim = test_x.shape[-1]
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(ndim,), shape_out=())
    prior = jgp.model_gp(mean, kernel)
    constrain = jgp.constraint_greater_than(1e-4)
    _, unflatten = ravel_pytree((p_mean, p_kernel, {"raw_noise": jnp.empty(())}))
    p1, p2, p3 = unflatten(jnp.asarray(params))
    precondition = jprecond.preconditioner(jprecond.cholesky_partial_pivot(rank=100))
    x, y = jnp.asarray(test_x), jnp.asarray(test_y)

    def nll_slq(matfun):
        @jax.jit
        def nll(block):
            logdet = jgp.krylov_logdet_slq(num_matvecs, sample=lambda _k: block, num_batches=1, checkpoint=True,
                                           matfun=matfun)
            solve = jsolvers.pcg_adaptive(rtol=0.0, atol=1e-4, maxiter=10_000, miniter=10)
            likelihood, _ = jgp.likelihood_pdf_p(jgp.gram_matvec(), jgp.logpdf_krylov_p(solve, logdet),
                                                 precondition, constrain=constrain)
            val, _ = jgp.target_logml(prior, likelihood)(x, y, jax.random.PRNGKey(0), params_mean=p1,
                                                         params_kernel=p2, params_likelihood=p3)
            return -val / len(x)

        return [float(nll(jnp.asarray(block))) for block in probes]

    likelihood, _ = jgp.likelihood_pdf(jgp.gram_matvec(), jgp.logpdf_cholesky(), constrain=constrain)
    exact, _ = jgp.target_logml(prior, likelihood)(x, y, params_mean=p1, params_kernel=p2, params_likelihood=p3)
    return {"exact": float(-exact / len(x)),
            "log_clipped": nll_slq(jtrace.slq.log_clipped()), "plain log": nll_slq(jnp.log)}


def test_nll_study_matches_the_jax_estimators(tmp_path):
    params = np.concatenate([[0.05], np.linspace(0.2, 1.0, 8), [0.3], [-1.5]]).astype(np.float32)
    np.save(tmp_path / "t_synthetic_gp500k_s1_params_opt.npy", params)
    argv = ["--name", "t", "--dataset", "synthetic_gp500k", "--num_data", "600", "--num_matvecs", "6",
            "--num_samples", "4", "--num_eval_keys", "2", "--device", "cpu", "--out", str(tmp_path)]
    args = nll_study.build_argparser(argparse.ArgumentParser()).parse_args(argv)
    assert nll_study.build_argparser(argparse.ArgumentParser()).parse_args(["--name", "x"]).device == "cuda"
    _train, (test_x, test_y) = train_gp.split(args)
    probes = np.random.default_rng(9).choice([-1.0, 1.0], size=(2, 4, len(test_x))).astype(np.float32)
    got = nll_study.study(args, probes=[torch.tensor(p) for p in probes])
    want = _jax_estimators(test_x.numpy(), test_y.numpy(), params, probes, num_matvecs=6)
    assert abs(got["exact"] - want["exact"]) <= 1e-5 * abs(want["exact"])
    for label in nll_study.ESTIMATORS:
        np.testing.assert_allclose(got[label], want[label], rtol=1e-4)
    with pytest.raises(FileNotFoundError, match="no saved params"):
        nll_study.study(nll_study.build_argparser(argparse.ArgumentParser()).parse_args(
            [*argv[:1], "missing", *argv[2:]]))


# ---------------------------------------------------------------------------
# ROADMAP C7: the Laplace metrics at the JAX run's Ritz-vector signs
# ---------------------------------------------------------------------------


def test_laplace_metrics_at_matched_signs_equal_the_fixture():
    from lanczos_adjoints_tpu_torch.models import bnn

    fix = laplace.fixture()
    cpu = {name: torch.tensor(fix[name]) for name in (
        "metrics_map", "metrics_x", "metrics_y", "metrics_x_ood", "metrics_eps", "metrics_signs")}
    init, apply = bnn.model_mlp(out_dims=cpu["metrics_y"].shape[-1], activation=torch.tanh)
    _, unflatten, _ = bnn.vectorize_nn(apply, init(torch.Generator().manual_seed(0), cpu["metrics_x"]))
    metrics = laplace.compute_metrics(apply, unflatten, cpu["metrics_map"], cpu["metrics_x"], cpu["metrics_y"],
                                      cpu["metrics_x_ood"], key=cpu["metrics_eps"], signs=cpu["metrics_signs"])
    table = laplace.metrics_table(metrics)
    assert np.all(np.abs(table - fix["metrics"]) <= laplace.metric_tolerances(fix))
    assert np.all(laplace.metric_tolerances(fix) <= 1e-2 * np.abs(fix["metrics"]))
    assert fix["metrics_signs"].shape == (16, 20) and set(np.unique(fix["metrics_signs"])) <= {-1, 1}
    with pytest.raises(ValueError, match="signs of shape"):
        bnn.lanczos_sampler(ggn_vp=lambda v: v, num_samples=2, lanczos_rank=3, key=cpu["metrics_eps"][:2],
                            params_vec=cpu["metrics_map"], signs=torch.ones(2, 4))
