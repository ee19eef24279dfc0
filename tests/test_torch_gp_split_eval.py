"""The GP driver's restarted evaluation (``train.gp`` ``predict_mean_split``)
against the JAX driver's (``experiments/.../train/_common.py``, loaded by
path), with the same numpy parameters, split and arguments, on the CPU.

The problem: N = 512 training points in d = 8, 128 query points, a
rank-16 preconditioner (one block of 16) and ``--cg_maxiter`` 3, so that
the solve takes five chunks of at most three PCG steps, six true
residuals (the last under ``atol``) and a hit of the chunk's cap in four
of them. The inputs are chosen so that no restart's residual RMS lands
within rounding of ``atol`` = 1e-2: the nearest, 1.080e-2 and 7.13e-3, are
8 % and 29 % away from it, in float32 and float64 alike, so both drivers
take the same branches. The JAX driver's restarts are counted by its
jitted calls (``_predict_residual``, ``_predict_chunk``).

- float64 (a scoped ``jax.enable_x64``): the same restarts and chunk
  steps, the means within 1e-9 of the largest entry;
- float32: the same restarts, the means within 1e-4 (the driver
  evaluation tests' tolerance in ``tests/test_torch_gp_driver.py``);
- ``run`` evaluates through ``predict_mean_split`` under
  ``--split_step`` and through ``predict_mean`` without it.

Everything runs on one intra-op thread.
"""

import argparse
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COMMON = REPO / "experiments/applications/gaussian_process/train/_common.py"
N, N_QUERY, D, RANK, MAXITER = 512, 128, 8, 16, 3
ATOL = 1e-2
ARGS = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", str(RANK),
        "--num_partitions", "1", "--num_matvecs", "8", "--num_samples", "4", "--num_epochs", "0",
        "--matvec", "auto", "--slq", "blocked", "--precon_block", "16", "--cg_tol", "1.0",
        "--cg_maxiter", str(MAXITER), "--split_step"]
DTYPES = {"float64": (np.float64, torch.float64, 1e-9), "float32": (np.float32, torch.float32, 1e-4)}


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
def problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N + N_QUERY, D))
    y = np.sin(X @ rng.standard_normal(D)) + 0.1 * rng.standard_normal(N + N_QUERY)
    params = np.concatenate([[0.05], rng.uniform(0.5, 1.5, D), [0.3], [-1.0]])
    return X[:N], y[:N], X[N:], params


class _CountingJax:
    """``jax`` with ``jit`` counting the calls of each jitted function by name."""

    def __init__(self):
        self.calls = collections.Counter()

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fun, **kwargs):
        jitted = jax.jit(fun, **kwargs)

        def counted(*args, **kw):
            self.calls[fun.__name__] += 1
            return jitted(*args, **kw)

        return counted


def _jax_split(problem, np_dtype, monkeypatch):
    X, y, Xq, params = problem
    spec = importlib.util.spec_from_file_location("_common_gp_split_eval", COMMON)
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    counting = _CountingJax()
    monkeypatch.setattr(common, "jax", counting)
    args = common.build_argparser(argparse.ArgumentParser()).parse_args(ARGS)
    stack = common.assemble(args, n_train=N, ndim=D, solver_mode="adaptive")
    to = lambda a: jnp.asarray(a, np_dtype)  # noqa: E731
    mean, info = stack.predict_mean_split(to(params), to(Xq), to(X), to(y))
    return np.asarray(mean), info, counting.calls


def _torch_split(problem, torch_dtype):
    X, y, Xq, params = problem
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=8, num_samples=4, rank_precon=RANK, precon_block=16,
        cg_maxiter=MAXITER, matvec=train_gp.gram_policy("auto", 1), device="cpu",
    )
    to = lambda a: torch.tensor(a, dtype=torch_dtype)  # noqa: E731
    return stack.predict_mean_split(to(params), to(Xq), to(X), to(y))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_predict_mean_split_matches_the_jax_driver(problem, monkeypatch, dtype):
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"):
        mean_j, info_j, calls = _jax_split(problem, np_dtype, monkeypatch)
    mean_t, info_t = _torch_split(problem, torch_dtype)
    assert mean_t.dtype == torch_dtype and not mean_t.requires_grad
    residuals, chunks = info_t["residual_rms"], info_t["chunk_steps"]
    # Same restarts: one true residual per restart, one chunk per residual above atol.
    assert calls["_factor"] == 1 and calls["_predict_cross"] == 1
    assert calls["_predict_residual"] == len(residuals) == 6
    assert calls["_predict_chunk"] == len(chunks) == 5
    assert residuals[-1] <= ATOL < min(residuals[:-1])
    # No restart decided by rounding: every residual at least 5 % from atol.
    assert min(abs(r / ATOL - 1.0) for r in residuals) > 0.05
    assert chunks == [MAXITER] * 4 + [2]
    assert float(info_t["solve"]["num_steps"]) == float(info_j["solve"]["num_steps"]) == chunks[-1]
    rel = np.max(np.abs(mean_t.numpy() - mean_j)) / np.max(np.abs(mean_j))
    assert rel <= tol


def test_restarts_bound_the_chunks(problem):
    X, y, Xq, params = problem
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=8, num_samples=4, rank_precon=RANK, precon_block=16,
        cg_maxiter=MAXITER, matvec=train_gp.gram_policy("auto", 1), device="cpu",
    )
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    _mean, info = stack.predict_mean_split(t(params), t(Xq), t(X), t(y), restarts=2)
    assert len(info["residual_rms"]) == len(info["chunk_steps"]) == 2
    _mean, info = stack.predict_mean_split(t(params), t(Xq), t(X), t(y), atol=1e3)
    assert len(info["residual_rms"]) == 1 and info["chunk_steps"] == [] and info["solve"] == {}


def _run_args(out, *flags):
    argv = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "16",
            "--num_partitions", "2", "--num_matvecs", "6", "--num_samples", "2", "--num_epochs", "0",
            "--num_data", "800", "--matvec", "auto", "--slq", "blocked", "--precon_block", "16",
            "--cg_tol", "1.0", "--cg_maxiter", "4", "--device", "cpu", "--out", str(out), *flags]
    return train_gp.build_argparser(argparse.ArgumentParser()).parse_args(argv)


@pytest.mark.parametrize("split_step", [True, False])
def test_run_evaluates_through_the_split_solve_under_split_step(tmp_path, monkeypatch, split_step):
    called = []
    assemble = train_gp.assemble

    def spying(**kwargs):
        stack = assemble(**kwargs)
        for name in ("predict_mean", "predict_mean_split"):
            fun = getattr(stack, name)
            setattr(stack, name, lambda *a, _f=fun, _n=name, **k: called.append(_n) or _f(*a, **k))
        return stack

    monkeypatch.setattr(train_gp, "assemble", spying)
    flags = ("--split_step",) if split_step else ()
    result = train_gp.run(_run_args(tmp_path, *flags), solver_mode="adaptive")
    assert called == (["predict_mean_split"] if split_step else ["predict_mean"])
    assert ("chunk_steps" in result.predict_info) == split_step
    assert np.isfinite(result.test_rmse) and np.isfinite(result.test_nll)
    if split_step:
        assert len(result.predict_info["chunk_steps"]) >= 1
        assert all(steps <= 4 for steps in result.predict_info["chunk_steps"])
