"""The GP driver on the JAX run's own draws, against the JAX package, on the CPU.

``scripts/export_gp_adj400k_draws.py`` (loaded by path) replays the JAX
``adj400k`` run's key path and writes its split, its probes and its state
after epoch 1 to ``train/adj400k_draws.npz``. Held here: the committed
draws against JAX's own (the permutation, the first probe block, the
keys), the packing at small N, the shuffled split with a permutation, and
``--slq_host_batches`` (blocked SLQ as B estimates of ``num_samples / B``
probes) against ``_common.py``'s ``mll_split_value_and_grad`` on the same
probes, drawn by ``jax.random`` from the same keys. Float32 throughout,
at the tolerances of ``tests/test_torch_gp_driver.py``.
"""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.trace import sampler_rademacher  # noqa: E402
from lanczos_adjoints_tpu.utils import data as jdata  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import data  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COMMON = REPO / "experiments/applications/gaussian_process/train/_common.py"
EXPORT = REPO / "scripts/export_gp_adj400k_draws.py"
N_TRAIN, DEPTH, PROBES, BATCHES = 800, 8, 15, 5


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


@pytest.fixture(scope="module")
def draws():
    return train_gp.JaxDraws(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _split_key():
    """``_common.py:470``: the key of the train/test permutation."""
    return jax.random.split(jax.random.PRNGKey(1))[1]


def test_the_committed_draws_are_the_jax_runs(draws):
    arrays = draws.arrays
    assert train_gp.DRAWS.stat().st_size < 4_200_000
    np.testing.assert_array_equal(draws.permutation, np.asarray(jax.random.permutation(_split_key(), 500_000)))
    assert (draws.num_epochs, draws.host_batches, draws.num_per_batch) == (3, 5, 3)
    # The first host batch of epoch 0 at full width, drawn again from its key.
    want = sampler_rademacher(jnp.ones((400_000,)), num=3)(jnp.asarray(arrays["epoch_keys"][0, 0]))
    np.testing.assert_array_equal(draws.epoch_key(0, 400_000).next().numpy(), np.asarray(want))
    np.testing.assert_array_equal(arrays["ckpt1_key"], [2783477504, 2669311029])
    assert int(arrays["ckpt1_count"]) == 2 and arrays["ckpt1_params"].shape == (11,)
    with pytest.raises(ValueError, match="epochs 0-2"):
        draws.epoch_key(3, 400_000)


@pytest.mark.parametrize("n", [1000, 1003])
def test_unpacked_probes_equal_jax_sampler_rademacher(n, tmp_path):
    export = _load(EXPORT, "_export_gp_draws")
    keys = jax.random.split(jax.random.PRNGKey(4), BATCHES)
    sample = sampler_rademacher(jnp.ones((n,)), num=3)
    packed = np.asarray([export.pack_signs(sample(k)) for k in keys])
    np.savez(tmp_path / "draws.npz", permutation=np.arange(n), probes=packed[None])
    key = train_gp.JaxDraws(tmp_path / "draws.npz", device="cpu").epoch_key(0, n)
    for k in keys:
        np.testing.assert_array_equal(train_gp.sample_given(key).numpy(), np.asarray(sample(k)))
    with pytest.raises(ValueError, match="every given probe block"):
        train_gp.sample_given(key)
    with pytest.raises(ValueError, match="fewer than"):
        train_gp.unpack_signs(packed[0], 8 * packed.shape[-1] + 1, device="cpu")


def test_split_with_a_permutation_equals_the_jax_split():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((500, 3)).astype(np.float32), rng.standard_normal(500).astype(np.float32)
    perm = np.asarray(jax.random.permutation(_split_key(), 500))
    got = data.split_train_test_shuffle(perm, x, y, train_fraction=0.8)
    want = jdata.split_train_test_shuffle(_split_key(), jnp.asarray(x), jnp.asarray(y), train_fraction=0.8)
    for part_got, part_want in zip(got, want):
        for a, b in zip(part_got, part_want):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="permutation"):
        data.split_train_test_shuffle(perm[:-1], x, y)
    # A seed permutes with numpy, as before.
    seeded = data.split_train_test_shuffle(3, x, y, train_fraction=0.8)
    np.testing.assert_array_equal(seeded[0][0], x[np.random.default_rng(3).permutation(500)][:400])


@pytest.fixture(scope="module")
def split_step_problem():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N_TRAIN, 8)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(8)) + 0.1 * rng.standard_normal(N_TRAIN)).astype(np.float32)
    params = np.concatenate([[0.05], rng.uniform(0.5, 1.5, 8), [0.3], [-1.0]]).astype(np.float32)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, BATCHES)
    sample = sampler_rademacher(jnp.ones((N_TRAIN,)), num=PROBES // BATCHES)
    blocks = [np.asarray(sample(k)) for k in keys]
    return x, y, params, key, blocks


def _torch_step(x, y, params, blocks, host_batches):
    stack = train_gp.assemble(
        n_train=N_TRAIN, ndim=8, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=48, precon_block=16,
        matvec=train_gp.gram_policy("auto", 1), device="cpu", sample=train_gp.sample_given,
        slq_host_batches=host_batches,
    )
    p = torch.tensor(params, requires_grad=True)
    key = train_gp.GivenProbes(torch.tensor(b) for b in blocks)
    value, info = stack.mll_lanczos(p, key, torch.tensor(x), torch.tensor(y))
    value.backward()
    assert len(key) == 0
    return value.item(), p.grad.numpy(), float(info["logpdf"]["logdet"]["std_rel"])


def test_slq_host_batches_match_the_jax_split_step(split_step_problem):
    x, y, params, key, blocks = split_step_problem
    common = _load(COMMON, "_common_gp_draws")
    argv = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "48",
            "--num_partitions", "1", "--num_matvecs", str(DEPTH), "--num_samples", str(PROBES),
            "--num_epochs", "0", "--matvec", "auto", "--slq", "blocked", "--precon_block", "16",
            "--cg_tol", "1.0", "--cg_maxiter", "25", "--split_step", "--slq_host_batches", str(BATCHES)]
    args = common.build_argparser(argparse.ArgumentParser()).parse_args(argv)
    stack_j = common.assemble(args, n_train=N_TRAIN, ndim=8, solver_mode="adaptive")
    (loss_j, aux_j), grad_j = stack_j.mll_split_value_and_grad(
        jnp.asarray(params), key, jnp.asarray(x), jnp.asarray(y))

    loss_t, grad_t, std_rel_t = _torch_step(x, y, params, blocks, BATCHES)
    assert abs(loss_t - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert _rel(grad_t, np.asarray(grad_j)) <= 1e-3
    std_rel_j = float(aux_j["logpdf"]["logdet"]["std_rel"])
    assert std_rel_j > 0 and abs(std_rel_t / std_rel_j - 1) <= 1e-3


def test_five_host_batches_equal_one_over_the_same_probes(split_step_problem):
    x, y, params, _key, blocks = split_step_problem
    loss_5, grad_5, std_rel_5 = _torch_step(x, y, params, blocks, BATCHES)
    loss_1, grad_1, std_rel_1 = _torch_step(x, y, params, [np.concatenate(blocks)], 1)
    assert abs(loss_5 - loss_1) <= 1e-6 * abs(loss_1)
    assert _rel(grad_5, grad_1) <= 1e-5
    assert std_rel_1 == 0.0 < std_rel_5
    with pytest.raises(ValueError, match="must divide"):
        train_gp.assemble(n_train=N_TRAIN, ndim=8, num_samples=PROBES, slq_host_batches=4, device="cpu")


def test_run_trains_on_given_draws(tmp_path):
    # A draws file at the driver's small shapes: 1,000 points, 2 epochs of 2 x 1 probes.
    rng = np.random.default_rng(2)
    n, n_train = 1000, 800
    arrays = {
        "permutation": rng.permutation(n).astype(np.int32),
        "probes": np.packbits(rng.random((2, 2, 1, n_train)) > 0.5, axis=-1),
        "eval_probes": np.packbits(rng.random((2, n - n_train)) > 0.5, axis=-1),
    }
    np.savez(tmp_path / "draws.npz", **arrays)
    argv = ["--name", "t", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "16",
            "--num_partitions", "2", "--num_matvecs", "6", "--num_samples", "2", "--num_epochs", "2",
            "--num_data", str(n), "--slq", "blocked", "--precon_block", "16", "--cg_tol", "1.0",
            "--cg_maxiter", "25", "--device", "cpu", "--out", str(tmp_path), "--split_step",
            "--slq_host_batches", "2"]
    args = train_gp.build_argparser(argparse.ArgumentParser()).parse_args(argv)
    draws = train_gp.JaxDraws(tmp_path / "draws.npz", device="cpu")
    result = train_gp.run(args, solver_mode="adaptive", params0=train_gp.ADJ400K_INIT, draws=draws)
    # Epoch 0 from ADJ400K_INIT, on the given split and probes.
    (x, y), _test = train_gp.split(args, permutation=arrays["permutation"])
    stack = train_gp.assemble(
        n_train=n_train, ndim=8, num_matvecs=6, num_samples=2, rank_precon=16, precon_block=16,
        cg_maxiter=25, matvec=train_gp.gram_policy("auto", 2), device="cpu",
        sample=train_gp.sample_given, slq_host_batches=2,
    )
    value, _ = stack.mll_lanczos(torch.tensor(train_gp.ADJ400K_INIT, dtype=torch.float32),
                                 draws.epoch_key(0, n_train), x, y)
    assert result.series["loss_curve"][0] == value.item()
    assert all(s > 0 for s in result.series["slq_std_rels"]) and np.isfinite(result.test_nll)
    args.num_epochs = 3
    with pytest.raises(ValueError, match="epochs 0-1"):
        train_gp.run(args, solver_mode="adaptive", draws=draws)
    args.slq_host_batches = 1
    with pytest.raises(ValueError, match="host batches"):
        train_gp.run(args, solver_mode="adaptive", draws=draws)


def test_the_kernel_diagonal_is_exact_so_the_pivots_are_jax_s(split_step_problem):
    # k(x_i, x_i) is one value on every row, as in the JAX package (its three dots
    # agree bit for bit at x = y), so the blocked pivoted Cholesky's first sweep
    # takes the first rows, not an order set by rounding; the factor is then JAX's.
    from lanczos_adjoints_tpu import precond as jprecond
    from lanczos_adjoints_tpu.models import gp as jgp
    from lanczos_adjoints_tpu_torch.models import gp
    from lanczos_adjoints_tpu_torch.precond import low_rank

    x, _y, params, _key, _blocks = split_step_problem
    p1, p2, _p3 = gp.unflatten_params(torch.tensor(params), 8)
    kernel = gp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](**p2)
    cov = gp._CovarianceOp(gp.gram_matvec(), kernel, torch.tensor(x))
    idx = torch.arange(N_TRAIN)
    assert torch.unique(cov.elem(idx, idx)).numel() == 1
    L, _ = low_rank.cholesky_partial_pivot_blocked(rank=64, block=16)(cov.elem, N_TRAIN)
    kernel_j = jgp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](
        **{k: jnp.asarray(v.numpy()) for k, v in p2.items()})
    cov_j = jgp._CovarianceOp(jgp.gram_matvec(), kernel_j, jnp.asarray(x))
    L_j, _ = jprecond.cholesky_partial_pivot_blocked(rank=64, block=16)(cov_j.elem, N_TRAIN)
    # Each sweep's columns come from an eigh, so compare L L^T, which the preconditioner uses.
    low_rank_j = np.asarray(L_j) @ np.asarray(L_j).T
    np.testing.assert_allclose((L @ L.T).numpy(), low_rank_j, rtol=0, atol=1e-4 * float(np.abs(low_rank_j).max()))
