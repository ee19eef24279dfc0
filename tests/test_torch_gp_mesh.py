"""The port's GP training step over a mesh against the JAX package's.

The JAX side assembles the driver's ``--mesh`` path
(``experiments/applications/gaussian_process/train/_common.py:149-229``)
on the 8-device virtual CPU mesh: its dense Gram policy wrapped in
``parallel.sharded_gram_policy`` over the ``rows`` axis and, per probe,
the probes sharded over ``probes``. The port runs ``train.gp.assemble``
with the same ``mesh`` and ``slq`` and its fused policy, whose wrappers
take the kernels' plain versions on the CPU. The same numpy data,
parameters and probes go to both (the pattern of
``tests/test_torch_gp_slice.py``), with its tolerances.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from lanczos_adjoints_tpu import parallel as jparallel  # noqa: E402
from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.trace.slq import log_clipped as jlog_clipped  # noqa: E402
from lanczos_adjoints_tpu_torch import parallel  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp  # noqa: E402
from lanczos_adjoints_tpu_torch.precond import low_rank  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.trace import hutchinson, slq  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

N, D, DEPTH, RANK = 512, 4, 10, 32
CG = {"atol": 1e-4, "rtol": 0.0, "maxiter": 400, "miniter": 10}
# (mesh, slq, probes, precon_block): the two configurations of the
# driver's multi-device dry run.
CONFIGS = [("8", "blocked", 4, 16), ("4x2", "vmap", 4, 1)]


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _problem(num_probes, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * X[:, 1]).astype(np.float32)
    params = np.concatenate([[0.05], rng.uniform(0.5, 1.5, D), [0.3], [-1.0]]).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(num_probes, N)).astype(np.float32)
    return X, y, params, probes


def _jax_mesh(spec):
    rows, probes = train_gp.parse_mesh(spec)
    return JMesh(np.asarray(jax.devices()[: rows * probes]).reshape(rows, probes), ("rows", "probes"))


def _jax_value_and_grad(X, y, params, probes, mesh_spec, slq_mode, block):
    mesh = _jax_mesh(mesh_spec)
    probe_sharding = None
    if mesh.shape["probes"] > 1:
        probe_sharding = JNamedSharding(mesh, PartitionSpec("probes"))
    logdet = jgp.krylov_logdet_slq(
        DEPTH, sample=lambda _key: jnp.asarray(probes), num_batches=1, checkpoint=True,
        matfun=jlog_clipped(), blocked=slq_mode == "blocked", probe_sharding=probe_sharding,
    )
    cholesky = (jprecond.cholesky_partial_pivot_blocked(rank=RANK, block=block) if block > 1
                else jprecond.cholesky_partial_pivot(rank=RANK))
    likelihood, p_lik = jgp.likelihood_pdf_p(
        jparallel.sharded_gram_policy(jgp.gram_matvec(), mesh),
        jgp.logpdf_krylov_p(jsolvers.pcg_adaptive(**CG), logdet),
        jprecond.preconditioner(cholesky), constrain=jgp.constraint_greater_than(1e-4),
    )
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    loss = jgp.target_logml(jgp.model_gp(mean, kernel), likelihood)
    _flat, unflatten = ravel_pytree((p_mean, p_kernel, p_lik))

    def mll(p):
        p1, p2, p3 = unflatten(p)
        val, _info = loss(jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(0),
                          params_mean=p1, params_kernel=p2, params_likelihood=p3)
        return -val / N

    value, grad = jax.jit(jax.value_and_grad(mll))(jnp.asarray(params))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize(("mesh", "slq_mode", "num_probes", "block"), CONFIGS)
def test_mesh_step_matches_the_jax_driver_assembly(mesh, slq_mode, num_probes, block):
    X, y, params, probes = _problem(num_probes)
    value_j, grad_j = _jax_value_and_grad(X, y, params, probes, mesh, slq_mode, block)
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=DEPTH, num_samples=num_probes, rank_precon=RANK,
        precon_block=block, cg_tol=CG["atol"], cg_maxiter=CG["maxiter"], cg_miniter=CG["miniter"],
        sample=lambda _key: torch.tensor(probes), slq=slq_mode, mesh=mesh, device="cpu",
    )
    assert stack.mesh.shape == dict(zip(("rows", "probes"), train_gp.parse_mesh(mesh)))
    p = torch.tensor(params, requires_grad=True)
    value_t, info = stack.mll_lanczos(p, None, torch.tensor(X), torch.tensor(y))
    (grad_t,) = torch.autograd.grad(value_t, [p])
    assert abs(value_t.item() - value_j) <= 1e-4 * abs(value_j)
    assert np.max(np.abs(grad_t.numpy() - grad_j)) <= 1e-3 * np.max(np.abs(grad_j)), (grad_t, grad_j)
    assert bool(info["precondition"]["success"])


def test_dryrun_multichip_passes_on_eight_partitions():
    reports = train_gp.dryrun_multichip(8, device="cpu")
    assert [(r["mesh"], r["slq"], r["n"]) for r in reports] == [("4x2", "vmap", 2048), ("8", "blocked", 2048)]
    for r in reports:
        assert r["loss_err_of_limit"] <= 1.0 and r["grad_err_of_limit"] <= 1.0
        assert np.all(np.isfinite(r["params_after_step"]))


def test_assemble_refuses_blocked_slq_over_probe_partitions():
    with pytest.raises(ValueError, match="blocked SLQ"):
        train_gp.assemble(n_train=N, ndim=D, slq="blocked", mesh="4x2", device="cpu")
    with pytest.raises(ValueError, match="slq="):
        train_gp.assemble(n_train=N, ndim=D, slq="junk", device="cpu")
    assert train_gp.parse_mesh("4x2") == (4, 2) and train_gp.parse_mesh("8") == (8, 1)


def _quad(v, A):
    return v @ (A @ v)


def test_probe_sharding_gives_the_unsharded_estimate():
    rng = np.random.default_rng(7)
    probes = torch.tensor(rng.choice([-1.0, 1.0], size=(6, 40)))
    A = torch.tensor(rng.standard_normal((40, 40)))
    A = A @ A.T + 40 * torch.eye(40, dtype=A.dtype)
    grid = parallel.make_mesh({"rows": 2, "probes": 3}, device="cpu")
    sharding = parallel.NamedSharding(grid, "probes")
    plain = hutchinson.hutchinson(_quad, lambda _k: probes)(None, A)
    sharded = hutchinson.hutchinson(_quad, lambda _k: probes, probe_sharding=sharding)(None, A)
    assert torch.equal(sharded, plain)
    with pytest.raises(ValueError, match="divide evenly"):
        hutchinson.hutchinson(_quad, lambda _k: probes[:5], probe_sharding=sharding)(None, A)

    def matvec(v, a):
        return a @ v

    for blocked in (False, True):
        estimates = [
            slq.krylov_logdet_slq(8, sample=lambda _k: probes, num_batches=1, checkpoint=False,
                                  blocked=blocked, probe_sharding=s)(matvec, None, A)[0]
            for s in (None, sharding)
        ]
        assert torch.equal(*estimates)


def _lazy_kernel(X, raw_ell=0.2, raw_out=0.4):
    param_j, _ = jgp.kernel_scaled_matern_32(shape_in=(X.shape[1],), shape_out=())
    param_t, _ = gp.kernel_scaled_matern_32(shape_in=(X.shape[1],), shape_out=())
    raw = dict(raw_lengthscale=np.full(X.shape[1], raw_ell, X.dtype), raw_outputscale=np.asarray(raw_out, X.dtype))
    k_j = param_j(**{k: jnp.asarray(v) for k, v in raw.items()})
    k_t = param_t(**{k: torch.tensor(v) for k, v in raw.items()})
    Xj, Xt = jnp.asarray(X), torch.tensor(X)

    def elem_t(i, j):
        return k_t(Xt[i], Xt[j])

    elem_t.params = k_t.params
    return (lambda i, j: k_j(Xj[i], Xj[j])), elem_t


@pytest.mark.parametrize(("n", "rank", "dupes"), [(200, 24, False), (60, 40, True)])
def test_sequential_pivoted_cholesky_matches_jax(n, rank, dupes):
    """Random inputs; with ``dupes`` only 20 distinct points, so the
    factorisation exhausts before ``rank`` and truncates to zeros."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((20 if dupes else n, 3))
    if dupes:
        X = X[rng.integers(0, 20, n)]
    with jax.enable_x64(True):
        elem_j, elem_t = _lazy_kernel(X)
        L_j, info_j = jprecond.cholesky_partial_pivot(rank=rank)(elem_j, n)
        L_j, success_j = np.asarray(L_j), bool(info_j["success"])
    L_t, info_t = low_rank.cholesky_partial_pivot(rank=rank)(elem_t, n)
    assert bool(info_t["success"]) == success_j == (not dupes)
    np.testing.assert_allclose(L_t.numpy(), L_j, atol=1e-10, rtol=0)
    if dupes:  # 20 distinct points: the factor is exact at rank 20
        K = elem_t(torch.arange(n)[:, None], torch.arange(n)[None, :])
        assert float(torch.max(torch.abs(K - L_t @ L_t.T))) < 1e-8


def test_sequential_pivoted_cholesky_refuses_gradients():
    X = np.random.default_rng(9).standard_normal((30, 2)).astype(np.float32)
    _elem_j, elem_t = _lazy_kernel(X)
    elem_t.params = tuple(p.clone().requires_grad_() for p in elem_t.params)
    L, _info = low_rank.cholesky_partial_pivot(rank=5)(elem_t, 30)
    with pytest.raises(RuntimeError, match="must not be differentiated"):
        L.sum().backward()
    with pytest.raises(ValueError, match="Rank exceeds"):
        low_rank.cholesky_partial_pivot(rank=31)(elem_t, 30)
