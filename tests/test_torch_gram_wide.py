"""The port's fused Gram path at input widths above 64 against the JAX package's.

The JAX ``gram_matvec_pallas`` pads any d (its MXU path, d > 8); the
port pads a width above 64 to the next multiple of 64, which its kernels
take in chunks of 64 columns. On the CPU the port's wrappers run the plain
versions of K1, K2 and K3; the JAX side runs ``pallas_gram`` in interpret
mode, as its own tests do. Both get the same numpy inputs.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from lanczos_adjoints_tpu import precond as jprecond  # noqa: E402
from lanczos_adjoints_tpu import solvers as jsolvers  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_gram  # noqa: E402
from lanczos_adjoints_tpu.trace.slq import log_clipped as jlog_clipped  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_gram  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# tests/test_ops/test_pallas_gram.py:23 (values and parameter gradients)
# and 10x it at :163 (data gradients, relative norm).
_TOL = {"rbf": 1e-4, "matern12": 5e-3, "matern32": 1e-4}


@pytest.fixture(autouse=True)
def _interpret_and_pin(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pallas_gram.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    pin_float32()


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9)


@pytest.mark.parametrize("d", [64, 65, 130])
def test_padded_width_pads_beyond_64_to_a_multiple_of_64(d):
    want = {64: 64, 65: 128, 130: 192}[d]
    assert fused_gram.padded_width(d) == want
    x = torch.tensor(np.random.default_rng(d).standard_normal((5, d)), dtype=torch.float32)
    rows = fused_gram.kernel_rows(x, torch.tensor(0.7), "rbf")
    assert rows.shape == (5, want) and bool((rows[:, d:] == 0).all())
    torch.testing.assert_close(rows[:, :d], x * (0.5**0.5 / 0.7))


@pytest.mark.parametrize("d", [64, 65, 130])
@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
def test_wide_fused_gram_values_and_every_vjp_match_jax(kind, d):
    """Values and the v, lengthscale (ARD), outputscale, x and y gradients."""
    # At most 2^15 cells, so that no plain-version op is split across threads
    # (the suite runs in parallel processes that would then contend).
    rng = np.random.default_rng(d)
    n, n_cols, m = 180, 150, 3
    f32 = np.float32
    a = {
        "x": rng.standard_normal((n, d)).astype(f32),
        "y": rng.standard_normal((n_cols, d)).astype(f32),
        "v": rng.standard_normal((n_cols, m)).astype(f32),
        "ell": rng.uniform(0.5, 2.0, d).astype(f32) * np.sqrt(d / 8, dtype=f32),
        "out": np.asarray(1.3, f32),
    }
    u = rng.standard_normal((n, m)).astype(f32)
    fused_jax = pallas_gram.gram_matvec_fused(kind, data_grads=True)

    @jax.jit
    def run_jax(*args):
        value, vjp = jax.vjp(fused_jax, *args)
        return value, vjp(jnp.asarray(u))

    names = ("x", "y", "v", "ell", "out")
    value_j, grads_j = jax.tree_util.tree_map(np.asarray, run_jax(*(a[k] for k in names)))

    args = [torch.tensor(a[k], requires_grad=True) for k in names]
    value_t = fused_gram.gram_matvec_fused(kind, data_grads=True)(*args)
    grads_t = torch.autograd.grad(value_t, args, torch.tensor(u))

    tol = _TOL[kind]
    assert _max_rel(value_t.detach(), value_j) <= tol
    for name, g_t, g_j in zip(names, grads_t, grads_j):
        assert g_t.shape == g_j.shape, name
        if name in ("x", "y"):
            assert _norm_rel(g_t, g_j) < 10 * tol, name
        else:
            assert _max_rel(g_t, g_j) <= tol, name


N, DEPTH, PROBES, RANK, BLOCK = 160, 8, 4, 32, 16
CG = {"atol": 1e-4, "rtol": 0.0, "maxiter": 300, "miniter": 10}


@pytest.mark.parametrize("d", [65, 130])
def test_assembled_gp_loss_and_gradient_match_jax_beyond_64_dims(d):
    """``train.gp.assemble`` (the fused policy) at d > 64 against the JAX
    package's training loss with ``gram_matvec_pallas``."""
    rng = np.random.default_rng(d)
    X = rng.standard_normal((N, d)).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    params = np.concatenate(
        [[0.05], np.log(np.expm1(rng.uniform(0.5, 1.5, d) * np.sqrt(d / 8))), [0.3], [-1.0]]
    ).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(PROBES, N)).astype(np.float32)

    logdet = jgp.krylov_logdet_slq(
        DEPTH, sample=lambda _key: jnp.asarray(probes), num_batches=1,
        checkpoint=True, matfun=jlog_clipped(), blocked=True,
    )
    likelihood, p_lik = jgp.likelihood_pdf_p(
        jgp.gram_matvec_pallas(), jgp.logpdf_krylov_p(jsolvers.pcg_adaptive(**CG), logdet),
        jprecond.preconditioner(jprecond.cholesky_partial_pivot_blocked(rank=RANK, block=BLOCK)),
        constrain=jgp.constraint_greater_than(1e-4),
    )
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
    loss = jgp.target_logml(jgp.model_gp(mean, kernel), likelihood)
    _flat, unflatten = ravel_pytree((p_mean, p_kernel, p_lik))

    def mll(p):
        p1, p2, p3 = unflatten(p)
        val, _info = loss(jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(0),
                          params_mean=p1, params_kernel=p2, params_likelihood=p3)
        return -val / N

    value_j, grad_j = jax.jit(jax.value_and_grad(mll))(jnp.asarray(params))
    value_j, grad_j = float(value_j), np.asarray(grad_j)

    stack = train_gp.assemble(
        n_train=N, ndim=d, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=RANK,
        precon_block=BLOCK, cg_tol=CG["atol"], cg_maxiter=CG["maxiter"],
        cg_miniter=CG["miniter"], sample=lambda _key: torch.tensor(probes), device="cpu",
    )
    p = torch.tensor(params, requires_grad=True)
    value_t, _info = stack.mll_lanczos(p, None, torch.tensor(X), torch.tensor(y))
    (grad_t,) = torch.autograd.grad(value_t, [p])

    assert abs(value_t.item() - value_j) <= 1e-4 * abs(value_j)
    assert grad_t.shape == grad_j.shape
    assert _max_rel(grad_t, grad_j) <= 1e-4
