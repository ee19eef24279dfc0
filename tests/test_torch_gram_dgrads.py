"""The port's Gram data gradients (K3) against the JAX package's.

On the CPU the port's wrapper runs the plain version of the CUDA kernel
K3; the JAX side runs ``pallas_gram._data_grad`` and
``gram_matvec_pallas(data_grads=True)`` in interpret mode, as its own
tests do. Both get the same numpy inputs.
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
from lanczos_adjoints_tpu_torch.models import gp as tgp  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_gram, gram  # noqa: E402
from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import data, uci  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# From tests/test_ops/test_pallas_gram.py (:23, and 10x it at :163 for the
# data gradients): matern12 is non-smooth at sq = 0, rbf and matern32
# compare tightly.
_TOL = {"rbf": 1e-4, "matern12": 5e-3, "matern32": 1e-4}

# (kind, d, m, symmetric): matern12 runs the rectangular case only, as
# its near-diagonal data gradients carry amplified rounding
# (pallas_gram.py:635-641).
_CASES = [
    (kind, d, m, symmetric)
    for kind in ("rbf", "matern32", "matern12")
    for d in (3, 12)
    for m in (1, 3)
    for symmetric in (False, True)
    if not (kind == "matern12" and symmetric)
]


@pytest.fixture(autouse=True)
def _interpret_and_pin(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pallas_gram.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    pin_float32()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9)


def _inputs(d, m, symmetric, seed=0):
    rng = np.random.default_rng(seed)
    n, n_cols = 70, 70 if symmetric else 53
    f32 = np.float32
    x = rng.standard_normal((n, d)).astype(f32)
    y = x if symmetric else rng.standard_normal((n_cols, d)).astype(f32)
    return {
        "x": x,
        "y": y,
        "v": rng.standard_normal((n_cols,) if m == 1 else (n_cols, m)).astype(f32),
        "u": rng.standard_normal((n,) if m == 1 else (n, m)).astype(f32),
        "ell": rng.uniform(0.5, 2.0, (d,)).astype(f32),
        "out": np.asarray(1.3, f32),
    }


@pytest.mark.parametrize(("kind", "d", "m", "symmetric"), _CASES)
def test_data_grad_matches_jax(kind, d, m, symmetric):
    a = _inputs(d, m, symmetric)
    args = {k: jnp.asarray(v) for k, v in a.items()}
    prec = jax.lax.Precision.HIGHEST
    dx_j = np.asarray(pallas_gram._data_grad(
        kind, prec, args["x"], args["y"], args["v"], args["u"], args["ell"], args["out"]))
    dy_j = np.asarray(pallas_gram._data_grad(
        kind, prec, args["y"], args["x"], args["u"], args["v"], args["ell"], args["out"]))

    t = {k: torch.tensor(v) for k, v in a.items()}
    v2 = t["v"][:, None] if m == 1 else t["v"]
    u2 = t["u"][:, None] if m == 1 else t["u"]
    dx_t = fused_gram.data_grad(kind, t["x"], t["y"], v2, u2, t["ell"], t["out"])
    dy_t = fused_gram.data_grad(kind, t["y"], t["x"], u2, v2, t["ell"], t["out"])
    assert dx_t.shape == dx_j.shape and dy_t.shape == dy_j.shape
    assert _rel(dx_t, dx_j) < 10 * _TOL[kind]
    assert _rel(dy_t, dy_j) < 10 * _TOL[kind]


@pytest.mark.parametrize("m", [9, 225])
@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
def test_data_grad_matches_jax_at_the_main_path_widths(kind, m):
    """K3's plain version at m = 9 (one 8-wide k-step and a ragged one,
    padded to 12 on the card) and m = 225 (the blocked SLQ adjoint's
    15 x 15 probes), d = 8 with ARD lengthscales and x = y, as in the GP
    step, against the JAX kernel: dx and dy, at the file's data-gradient
    tolerance (matern12's diagonal cancels, pallas_gram.py:635-641)."""
    a = _inputs(8, m, True, seed=3)
    args = {k: jnp.asarray(v) for k, v in a.items()}
    prec = jax.lax.Precision.HIGHEST
    dx_j = np.asarray(pallas_gram._data_grad(
        kind, prec, args["x"], args["y"], args["v"], args["u"], args["ell"], args["out"]))
    dy_j = np.asarray(pallas_gram._data_grad(
        kind, prec, args["y"], args["x"], args["u"], args["v"], args["ell"], args["out"]))

    t = {k: torch.tensor(v) for k, v in a.items()}
    dx_t = fused_gram.data_grad(kind, t["x"], t["y"], t["v"], t["u"], t["ell"], t["out"])
    dy_t = fused_gram.data_grad(kind, t["y"], t["x"], t["u"], t["v"], t["ell"], t["out"])
    assert dx_t.shape == dx_j.shape == (70, 8)
    assert _rel(dx_t, dx_j) < 10 * _TOL[kind]
    assert _rel(dy_t, dy_j) < 10 * _TOL[kind]


@pytest.mark.parametrize(("kind", "d", "m", "symmetric"), _CASES)
def test_fused_matvec_data_gradients_match_autograd_of_the_plain_matvec(kind, d, m, symmetric):
    """The Function's backward (K3 twice) against autograd through the plain K1."""
    a = _inputs(d, m, symmetric, seed=1)
    t = {k: torch.tensor(v) for k, v in a.items()}
    grads = []
    for fn in (fused_gram.gram_matvec_fused(kind, data_grads=True),
               functools.partial(fused_gram.gram_matvec_reference, kind)):
        x = t["x"].clone().requires_grad_()
        y = t["y"].clone().requires_grad_()
        out = fn(x, y, t["v"], t["ell"], t["out"])
        grads.append(torch.autograd.grad(out, [x, y], t["u"]))
    for got, want in zip(*grads):
        assert _rel(got, want) < 10 * _TOL[kind]


def test_moments_are_row_sums_and_scaled_column_moments():
    rng = np.random.default_rng(2)
    xs = torch.tensor(rng.standard_normal((9, 8)), dtype=torch.float32)
    ys = torch.tensor(rng.standard_normal((11, 8)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((11, 2)), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal((9, 2)), dtype=torch.float32)
    moments = fused_gram.gram_dgrads_rows("matern32", xs, ys, v, u)
    sq = torch.cdist(xs.double(), ys.double()) ** 2
    _, dg = fused_gram.kernel_value_dsq("matern32", sq)
    w = (u.double() @ v.double().T) * dg
    assert moments.shape == (9, 9)
    torch.testing.assert_close(moments[:, 0].double(), w.sum(1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(moments[:, 1:].double(), w @ ys.double(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        fused_gram.gram_dgrads_rows("matern32", xs, ys, v, u[:5])


@pytest.mark.parametrize("entry", ["function", "policy"])
def test_default_gives_no_input_gradient(entry):
    """``data_grads=False`` (the default): no x/y gradient, as JAX's symbolic zeros."""
    a = _inputs(3, 2, False)
    t = {k: torch.tensor(v) for k, v in a.items()}
    x = t["x"].clone().requires_grad_()
    y = t["y"].clone().requires_grad_()
    raw = t["ell"].clone().requires_grad_()
    if entry == "function":
        out = fused_gram.gram_matvec_fused("rbf")(x, y, t["v"], raw, t["out"])
    else:
        k = tgp.kernel_scaled_rbf(shape_in=(3,), shape_out=())[0](
            raw_lengthscale=raw, raw_outputscale=t["out"])
        out = gram.gram_matvec_fused()(k)(x, y, t["v"], raw, t["out"])
    dx, dy, dell = torch.autograd.grad(out, [x, y, raw], t["u"], allow_unused=True)
    for g in (dx, dy):
        assert g is None or not bool(g.any())
    assert dell is not None and bool(torch.isfinite(dell).all())


N, D, DEPTH, PROBES, RANK, BLOCK = 512, 8, 10, 4, 64, 16
CG = {"atol": 1e-4, "rtol": 0.0, "maxiter": 400, "miniter": 10}


def _problem(seed=0):
    X, y = uci.uci_synthetic_gp500k()
    (X, y), _ = data.split_train_test_shuffle(seed, X[:640], y[:640], train_fraction=0.8)
    rng = np.random.default_rng(seed)
    params = np.concatenate([[0.05], rng.uniform(0.5, 1.5, D), [0.3], [-1.0]]).astype(np.float32)
    probes = rng.choice([-1.0, 1.0], size=(PROBES, N)).astype(np.float32)
    return X, y, params, probes


def _jax_value_and_grads(X, y, params, probes):
    solve_p = jsolvers.pcg_adaptive(**CG)
    logdet = jgp.krylov_logdet_slq(
        DEPTH, sample=lambda _key: jnp.asarray(probes), num_batches=1,
        checkpoint=True, matfun=jlog_clipped(), blocked=True,
    )
    precondition = jprecond.preconditioner(
        jprecond.cholesky_partial_pivot_blocked(rank=RANK, block=BLOCK)
    )
    likelihood, p_lik = jgp.likelihood_pdf_p(
        jgp.gram_matvec_pallas(data_grads=True), jgp.logpdf_krylov_p(solve_p, logdet),
        precondition, constrain=jgp.constraint_greater_than(1e-4),
    )
    mean, p_mean = jgp.mean_constant(shape_out=())
    kernel, p_kernel = jgp.kernel_scaled_matern_32(shape_in=(D,), shape_out=())
    loss = jgp.target_logml(jgp.model_gp(mean, kernel), likelihood)
    _flat, unflatten = ravel_pytree((p_mean, p_kernel, p_lik))

    def mll(p, xs):
        p1, p2, p3 = unflatten(p)
        val, _info = loss(xs, jnp.asarray(y), jax.random.PRNGKey(0),
                          params_mean=p1, params_kernel=p2, params_likelihood=p3)
        return -val / N

    value, grads = jax.jit(jax.value_and_grad(mll, argnums=(0, 1)))(
        jnp.asarray(params), jnp.asarray(X))
    return float(value), [np.asarray(g) for g in grads]


def test_mll_gradient_in_params_and_inputs_matches_jax(monkeypatch):
    X, y, params, probes = _problem()
    value_j, grads_j = _jax_value_and_grads(X, y, params, probes)

    calls = {"K2": 0, "K3": 0}
    for name, key in (("gram_grads_rows", "K2"), ("gram_dgrads_rows", "K3")):
        real = getattr(fused_gram, name)
        monkeypatch.setattr(fused_gram, name, lambda *a, _r=real, _k=key: (
            calls.__setitem__(_k, calls[_k] + 1) or _r(*a)))
    stack = train_gp.assemble(
        n_train=N, ndim=D, num_matvecs=DEPTH, num_samples=PROBES, rank_precon=RANK,
        precon_block=BLOCK, cg_tol=CG["atol"], cg_maxiter=CG["maxiter"],
        cg_miniter=CG["miniter"], sample=lambda _key: torch.tensor(probes),
        matvec=gram.gram_matvec_fused(data_grads=True), device="cpu",
    )
    p = torch.tensor(params, requires_grad=True)
    xs = torch.tensor(X, requires_grad=True)
    value_t, _info = stack.mll_lanczos(p, None, xs, torch.tensor(y))
    grads_t = torch.autograd.grad(value_t, [p, xs])

    assert abs(value_t.item() - value_j) <= 1e-4 * abs(value_j)
    for g_t, g_j in zip(grads_t, grads_j):
        assert g_t.shape == g_j.shape
        scale = np.max(np.abs(g_j))
        assert np.max(np.abs(g_t.numpy() - g_j)) <= 1e-3 * scale
    # Per step: one K2 and two K3 (dx, dy) in the SLQ parameter VJP, and
    # the same in the CG backward pass.
    assert calls == {"K2": 2, "K3": 4}
