"""The PyTorch port's fused Gram matvec against the JAX package's Pallas kernel.

On the CPU the port's wrappers run the plain versions of the CUDA
kernels K1 (matvec) and K2 (parameter gradients); the JAX side runs
``pallas_gram`` in interpret mode, as its own tests do. Both get the same
numpy inputs.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.ops import pallas_gram  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp as tgp  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_gram, gram  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# From tests/test_ops/test_pallas_gram.py: matern12 is non-smooth at
# sq = 0 and the JAX kernel's expanded-form distance (d > 8) carries
# ~1e-6 cancellation noise that sqrt amplifies; rbf and matern32 compare
# tightly.
_TOL = {"rbf": 1e-4, "matern12": 5e-3, "matern32": 1e-4}


@pytest.fixture(autouse=True)
def _interpret_and_pin(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pallas_gram.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    pin_float32()


def _jax_done(tree):
    """JAX results as numpy arrays, so no JAX work is in flight while the
    PyTorch side runs (the two have been seen to interfere in one process
    when they overlap, on the first PyTorch call)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, (got, want)


def _inputs(d, m, ard, seed=0):
    rng = np.random.default_rng(seed)
    n, n_cols = 70, 53
    f32 = np.float32
    return {
        "x": rng.standard_normal((n, d)).astype(f32),
        "y": rng.standard_normal((n_cols, d)).astype(f32),
        "v": rng.standard_normal((n_cols,) if m == 1 else (n_cols, m)).astype(f32),
        "u": rng.standard_normal((n,) if m == 1 else (n, m)).astype(f32),
        "ell": rng.uniform(0.5, 2.0, (d,) if ard else ()).astype(f32),
        "out": np.asarray(1.3, f32),
    }


@pytest.mark.parametrize("ard", [False, True], ids=["scalar", "ard"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("d", [1, 8, 12])
@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
def test_fused_gram_value_and_vjp_match_jax(kind, d, m, ard):
    a = _inputs(d, m, ard)
    fused_jax = pallas_gram.gram_matvec_fused(kind)

    @jax.jit
    def run_jax(v, ell, out_s):
        value, vjp = jax.vjp(lambda *p: fused_jax(a["x"], a["y"], *p), v, ell, out_s)
        return value, vjp(jnp.asarray(a["u"]))

    value_j, grads_j = _jax_done(run_jax(a["v"], a["ell"], a["out"]))

    args = [torch.tensor(a[k], requires_grad=True) for k in ("v", "ell", "out")]
    value_t = fused_gram.gram_matvec_fused(kind)(
        torch.tensor(a["x"]), torch.tensor(a["y"]), *args
    )
    grads_t = torch.autograd.grad(value_t, args, torch.tensor(a["u"]))

    tol = _TOL[kind]
    _assert_close(value_t.detach(), value_j, tol)
    for g_t, g_j in zip(grads_t, grads_j):
        assert g_t.shape == g_j.shape
        _assert_close(g_t, g_j, tol)


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
def test_param_grads_match_jax_wide(kind):
    """K2 alone at a wide m (the shape of the SLQ adjoint's deferred pass)."""
    a = _inputs(8, 24, True, seed=1)
    d_ell_j, d_out_j = _jax_done(pallas_gram._param_grads(
        kind, jax.lax.Precision.HIGHEST, a["x"], a["y"], a["v"], a["u"], a["ell"], a["out"]
    ))
    d_ell_t, d_out_t = fused_gram.param_grads(
        kind, *(torch.tensor(a[k]) for k in ("x", "y", "v", "u", "ell", "out"))
    )
    _assert_close(d_ell_t, d_ell_j, _TOL[kind])
    _assert_close(d_out_t, d_out_j, _TOL[kind])


def test_backward_skips_dv_when_v_needs_no_gradient(monkeypatch):
    """The wide parameter VJP must not run K1 for dv."""
    calls = []
    real = fused_gram.gram_matvec_rows
    monkeypatch.setattr(
        fused_gram, "gram_matvec_rows", lambda *a: calls.append(1) or real(*a)
    )
    a = _inputs(8, 4, False)
    ell = torch.tensor(a["ell"], requires_grad=True)
    out = fused_gram.gram_matvec_fused("matern32")(
        torch.tensor(a["x"]), torch.tensor(a["y"]), torch.tensor(a["v"]), ell,
        torch.tensor(a["out"]),
    )
    assert len(calls) == 1
    torch.autograd.grad(out, [ell], torch.tensor(a["u"]))
    assert len(calls) == 1  # K2 only


def test_values_unused_skips_forward_and_keeps_param_gradients():
    a = _inputs(8, 4, True)
    fused = fused_gram.gram_matvec_fused("rbf")
    grads = []
    for skip in (False, True):
        ell = torch.tensor(a["ell"], requires_grad=True)
        with fused_gram.values_unused() if skip else torch.enable_grad():
            out = fused(torch.tensor(a["x"]), torch.tensor(a["y"]), torch.tensor(a["v"]),
                        ell, torch.tensor(a["out"]))
        assert bool(torch.isnan(out).all()) == skip
        grads.append(torch.autograd.grad(out, [ell], torch.tensor(a["u"]))[0])
    torch.testing.assert_close(grads[0], grads[1])


def test_wrappers_reject_what_the_kernels_do_not_take():
    xs = torch.zeros((5, 8))
    v = torch.zeros((5, 2))
    with pytest.raises(TypeError, match="float32"):
        fused_gram.gram_matvec_rows("rbf", xs.double(), xs.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_gram.gram_matvec_rows("rbf", xs, xs, torch.zeros((2, 5)).T)
    with pytest.raises(ValueError, match="device"):
        meta = torch.zeros((5, 8), device="meta")
        fused_gram.gram_matvec_rows("rbf", meta, meta, torch.zeros((5, 2), device="meta"))
    with pytest.raises(ValueError, match="shape"):
        fused_gram.gram_matvec_rows("rbf", xs, torch.zeros((4, 8)), v)
    # A width above 64 pads to the next multiple of 64; an unpadded one is refused.
    rows = fused_gram.kernel_rows(torch.ones((3, 65)), torch.tensor(1.0), "rbf")
    assert rows.shape == (3, 128) and bool((rows[:, 65:] == 0).all())
    with pytest.raises(ValueError, match="shape"):
        fused_gram.gram_matvec_rows("rbf", torch.zeros((5, 65)), torch.zeros((5, 65)), v)
    with pytest.raises(ValueError, match="not supported"):
        fused_gram.gram_matvec_fused("cauchy")


def test_padding_to_kernel_width_keeps_distances():
    x = torch.tensor(np.random.default_rng(2).standard_normal((6, 3)), dtype=torch.float32)
    rows = fused_gram.kernel_rows(x, torch.tensor(0.7), "matern32")
    assert rows.shape == (6, 8) and bool((rows[:, 3:] == 0).all())
    torch.testing.assert_close(rows[:, :3], x * (3.0**0.5 / 0.7))


def test_fused_policy_matches_dense_policy_with_noise():
    """Index-based lazy kernel with a noise term: fused vs dense policy."""
    rng = np.random.default_rng(3)
    inputs = torch.tensor(rng.standard_normal((40, 8)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((40, 3)), dtype=torch.float32)
    kernel_fn, _ = tgp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())
    raw_ell = torch.tensor(rng.standard_normal(8), dtype=torch.float32)
    raw_out = torch.tensor(0.2)
    kernel = kernel_fn(raw_lengthscale=raw_ell, raw_outputscale=raw_out)
    outs = []
    for policy in (gram.gram_matvec(), gram.gram_matvec_fused()):
        cov = tgp._CovarianceOp(policy, kernel, inputs, noise=0.3)
        outs.append(cov.matvec(v, raw_ell, raw_out))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def test_fused_policy_refuses_untagged_kernel():
    with pytest.raises(ValueError, match="not tagged"):
        gram.gram_matvec_fused()(lambda x, y: torch.sum(x * y, -1))


@pytest.mark.parametrize(
    "factory", ["kernel_scaled_rbf", "kernel_scaled_matern_12", "kernel_scaled_matern_32"]
)
def test_kernel_families_match_jax_gram_matrix(factory):
    """The elementwise kernels (the preconditioner's and the oracle's path)."""
    from lanczos_adjoints_tpu.models import gp as jgp

    rng = np.random.default_rng(4)
    x = rng.standard_normal((12, 3)).astype(np.float32)
    y = rng.standard_normal((9, 3)).astype(np.float32)
    raw_ell = rng.standard_normal(3).astype(np.float32)
    raw_out = np.float32(0.4)
    cot = rng.standard_normal((12, 9)).astype(np.float32)

    def jax_gram(ell, out):
        k = getattr(jgp, factory)(shape_in=(3,), shape_out=())[0](
            raw_lengthscale=ell, raw_outputscale=out
        )
        return jnp.sum(jgp.gram_matrix(k)(x, y) * cot), jgp.gram_matrix(k)(x, y)

    (_, gram_j), grads_j = _jax_done(jax.value_and_grad(jax_gram, argnums=(0, 1), has_aux=True)(
        jnp.asarray(raw_ell), jnp.asarray(raw_out)
    ))
    args = [torch.tensor(raw_ell, requires_grad=True), torch.tensor(raw_out, requires_grad=True)]
    k = getattr(tgp, factory)(shape_in=(3,), shape_out=())[0](
        raw_lengthscale=args[0], raw_outputscale=args[1]
    )
    gram_t = gram.gram_matrix(k)(torch.tensor(x), torch.tensor(y))
    grads_t = torch.autograd.grad(torch.sum(gram_t * torch.tensor(cot)), args)
    _assert_close(gram_t.detach(), gram_j, 1e-5)
    for g_t, g_j in zip(grads_t, grads_j):
        _assert_close(g_t, g_j, 1e-4)


@pytest.mark.parametrize("m", [1, 5])
def test_fused_policy_with_noise_matches_jax_pallas_policy(m):
    """The index-based path of both policies, ``K @ v + noise * v``, and its VJP."""
    from lanczos_adjoints_tpu.models import gp as jgp
    from lanczos_adjoints_tpu.ops import gram as jgram

    rng = np.random.default_rng(5)
    inputs = rng.standard_normal((40, 8)).astype(np.float32)
    v = rng.standard_normal((40,) if m == 1 else (40, m)).astype(np.float32)
    cot = rng.standard_normal(v.shape).astype(np.float32)
    raw_ell = rng.standard_normal(8).astype(np.float32)
    raw_out, noise = np.float32(0.2), np.float32(0.3)

    def run_jax(ell, out):
        k = jgp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](
            raw_lengthscale=ell, raw_outputscale=out
        )
        cov = jgp._CovarianceOp(jgram.gram_matvec_pallas(), k, jnp.asarray(inputs), noise=noise)
        value = cov.matvec(jnp.asarray(v))
        return jnp.sum(value * cot), value

    (_, value_j), grads_j = _jax_done(jax.jit(jax.value_and_grad(run_jax, argnums=(0, 1), has_aux=True))(
        jnp.asarray(raw_ell), jnp.asarray(raw_out)
    ))
    args = [torch.tensor(raw_ell, requires_grad=True), torch.tensor(raw_out, requires_grad=True)]
    k = tgp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](
        raw_lengthscale=args[0], raw_outputscale=args[1]
    )
    cov = tgp._CovarianceOp(gram.gram_matvec_fused(), k, torch.tensor(inputs), noise=float(noise))
    value_t = cov.matvec(torch.tensor(v), *args)
    grads_t = torch.autograd.grad(torch.sum(value_t * torch.tensor(cot)), args)
    _assert_close(value_t.detach(), value_j, _TOL["matern32"])
    for g_t, g_j in zip(grads_t, grads_j):
        _assert_close(g_t, g_j, _TOL["matern32"])
