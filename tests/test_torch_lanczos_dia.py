"""The port's single-vector Lanczos (``krylov.lanczos.tridiag``), its fused
DIA path (K6/K7 through their plain versions on the CPU) and its dispatch
against the JAX package, on the same numpy inputs.

The fused path is held to ``pallas_lanczos.tridiag_dia_fused`` in
interpret mode with the JAX test's tolerances (1e-4 for values, 1e-3
relative for gradients); the generic recursion and its closed-form
adjoint to ``lanczos.tridiag(reortho="none")`` in float64 (scoped
``jax.enable_x64``).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_lanczos as jpallas_lanczos  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_lanczos, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

# float64 parity: the same recursions in another summation order agree to
# round-off amplified by the Krylov depth.
_TOL64 = 1e-8
# The JAX package's event for each of the port's.
_EVENTS = {"tridiag:dia_fused": "tridiag:pallas_dia_fused", "tridiag:generic": "tridiag:xla_scan"}


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _jax_done(tree):
    """JAX results as numpy, so no JAX work is in flight while PyTorch runs."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _laplacian_1d(n, diag=2.5):
    """The JAX fused-kernel tests' operator: diag on the diagonal, -1 beside it."""
    idx = np.arange(n)
    rows = np.concatenate([idx, idx[:-1], idx[1:]])
    cols = np.concatenate([idx, idx[1:], idx[:-1]])
    vals = np.concatenate([diag * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    return rows, cols, vals


def _both(n, diag=2.5):
    """(JAX DIAData, JAX values, port DIAData, port values), float32 on the CPU."""
    coo = _laplacian_1d(n, diag)
    mat_j = jsparse.csr_from_coo(*coo, shape=(n, n))
    dia_j = jsparse.dia_pack(mat_j)
    vals_j = jsparse.dia_values(dia_j, mat_j.data).astype(jnp.float32)
    dia_t, vals_t = sparse.dia_from_jax(dia_j, np.asarray(vals_j), device="cpu")
    return dia_j, vals_j, dia_t, vals_t


def _loss(out):
    """The JAX fused test's loss: every output enters."""
    (X, (a, b)), (xr, brm) = out
    return a.sum() + b.sum() + (X[3] ** 2).sum() + (xr * brm).sum()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("depth", [10, 12])
def test_fused_matches_the_jax_fused_kernels(depth, stream):
    n = 512
    dia_j, vals_j, dia_t, vals_t = _both(n)
    v0 = np.random.default_rng(0).normal(size=n).astype(np.float32)

    fused_j = jpallas_lanczos.tridiag_dia_fused(dia_j, depth, interpret=True, stream=stream)
    out_j = _jax_done(fused_j(jnp.asarray(v0), vals_j))
    grads_j = _jax_done(
        jax.grad(lambda v, p: _loss(fused_j(v, p)), argnums=(0, 1))(jnp.asarray(v0), vals_j)
    )

    fused_t = fused_lanczos.tridiag_dia_fused(dia_t, depth, stream=stream)
    v = torch.tensor(v0, requires_grad=True)
    p = vals_t.clone().requires_grad_()
    out_t = fused_t(v, p)
    grads_t = torch.autograd.grad(_loss(out_t), [v, p])

    (X_t, (a_t, b_t)), (xr_t, br_t) = out_t
    (X_j, (a_j, b_j)), (xr_j, br_j) = out_j
    assert X_t.shape == (depth, n) and a_t.shape == (depth,) and b_t.shape == (depth - 1,)
    for got, want in ((a_t, a_j), (b_t, b_j), (X_t, X_j), (xr_t, xr_j), (br_t, br_j)):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads_t, grads_j):
        assert _rel(got, want) < 1e-3


def test_forward_and_adjoint_entry_points_match_the_jax_kernels():
    """``lanczos_forward_dia`` and ``lanczos_adjoint_dia`` (K6, K7) against the
    JAX package's resident kernels, on the same decomposition and cotangent."""
    n, depth = 384, 12
    dia_j, vals_j, dia_t, vals_t = _both(n)
    rng = np.random.default_rng(10)
    v0 = rng.normal(size=n).astype(np.float32)
    dxs, dalphas, dbetas = (rng.normal(size=s).astype(np.float32)
                            for s in ((depth + 1, n), depth, depth))
    (xs_j, (al_j, be_j)), (xr_j, br_j) = _jax_done(
        jpallas_lanczos.lanczos_forward_dia(dia_j, depth, interpret=True)(jnp.asarray(v0), vals_j))
    xs_full = np.concatenate([xs_j, xr_j[None]])
    be_full = np.concatenate([be_j, br_j[None]])
    inv_norm = np.float32(1.0 / np.linalg.norm(v0))
    grads_j = _jax_done(jpallas_lanczos.lanczos_adjoint_dia(dia_j, depth, interpret=True)(
        vals_j, *(jnp.asarray(a) for a in (xs_full, al_j, be_full, inv_norm, dxs, dalphas, dbetas))))

    out_t = fused_lanczos.lanczos_forward_dia(dia_t, depth)(torch.tensor(v0), vals_t)
    for got, want in zip(jax.tree_util.tree_leaves(out_t), (xs_j, al_j, be_j, xr_j, br_j)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    grads_t = fused_lanczos.lanczos_adjoint_dia(dia_t, depth)(
        vals_t, *(torch.tensor(a) for a in (xs_full, al_j, be_full, inv_norm, dxs, dalphas, dbetas)))
    for got, want in zip(grads_t, grads_j):
        assert _rel(got, want) < 1e-3


def _dense_sym(n, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * np.linspace(1.0, 2.0, n)) @ q.T
    # Symmetrised parametrisation, as the JAX adjoint test has it.
    return np.triu(A) - np.diag(0.5 * np.diag(A))


def _cotangent(out, seed):
    rng = np.random.default_rng(seed)
    (xs, (al, be)), (r, rb) = out
    return [rng.standard_normal(np.shape(t)) for t in (xs, al, be, r, rb)]


def _jax_vjp(fn, v, A, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(v), jnp.asarray(A))
    (xs, (al, be)), (r, rb) = out
    ct = ((jnp.asarray(cot[0]), (jnp.asarray(cot[1]), jnp.asarray(cot[2]))),
          (jnp.asarray(cot[3]), jnp.asarray(cot[4])))
    return _jax_done((out, vjp(ct)))


def _torch_vjp(fn, v, A, cot):
    vt = torch.tensor(v, requires_grad=True)
    At = torch.tensor(A, requires_grad=True)
    out = fn(vt, At)
    (xs, (al, be)), (r, rb) = out
    grads = torch.autograd.grad([xs, al, be, r, rb], [vt, At], [torch.tensor(c) for c in cot])
    return out, grads


def _assert_close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


@pytest.mark.parametrize("depth", [2, 5, 11])
def test_tridiag_and_its_adjoint_match_jax_in_float64(depth):
    n = 14
    A = _dense_sym(n)
    v = np.random.default_rng(1).standard_normal(n)
    with jax.enable_x64(True):
        out_j = _jax_done(jlanczos.tridiag(lambda s, p: (p + p.T) @ s, depth, reortho="none")(
            jnp.asarray(v), jnp.asarray(A)))
        cot = _cotangent(out_j, 2)
        _out, grads_j = _jax_vjp(
            jlanczos.tridiag(lambda s, p: (p + p.T) @ s, depth, reortho="none"), v, A, cot
        )
    est = lanczos.tridiag(lambda s, p: (p + p.T) @ s, depth, reortho="none")
    out_t, grads_t = _torch_vjp(est, v, A, cot)
    for got, want in zip(jax.tree_util.tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        _assert_close(got, want, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _assert_close(got, want, _TOL64)


@pytest.mark.parametrize("depth", [2, 5, 11])
def test_closed_form_adjoint_matches_backprop(depth):
    """custom_vjp=True against the backprop oracle: float64 tightly, and
    float32 with the JAX adjoint test's tolerance, 1e-4 (1 + depth)."""
    n = 14
    A = _dense_sym(n, seed=3)
    v = np.random.default_rng(4).standard_normal(n)
    cot = _cotangent(((np.zeros((depth, n)), (np.zeros(depth), np.zeros(depth - 1))),
                      (np.zeros(n), np.zeros(()))), 5)
    for dtype, tol in ((np.float64, _TOL64), (np.float32, 1e-4 * (1 + depth))):
        cast = [c.astype(dtype) for c in cot]
        results = []
        for custom_vjp in (True, False):
            est = lanczos.tridiag(lambda s, p: (p + p.T) @ s, depth, reortho="none",
                                  custom_vjp=custom_vjp)
            results.append(_torch_vjp(est, v.astype(dtype), A.astype(dtype), cast))
        (out_c, grads_c), (out_b, grads_b) = results
        for got, want in zip(jax.tree_util.tree_leaves(out_c), jax.tree_util.tree_leaves(out_b)):
            _assert_close(got, want.detach(), tol)
        for got, want in zip(grads_c, grads_b):
            _assert_close(got, want, tol)


def test_generic_tridiag_on_a_dia_operator_matches_jax_in_float64():
    n, depth = 256, 12
    coo = _laplacian_1d(n)
    mat_j = jsparse.csr_from_coo(*coo, shape=(n, n))
    dia_j = jsparse.dia_pack(mat_j)
    vals = np.asarray(jsparse.dia_values(dia_j, mat_j.data))
    v = np.random.default_rng(6).standard_normal(n)
    cot = _cotangent(((np.zeros((depth, n)), (np.zeros(depth), np.zeros(depth - 1))),
                      (np.zeros(n), np.zeros(()))), 7)
    with jax.enable_x64(True):
        vals64 = np.asarray(jsparse.dia_values(dia_j, mat_j.data).astype(jnp.float64))
        out_j, grads_j = _jax_vjp(
            jlanczos.tridiag(jsparse.dia_matvec_fn(dia_j), depth, reortho="none"), v, vals64, cot
        )
    dia_t, _ = sparse.dia_from_jax(dia_j, vals, device="cpu")
    est = lanczos.tridiag(sparse.dia_matvec_fn(dia_t), depth, reortho="none")
    out_t, grads_t = _torch_vjp(est, v, vals64, cot)
    for got, want in zip(jax.tree_util.tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        _assert_close(got, want, _TOL64)
    for got, want in zip(grads_t, grads_j):
        _assert_close(got, want, _TOL64)


def test_plain_kernels_are_the_generic_recursion():
    """K6/K7's plain versions equal the generic tridiag and its adjoint (float64)."""
    n, depth = 384, 15
    _dj, _vj, dia_t, vals_t = _both(n)
    vals = vals_t.double()
    v = torch.tensor(np.random.default_rng(8).standard_normal(n))
    cot = [torch.tensor(c) for c in _cotangent(
        ((np.zeros((depth, n)), (np.zeros(depth), np.zeros(depth - 1))),
         (np.zeros(n), np.zeros(()))), 9)]
    vv, pp = v.clone().requires_grad_(), vals.clone().requires_grad_()
    est = lanczos.tridiag(sparse.dia_matvec_fn(dia_t), depth, reortho="none")
    (xs, (al, be)), (r, rb) = est(vv, pp)
    dv, dvals = torch.autograd.grad([xs, al, be, r, rb], [vv, pp], cot)

    xs_p, al_p, be_p = fused_lanczos.lanczos_forward_plain(dia_t.offsets, vals, v, depth)
    for got, want in ((xs_p[:-1], xs), (xs_p[-1], r), (al_p, al), (be_p[:-1], be), (be_p[-1], rb)):
        _assert_close(got, want.detach(), 1e-12)
    dv_p, dvals_p = fused_lanczos.lanczos_adjoint_plain(
        dia_t.offsets, vals, xs_p, al_p, be_p, 1.0 / torch.linalg.vector_norm(v),
        torch.cat([cot[0], cot[3][None]]), cot[1], torch.cat([cot[2], cot[4][None]]),
    )
    _assert_close(dv_p, dv, 1e-12)
    _assert_close(dvals_p, dvals, 1e-12)


@pytest.fixture()
def _fused_on_cpu(monkeypatch):
    """Make both packages' dispatch predicates hold on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    fused = functools.partial(jpallas_lanczos.tridiag_dia_fused, interpret=True)
    monkeypatch.setattr(jpallas_lanczos, "tridiag_dia_fused", fused)
    monkeypatch.setattr(native, "on_card", lambda device: True)


def test_dispatch_fires_and_matches_the_generic_path(_fused_on_cpu, monkeypatch):
    n, depth = 256, 10
    _dj, _vj, dia_t, vals_t = _both(n, diag=2.0)
    matvec, vals = sparse.sparse_operator(sparse.csr_from_coo(*_laplacian_1d(n, 2.0), shape=(n, n)),
                                          format="dia", device="cpu")
    assert matvec.dia_data is not None
    calls = []
    orig = fused_lanczos.tridiag_dia_fused
    monkeypatch.setattr(fused_lanczos, "tridiag_dia_fused",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))
    v0 = torch.tensor(np.random.default_rng(0).normal(size=n), dtype=torch.float32)
    auto = lanczos.tridiag(matvec, depth, reortho="none")
    plain = lanczos.tridiag(matvec, depth, reortho="none", allow_fused=False)

    def loss(fn, v, p):
        (_, (al, be)), _ = fn(v, p)
        return al.sum() + (be**2).sum()

    results = []
    for fn in (auto, plain):
        v, p = v0.clone().requires_grad_(), vals.clone().requires_grad_()
        (xs, (al, be)), _ = fn(v, p)
        results.append((xs, al, be, *torch.autograd.grad(loss(fn, v, p), [v, p])))
    assert calls, "the fused path was not dispatched"
    for got, want, tol in zip(*results, (1e-5, 1e-5, 1e-5, 1e-4, 1e-4)):
        torch.testing.assert_close(got.detach(), want.detach(), atol=tol, rtol=0)


@pytest.mark.parametrize("n", [250, 900])
def test_dispatch_stays_fused_for_any_n_on_the_card(_fused_on_cpu, n):
    """n % 128 != 0 (and, at 900, n % 1024 != 0 for the matvec): on the card
    the port still takes its kernels, with the generic recursion's values
    and gradients."""
    mat = sparse.csr_from_coo(*_laplacian_1d(n, 2.0), shape=(n, n))
    matvec, vals = sparse.sparse_operator(mat, format="dia", device="cpu")
    v0 = torch.tensor(np.random.default_rng(11).normal(size=n), dtype=torch.float32)
    results, logs = [], []
    for allow_fused in (True, False):
        log = []
        est = lanczos.tridiag(matvec, 10, reortho="none", allow_fused=allow_fused, dispatch_log=log)
        v, p = v0.clone().requires_grad_(), vals.clone().requires_grad_()
        out = est(v, p)
        (_, (al, be)), _ = out
        results.append((al, be, *torch.autograd.grad(_loss(out), [v, p])))
        logs.append(log)
    assert logs == [["tridiag:dia_fused"], ["tridiag:generic"]]
    for got, want, tol in zip(*results, (1e-5, 1e-5, 1e-4, 1e-4)):
        torch.testing.assert_close(got.detach(), want.detach(), atol=tol, rtol=0)


def test_dispatch_falls_back_when_too_large(_fused_on_cpu, monkeypatch):
    """Beyond its VMEM working-set budget the JAX package falls back to its
    scan; the port has no such budget (the basis lives in device memory),
    so on the card it still runs the fused kernels, with the same values."""
    monkeypatch.setattr(jlanczos, "_FUSED_VMEM_BUDGET_BYTES", 1024)
    assert not hasattr(lanczos, "_FUSED_VMEM_BUDGET_BYTES")
    n = 256
    mat = sparse.csr_from_coo(*_laplacian_1d(n, 2.0), shape=(n, n))
    log_t, log_j = [], []
    matvec_j, vals_j = jsparse.sparse_operator(mat, format="dia")
    (_, (al_j, _)), _ = _jax_done(jlanczos.tridiag(matvec_j, 8, reortho="none", dispatch_log=log_j)(
        jnp.ones(n, jnp.float32), vals_j
    ))
    matvec, vals = sparse.sparse_operator(mat, format="dia", device="cpu")
    (_, (al, _)), _ = lanczos.tridiag(matvec, 8, reortho="none", dispatch_log=log_t)(torch.ones(n), vals)
    assert log_j == ["tridiag:xla_scan"]
    assert log_t == ["tridiag:dia_fused"]
    # The JAX fused test's value tolerance: v0 = ones is nearly an
    # eigenvector here, so float32 rounding grows over the steps.
    np.testing.assert_allclose(al.detach().numpy(), al_j, atol=1e-4, rtol=1e-4)


def _events_case(n, kwargs):
    mat = sparse.csr_from_coo(*_laplacian_1d(n, 2.0), shape=(n, n))
    log_t, log_j = [], []
    matvec, vals = sparse.sparse_operator(mat, format="dia", device="cpu")
    lanczos.tridiag(matvec, 8, reortho="none", dispatch_log=log_t, **kwargs)(torch.ones(n), vals)
    matvec_j, vals_j = jsparse.sparse_operator(mat, format="dia")
    jlanczos.tridiag(matvec_j, 8, reortho="none", dispatch_log=log_j, **kwargs)(
        jnp.ones(n, jnp.float32), vals_j
    )
    return log_t, log_j


@pytest.mark.parametrize(
    "n, kwargs, want, want_port",
    [
        (256, {}, ["tridiag:pallas_dia_fused"], None),
        (256, {"allow_fused": False}, ["tridiag:xla_scan"], None),
        # n % 128 != 0: the JAX kernel's tiling rule; K6/K7 take any n.
        (250, {}, ["tridiag:xla_scan"], ["tridiag:dia_fused"]),
        (256, {"custom_vjp": False}, ["tridiag:xla_scan"], None),  # the backprop oracle
    ],
    ids=["fused", "not-allowed", "n-not-128", "backprop"],
)
def test_dispatch_log_corresponds_to_the_jax_packages(_fused_on_cpu, n, kwargs, want, want_port):
    """Where both packages can choose, the events correspond one to one;
    where only the TPU's limits decide, the port (on the card) stays fused."""
    log_t, log_j = _events_case(n, kwargs)
    assert log_j == want
    if want_port is None:
        assert [_EVENTS[e] for e in log_t] == log_j
    else:
        assert log_t == want_port


def test_dispatch_stays_generic_off_the_card():
    """Without the card (and, in JAX, without a TPU) the generic path runs."""
    log_t, log_j = _events_case(256, {})
    assert log_t == ["tridiag:generic"] and log_j == ["tridiag:xla_scan"]


def test_fused_rejects_n_not_a_multiple_of_128_like_the_jax_kernel():
    dia_j, _vj, dia_t, _vt = _both(100)
    with pytest.raises(ValueError, match="multiple") as want:
        jpallas_lanczos.lanczos_forward_dia(dia_j, 5)
    with pytest.raises(ValueError, match="multiple") as got:
        fused_lanczos.lanczos_forward_dia(dia_t, 5)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multiple"):
        fused_lanczos.tridiag_dia_fused(dia_t, 5)


def test_bad_reortho_is_the_jax_packages_value_error():
    with pytest.raises(ValueError) as want:
        jlanczos.tridiag(lambda v: v, 3, reortho="junk")
    with pytest.raises(ValueError) as got:
        lanczos.tridiag(lambda v: v, 3, reortho="junk")
    assert str(got.value) == str(want.value)


def test_full_reortho_waits_for_arnoldi():
    """``reortho="full"`` runs through Arnoldi (ported in slice 3): the JAX
    package's decomposition, and its dispatch events in the port's names."""
    A = _dense_sym(10, seed=12).astype(np.float32)
    v = np.random.default_rng(13).standard_normal(10).astype(np.float32)
    log_j, log_t = [], []
    out_j = _jax_done(jlanczos.tridiag(lambda s, p: (p + p.T) @ s, 6, reortho="full", dispatch_log=log_j)(
        jnp.asarray(v), jnp.asarray(A)))
    out_t = lanczos.tridiag(lambda s, p: (p + p.T) @ s, 6, reortho="full", dispatch_log=log_t)(
        torch.tensor(v), torch.tensor(A))
    for got, want in zip(jax.tree_util.tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert log_j == ["tridiag:arnoldi_full", "hessenberg:xla_loop"]
    assert log_t == ["tridiag:arnoldi_full", "hessenberg:generic"]


def test_depth_beyond_n_is_the_jax_packages_value_error():
    with pytest.raises(ValueError, match="outside the expected range") as want:
        jlanczos.tridiag(lambda v: v, 9, reortho="none")(jnp.ones(8))
    with pytest.raises(ValueError, match="outside the expected range") as got:
        lanczos.tridiag(lambda v: v, 9, reortho="none")(torch.ones(8))
    assert str(got.value) == str(want.value)


def test_fused_guards_an_exactly_exhausted_krylov_space_like_jax():
    """A = 1.5 I with a one-hot v0: the residual is exactly zero at step 0."""
    n, depth = 256, 6
    idx = np.arange(n)
    mat_j = jsparse.csr_from_coo(idx, idx, 1.5 * np.ones(n, np.float32), shape=(n, n))
    dia_j = jsparse.dia_pack(mat_j)
    vals_j = jsparse.dia_values(dia_j, mat_j.data)
    v0 = np.zeros(n, np.float32)
    v0[7] = 1.0
    fused_j = jpallas_lanczos.tridiag_dia_fused(dia_j, depth, interpret=True)
    out_j = _jax_done(fused_j(jnp.asarray(v0), vals_j))
    grads_j = _jax_done(jax.grad(lambda v, p: _loss(fused_j(v, p)), argnums=(0, 1))(jnp.asarray(v0), vals_j))

    dia_t, vals_t = sparse.dia_from_jax(dia_j, np.asarray(vals_j), device="cpu")
    v, p = torch.tensor(v0, requires_grad=True), vals_t.clone().requires_grad_()
    out_t = fused_lanczos.tridiag_dia_fused(dia_t, depth)(v, p)
    grads_t = torch.autograd.grad(_loss(out_t), [v, p])
    (X, (alphas, betas)), (_x_res, beta_res) = out_t
    assert float(alphas[0].detach()) == 1.5
    assert float(betas.detach().abs().max()) == 0.0 and float(beta_res.detach()) == 0.0
    assert float(X[1:].detach().abs().max()) == 0.0
    for got, want in zip(jax.tree_util.tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    for got, want in zip(grads_t, grads_j):
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# K7's launch plan on an H100 SXM: 132 SMs, 227 KB (232,448 bytes) of
# opt-in shared memory a block.
H100_SMS, H100_SMEM = 132, 232_448


def _adjoint_plan(n, offsets, sms=H100_SMS, smem=H100_SMEM, depth=90):
    return fused_lanczos.adjoint_plan(n, depth, sms, smem, num_diags=len(offsets))


# Shared bytes: the offsets (rounded up to 4), 48 floats of block sums, and
# the block's resident_diags x rows slice of dvals.
@pytest.mark.parametrize(("n", "offsets", "resident_diags", "smem_bytes"), [
    # bench.py's 1024^2 Laplacian: 132 blocks of 7,944 rows; dvals (5 x 7,944
    # floats, 158.9 KB) resident.
    (1 << 20, (-1024, -1, 0, 1, 1024), 5, 4 * (8 + 48 + 5 * 7_944)),
    # The 128^2 Laplacian: 128 blocks of 128 rows, 128 threads each.
    (16_384, (-128, -1, 0, 1, 128), 5, 4 * (8 + 48 + 5 * 128)),
    # Offsets across half the circle: resident all the same.
    (1 << 20, (-(1 << 19) + 4, 0, 1 << 19), 3, 4 * (4 + 48 + 3 * 7_944)),
    # At n = 2^20 seven diagonals of dvals fit (217.4 KB): all of a
    # 7-diagonal operator's; 7 of the 8, 9 (the 9-point stencil), 27 and 65
    # of wider ones, the others streamed.
    (1 << 20, tuple(range(-3, 4)), 7, 4 * (8 + 48 + 7 * 7_944)),
    (1 << 20, tuple(range(-4, 4)), 7, 4 * (8 + 48 + 7 * 7_944)),
    (1 << 20, (-1025, -1024, -1023, -1, 0, 1, 1023, 1024, 1025), 7, 4 * (12 + 48 + 7 * 7_944)),
    (1 << 20, tuple(a + b for a in (-1024, 0, 1024) for b in (-1, 0, 1)) + tuple(range(2, 20)),
     7, 4 * (28 + 48 + 7 * 7_944)),
    (1 << 20, tuple(range(-32, 33)), 7, 4 * (68 + 48 + 7 * 7_944)),
])
def test_adjoint_plan_keeps_dvals_on_chip_where_it_fits(n, offsets, resident_diags, smem_bytes):
    plan = _adjoint_plan(n, offsets)
    assert (plan.resident_diags, plan.smem_bytes) == (resident_diags, smem_bytes)
    assert plan.path == ("resident" if resident_diags == len(offsets) else "streamed")
    assert plan.blocks <= H100_SMS and plan.rows % 4 == 0
    assert plan.blocks * plan.rows >= n > (plan.blocks - 1) * plan.rows
    assert plan.smem_bytes <= H100_SMEM - fused_lanczos.SMEM_RESERVE
    assert plan.partial_floats == 3 * -(-plan.blocks // 4) * 4
    if n == 1 << 20:
        assert (plan.blocks, plan.rows, plan.threads, plan.state) == (132, 7_944, 512, "registers")
    else:
        assert (plan.blocks, plan.rows, plan.threads, plan.state) == (128, 128, 128, "registers")


def test_adjoint_plan_takes_any_n_and_depth():
    """Past 16 rows a thread the block's state moves to device memory; a
    card with little shared memory streams dvals; no n or depth is refused
    but those outside [1, n]."""
    big = _adjoint_plan(3_000_000, (-1, 0, 1), depth=3)
    assert big.rows == 22_728 and big.state == "device" and big.path == "streamed"
    assert big.resident_diags == 2
    mid = _adjoint_plan(1_200_000, (-1, 0, 1))
    assert mid.rows == 9_092 and mid.state == "device" and mid.path == "resident"
    small = _adjoint_plan(100, (-1, 0, 1), sms=66)
    assert (small.blocks, small.rows, small.threads, small.path) == (25, 4, 32, "resident")
    assert _adjoint_plan(1 << 20, (-1024, 0, 1024), smem=48 * 1024).resident_diags == 1
    assert _adjoint_plan(1 << 20, (-1024, 0, 1024), smem=24 * 1024).resident_diags == 0
    with pytest.raises(ValueError, match="no K7 plan"):
        _adjoint_plan(100, (0,), depth=101)
    with pytest.raises(ValueError, match="shared memory"):
        _adjoint_plan(1 << 20, tuple(range(2_000)), smem=8_192)


def _band(num_diags):
    """``num_diags`` contiguous offsets around the main diagonal."""
    return tuple(range(-(num_diags // 2), num_diags - num_diags // 2))


def _forward_plan(n, num_diags, sms=H100_SMS, smem=H100_SMEM, depth=90, offsets=None):
    """K6's plan for ``offsets``, by default a band of ``num_diags``."""
    return fused_lanczos.forward_plan(n, min(depth, n), sms, smem, offsets=offsets or _band(num_diags))


def _forward_smem(num_diags, rows, resident, path, window=0):
    """The offsets and the window table (3 D + 4 ints), each rounded up to
    4, 532 floats of block sums (16 warps' and 2 totals, and 2 x 16 x 16
    warp sums pushed across a cluster), the block's rows of the resident
    values, on the cluster path its rows of r, and the window of x."""
    round4 = lambda count: -(-count // 4) * 4  # noqa: E731
    return 4 * (round4(num_diags) + round4(3 * num_diags + 4) + 532
                + (resident + (path == "cluster")) * rows + window)


# K6's launch plan on an H100: (n, diagonals) -> path, blocks x rows,
# threads, resident diagonals of the values, where the state lives.
@pytest.mark.parametrize(("n", "num_diags", "path", "blocks", "rows", "threads", "resident", "state"), [
    # bench.py's 1024^2 Laplacian: the values' 5 x 7,944 floats (158,880 B)
    # resident, 16 rows a thread in registers.
    (1 << 20, 5, "grid", 132, 7_944, 512, 5, "registers"),
    (1_000_000, 5, "grid", 132, 7_576, 512, 5, "registers"),
    # 65 diagonals at 2^20: 7 of them fit, the others read each step.
    (1 << 20, 65, "grid", 132, 7_944, 512, 7, "registers"),
    # Tridiagonal: past 16 rows a thread the state moves to device memory.
    (1_200_000, 3, "grid", 132, 9_092, 512, 3, "device"),
    (3_000_000, 3, "grid", 132, 22_728, 512, 2, "device"),
    # The cluster path: the 128^2 Laplacian, the exhausted case (one
    # diagonal) and the tridiagonal parity operators.
    (16_384, 5, "cluster", 16, 1_024, 512, 5, "registers"),
    (16_384, 1, "cluster", 16, 1_024, 512, 1, "registers"),
    (4_736, 3, "cluster", 16, 296, 320, 3, "registers"),
    (4_739, 3, "cluster", 16, 300, 320, 3, "registers"),
])
def test_forward_plan_on_an_h100(n, num_diags, path, blocks, rows, threads, resident, state):
    plan = _forward_plan(n, num_diags)
    assert (plan.path, plan.blocks, plan.rows, plan.threads, plan.resident_diags, plan.state) == (
        path, blocks, rows, threads, resident, state)
    assert plan.values == ("resident" if resident == num_diags else "streamed")
    assert plan.smem_bytes == _forward_smem(num_diags, rows, resident, path, plan.window)
    assert plan.smem_bytes <= H100_SMEM - fused_lanczos.SMEM_RESERVE
    assert plan.blocks * plan.rows >= n and plan.rows % 4 == 0
    if path == "grid":
        assert (plan.blocks - 1) * plan.rows < n
        assert plan.partial_floats == 2 * -(-plan.blocks // 4) * 4
    else:
        assert plan.partial_floats == 0


def test_forward_plan_takes_the_cluster_path_up_to_its_limit():
    """Up to CLUSTER_MAX_N (16,384, the 128^2 Laplacian) the cluster, with
    its window of x and at most FEW_SLOTS rows a thread (the kernel's one
    cluster instantiation); above it, or where the cluster's shared memory
    cannot hold the values, r and the window, the grid."""
    top = fused_lanczos.CLUSTER_MAX_N
    assert top == 16_384
    cluster = _forward_plan(top, 5, offsets=(-128, -1, 0, 1, 128))
    assert (cluster.path, cluster.blocks, cluster.slots, cluster.window) == (
        "cluster", fused_lanczos.CLUSTER_BLOCKS, fused_lanczos.FEW_SLOTS, 1_280)
    assert _forward_plan(top + 1, 5).path == "grid"
    assert _forward_plan(16_384, 5, smem=24 * 1024).path == "grid"
    # 40 diagonals 410 apart: the values (160 KB) fit a cluster's block, but
    # not beside a window of 41 spans of 1,024 rows.
    spread = _forward_plan(16_384, 40, offsets=tuple(410 * k for k in range(-20, 20)))
    assert (spread.path, spread.blocks, spread.rows) == ("grid", 128, 128)
    for n in (4_736, 4_739, 16_384):
        plan = _forward_plan(n, 3)
        assert plan.path == "cluster" and plan.window >= plan.rows and plan.slots == fused_lanczos.FEW_SLOTS


@pytest.mark.parametrize(("n", "offsets", "slots", "windowed"), [
    # The grid path's six instantiations: 4 rows a thread or fewer (256^2;
    # 65 diagonals 1,001 apart, no room for the window), 16 (1024^2; 65
    # diagonals), the state in device memory (1.2M with the window, 3M
    # without).
    (65_536, (-256, -1, 0, 1, 256), 4, True),
    (65_536, tuple(1_001 * k for k in range(-32, 33)), 4, False),
    (1 << 20, (-1024, -1, 0, 1, 1024), 16, True),
    (1 << 20, tuple(range(-32, 33)), 16, False),
    (1_200_000, (-1, 0, 1), 0, True),
    (3_000_000, (-1, 0, 1), 0, False),
])
def test_forward_plan_picks_each_grid_instantiation(n, offsets, slots, windowed):
    plan = _forward_plan(n, len(offsets), offsets=offsets)
    assert (plan.path, plan.slots, bool(plan.window)) == ("grid", slots, windowed)
    assert plan.state == ("registers" if slots else "device")


def test_forward_plan_on_a_small_card():
    """66 SMs: 15,888 rows a block, 31 a thread (the state in device
    memory), 3 of the 5 diagonals of the values on chip."""
    plan = _forward_plan(1 << 20, 5, sms=66)
    assert (plan.path, plan.blocks, plan.rows, plan.threads, plan.resident_diags, plan.state) == (
        "grid", 66, 15_888, 512, 3, "device")
    assert _forward_plan(1 << 20, 5, smem=24 * 1024).resident_diags == 0
    with pytest.raises(ValueError, match="shared memory"):
        _forward_plan(1 << 20, 2_000, smem=8_192)


@pytest.mark.parametrize(("n", "depth"), [(100, 0), (100, 101), (16_384, -1)])
def test_forward_plan_refuses_depth_outside_1_n(n, depth):
    with pytest.raises(ValueError, match="no K6 plan"):
        fused_lanczos.forward_plan(n, depth, H100_SMS, H100_SMEM, offsets=(-1, 0, 1))


_LAPLACIAN_2D = (-1024, -1, 0, 1, 1024)


@pytest.mark.parametrize(("n", "offsets", "window"), [
    # The 1024^2 Laplacian: the block's 7,944 rows and 1,024 either side
    # (40 KB) beside the values' 158.9 KB.
    (1 << 20, _LAPLACIAN_2D, 9_992),
    # 65 diagonals: 7 of the values fill the shared memory, no window.
    (1 << 20, tuple(range(-32, 33)), 0),
    # Offsets half way round: three spans of 7,944 rows.
    (1 << 20, (-(1 << 19) + 3, 0, (1 << 19) - 3), 3 * 7_944),
    # The cluster path at 16,384: 1,024 rows and 128 either side.
    (16_384, (-128, -1, 0, 1, 128), 1_280),
    (4_739, (-1, 0, 1), 302),
])
def test_forward_plan_puts_the_window_beside_the_values(n, offsets, window):
    plan = _forward_plan(n, len(offsets), offsets=offsets)
    assert plan.window == window
    assert plan.smem_bytes == _forward_smem(len(offsets), plan.rows, plan.resident_diags, plan.path, window)
    assert plan.smem_bytes <= H100_SMEM - fused_lanczos.SMEM_RESERVE
    # The values keep the shared memory they have without the window.
    budget = H100_SMEM - fused_lanczos.SMEM_RESERVE
    alone = (budget - _forward_smem(len(offsets), plan.rows, 0, "grid")) // (4 * plan.rows)
    assert plan.resident_diags == (len(offsets) if plan.path == "cluster" else min(len(offsets), alone))


@pytest.mark.parametrize(("n", "offsets", "rows"), [
    (1 << 20, _LAPLACIAN_2D, 7_944),
    (1 << 20, (-(1 << 19) + 3, 0, (1 << 19) - 3), 7_944),
    (100, (-1, 0, 1), 8),  # the last block wraps round to the first rows
    (97, (3, 50, -40), 12),  # no main diagonal; spans that overlap across the wrap
    (4_739, (-1, 0, 1), 300),
])
def test_window_table_maps_every_read_to_its_row(n, offsets, rows):
    """Replays the kernel's use of the table: ``stage_halo`` fills window
    slot idx with row (r0 + rel) mod n from its span, the block's own rows
    sit at the first entry, and the matvec reads row r0 + r + d_k at
    ``base_k + r``: every read finds its row, in every block."""
    floats, table = fused_lanczos.window_table(offsets, n, rows)
    own, segs = table[0], table[1]
    starts = table[2:2 + 2 * segs:2]
    rels = table[3:3 + 2 * segs:2]
    bases = table[2 + 2 * segs:2 + 2 * segs + len(offsets)]
    assert len(table) == 3 * len(offsets) + 4 and starts[0] == 0
    for r0 in range(0, n, rows):
        length = min(n, r0 + rows) - r0
        window = [None] * floats
        for r in range(length):
            window[own + r] = r0 + r
        for j in range(floats - length):
            idx = j if j < own else j + length
            i = max(k for k in range(segs) if starts[k] <= idx)
            window[idx] = (r0 + rels[i] + idx - starts[i]) % n
        for k, d in enumerate(offsets):
            for r in range(length):
                assert window[bases[k] + r] == (r0 + r + d) % n
