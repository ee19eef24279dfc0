"""The port's fused Arnoldi over a DIA operator (K9 through its plain version
on the CPU, ``ops.fused_arnoldi``) and its dispatch, against the JAX
package's ``pallas_arnoldi`` in interpret mode on the same numpy inputs.

Tolerances are the JAX fused test's (``test_pallas_arnoldi.py``): 1e-4
with re-orthogonalisation, 1e-3 without, and 1e-4 relative for the
gradients; past depth 48 (the JAX package's looped kernel) the port is
held to JAX's generic ``hessenberg`` on the stable leading columns plus
the factorisation invariants, as the JAX test does. K9's launch plan
(``fused_arnoldi.launch_plan``) is pinned for an H100's 132 SMs and
227 KB of shared memory a block.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import arnoldi as jarnoldi  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_arnoldi as jpallas_arnoldi  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_arnoldi, fused_dia, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _jax_done(tree):
    """JAX results as numpy, so no JAX work is in flight while PyTorch runs."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _laplacian(m):
    """(JAX DIAData, JAX float32 values, port DIAData, port values) of the m x m grid."""
    mat = test_util.laplacian_2d(m)
    mat_j = jsparse.csr_from_coo(mat.rows, mat.indices, mat.data.astype(np.float32), shape=mat.shape)
    dia_j = jsparse.dia_pack(mat_j)
    vals_j = jsparse.dia_values(dia_j, mat_j.data)
    dia_t, vals_t = sparse.dia_from_jax(dia_j, np.asarray(vals_j), device="cpu")
    return dia_j, vals_j, dia_t, vals_t


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)


@pytest.mark.parametrize("reortho", ["full", "none"])
@pytest.mark.parametrize(("m", "depth"), [(16, 1), (16, 5), (16, 12), (32, 8)])
def test_plain_forward_matches_the_jax_kernel(m, depth, reortho):
    dia_j, vals_j, dia_t, vals_t = _laplacian(m)
    n = m * m
    v0 = np.random.default_rng(depth).normal(size=n).astype(np.float32)
    out_j = _jax_done(jpallas_arnoldi.hessenberg_dia_forward(dia_j, depth, reortho=reortho, interpret=True)(
        jnp.asarray(v0), vals_j))
    out_t = fused_arnoldi.hessenberg_dia_forward(dia_t, depth, reortho=reortho)(torch.tensor(v0), vals_t)
    assert out_t[0].shape == (n, depth) and out_t[1].shape == (depth, depth)
    tol = 1e-4 if reortho == "full" else 1e-3
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got.numpy(), want, atol=tol)


def test_fused_gradients_match_the_jax_fused_kernel():
    """The JAX fused-gradient test: random cotangents on Q and H, all-ones on
    the residual and 1/|v0|; relative 1e-4."""
    dia_j, vals_j, dia_t, vals_t = _laplacian(16)
    n, depth = 256, 6
    rng = np.random.default_rng(1)
    v0 = rng.normal(size=n).astype(np.float32)
    dQ = rng.normal(size=(n, depth)).astype(np.float32)
    dH = rng.normal(size=(depth, depth)).astype(np.float32)

    def loss(Q, H, res, c):
        return (Q * dQ).sum() + (H * dH).sum() + res.sum() + c

    fused_j = jpallas_arnoldi.hessenberg_dia_fused(dia_j, depth, reortho="full", interpret=True)
    grads_j = _jax_done(jax.grad(lambda v, p: loss(*fused_j(v, p)), argnums=(0, 1))(jnp.asarray(v0), vals_j))
    fused_t = fused_arnoldi.hessenberg_dia_fused(dia_t, depth, reortho="full")
    v, p = torch.tensor(v0, requires_grad=True), vals_t.clone().requires_grad_()
    dQ, dH = torch.tensor(dQ), torch.tensor(dH)
    grads_t = torch.autograd.grad(loss(*fused_t(v, p)), [v, p])
    for got, want in zip(grads_t, grads_j):
        assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("reortho", ["full", "none"])
def test_deep_plain_forward_matches_jax_generic_hessenberg(reortho):
    """K = 64 > 48, the JAX package's looped-kernel regime: the stable
    leading columns elementwise, and the invariants for all of them."""
    dia_j, vals_j, dia_t, vals_t = _laplacian(16)
    n, depth = 256, 64
    v0 = np.random.default_rng(0).normal(size=n).astype(np.float32)
    Qg, Hg, resg, cg = _jax_done(jarnoldi.hessenberg(jsparse.dia_matvec_fn(dia_j), depth, reortho=reortho)(
        jnp.asarray(v0), vals_j))
    Q, H, res, c = fused_arnoldi.hessenberg_dia_forward(dia_t, depth, reortho=reortho)(torch.tensor(v0), vals_t)
    tol = 1e-4 if reortho == "full" else 1e-3
    stable = 32 if reortho == "full" else 12
    np.testing.assert_allclose(Q[:, :stable].numpy(), Qg[:, :stable], atol=tol)
    np.testing.assert_allclose(H[: stable + 1, :stable].numpy(), Hg[: stable + 1, :stable], atol=tol)
    np.testing.assert_allclose(float(c), float(cg), rtol=1e-6)
    AQ = torch.stack([sparse.dia_matvec_fn(dia_t)(q, vals_t) for q in Q.T], dim=1)
    R = AQ - Q @ H
    R[:, -1] -= res
    assert float(R.abs().max()) < 1e-5
    if reortho == "full":
        np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(depth), atol=1e-5)
    assert torch.equal(H, torch.triu(H, -1))


def test_plain_forward_is_the_generic_recursion_in_float64():
    """K9's plain version computes ``krylov.arnoldi._forward`` over the DIA
    operator, to float64 rounding amplified over 10 steps."""
    _dj, _vj, dia_t, vals_t = _laplacian(8)
    vals = vals_t.double()
    v0 = torch.tensor(np.random.default_rng(2).normal(size=64))
    for reortho in ("none", "full"):
        q, h, res, c = fused_arnoldi.hessenberg_dia_forward_plain(dia_t.offsets, vals, v0, 10, reortho)
        Q, H, res_g, c_g = arnoldi._forward(sparse.dia_matvec_fn(dia_t), 10, v0, vals, reortho=reortho)
        for got, want in ((q.T, Q), (h, H), (res, res_g), (c, c_g)):
            torch.testing.assert_close(got, want, atol=1e-10, rtol=0)


def test_backward_runs_transposed_k4_and_k5_once_a_step(monkeypatch):
    """Per adjoint step the Function takes ``A^T lam`` (the transposed K4)
    and the value gradient (K5), and never the forward K4."""
    _dj, _vj, dia_t, vals_t = _laplacian(16)
    depth = 7
    calls = []
    matvec_rows, dvals_rows = fused_dia.dia_matvec_rows, fused_dia.dia_dvals_rows
    monkeypatch.setattr(fused_dia, "dia_matvec_rows",
                        lambda *a, kernel=fused_dia.DIA_MATVEC: calls.append(kernel.name) or matvec_rows(*a, kernel=kernel))
    monkeypatch.setattr(fused_dia, "dia_dvals_rows", lambda *a: calls.append("dia_dvals") or dvals_rows(*a))
    v = torch.ones(256, requires_grad=True)
    p = vals_t.clone().requires_grad_()
    out = fused_arnoldi.hessenberg_dia_fused(dia_t, depth, reortho="full")(v, p)
    torch.autograd.grad(out, [v, p], [torch.ones_like(o) for o in out])
    assert sorted(calls) == ["dia_dvals"] * depth + ["dia_matvec_transposed"] * depth


def test_fused_and_generic_gradients_agree_on_the_cpu():
    """The Function (plain K9 forward, adjoint over the DIA kernels' plain
    versions, float32 as the kernels) against ``hessenberg`` over the roll
    matvec: the same arithmetic in another order, to float32 rounding."""
    _dj, _vj, dia_t, vals = _laplacian(8)
    v0 = torch.tensor(np.random.default_rng(3).normal(size=64), dtype=torch.float32)
    rng = np.random.default_rng(4)
    cot = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((64, 9), (9, 9), (64,), ())]
    grads = []
    for fn in (fused_arnoldi.hessenberg_dia_fused(dia_t, 9, reortho="full", check_tiling=False),
               arnoldi.hessenberg(sparse.dia_matvec_fn(dia_t), 9, reortho="full", allow_fused=False)):
        v, p = v0.clone().requires_grad_(), vals.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(v, p), [v, p], cot))
    for got, want in zip(*grads):
        assert _rel(got, want) < 1e-5


@pytest.fixture()
def _on_card(monkeypatch):
    """Make the port's dispatch predicate hold on the CPU."""
    monkeypatch.setattr(native, "on_card", lambda device: True)


@pytest.mark.parametrize("n", [250, 900])
def test_dispatch_goes_fused_for_any_n_on_the_card(_on_card, monkeypatch, n):
    """n % 128 != 0: on the card the port still takes K9, with the generic
    loop's values and gradients."""
    idx = np.arange(n)
    mat = sparse.csr_from_coo(
        np.concatenate([idx, idx[:-1], idx[1:]]), np.concatenate([idx, idx[1:], idx[:-1]]),
        np.concatenate([2.5 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)]), shape=(n, n))
    matvec, vals = sparse.sparse_operator(mat, format="dia", device="cpu")
    calls = []
    orig = fused_arnoldi.hessenberg_dia_fused
    monkeypatch.setattr(fused_arnoldi, "hessenberg_dia_fused",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    v0 = torch.tensor(np.random.default_rng(11).normal(size=n), dtype=torch.float32)
    results, logs = [], []
    for allow_fused in (True, False):
        log = []
        est = arnoldi.hessenberg(matvec, 10, reortho="full", allow_fused=allow_fused, dispatch_log=log)
        v, p = v0.clone().requires_grad_(), vals.clone().requires_grad_()
        out = est(v, p)
        results.append((*out, *torch.autograd.grad(out, [v, p], [torch.ones_like(o) for o in out])))
        logs.append(log)
    assert logs == [["hessenberg:dia_fused"], ["hessenberg:generic"]]
    assert calls == [{"reortho": "full", "reortho_vjp": "match", "check_tiling": False}]
    for got, want in zip(*results):
        torch.testing.assert_close(got.detach(), want.detach(), atol=1e-4, rtol=1e-4)


def test_dispatch_of_full_reortho_tridiag_on_the_card(_on_card):
    mat = test_util.laplacian_2d(8)
    matvec, vals = sparse.sparse_operator(mat, device="cpu")
    log = []
    lanczos.tridiag(matvec, 6, reortho="full", dispatch_log=log)(torch.ones(64), vals)
    lanczos.tridiag(matvec, 6, reortho="full", allow_fused=False, dispatch_log=log)(torch.ones(64), vals)
    assert log == ["tridiag:arnoldi_full", "hessenberg:dia_fused",
                   "tridiag:arnoldi_full", "hessenberg:generic"]


def test_dispatch_stays_generic_off_the_card_and_for_other_calls():
    mat = test_util.laplacian_2d(8)
    matvec, vals = sparse.sparse_operator(mat, device="cpu")
    log, log_j = [], []
    arnoldi.hessenberg(matvec, 6, reortho="full", dispatch_log=log)(torch.ones(64), vals)
    matvec_j, vals_j = jsparse.sparse_operator(mat, format="dia")
    jarnoldi.hessenberg(matvec_j, 6, reortho="full", dispatch_log=log_j)(jnp.ones(64, jnp.float32), vals_j)
    assert log == ["hessenberg:generic"] and log_j == ["hessenberg:xla_loop"]


def test_float64_on_the_card_raises(_on_card):
    """K9 takes float32: a float64 call on the card raises, in the operator's
    construction or, for a float64 call of a float32 operator, in K9."""
    mat = test_util.laplacian_2d(8)
    with pytest.raises(TypeError, match="float32"):
        sparse.sparse_operator(mat, dtype=torch.float64, device="cpu")
    matvec, vals = sparse.sparse_operator(mat, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        arnoldi.hessenberg(matvec, 6, reortho="full")(torch.ones(64, dtype=torch.float64), vals.double())


def test_direct_entry_points_raise_the_jax_errors():
    dia_j, _vj, dia_t, _vt = _laplacian(10)  # n = 100, not a multiple of 128
    with pytest.raises(ValueError, match="multiple") as want:
        jpallas_arnoldi.hessenberg_dia_forward(dia_j, 5, reortho="full")
    with pytest.raises(ValueError, match="multiple") as got:
        fused_arnoldi.hessenberg_dia_forward(dia_t, 5, reortho="full")
    assert str(got.value) == str(want.value)
    dia_j, _vj, dia_t, _vt = _laplacian(16)
    for depth in (0, 257):
        with pytest.raises(ValueError, match="outside the expected range") as want:
            jpallas_arnoldi.hessenberg_dia_forward(dia_j, depth, reortho="full")
        with pytest.raises(ValueError, match="outside the expected range") as got:
            fused_arnoldi.hessenberg_dia_fused(dia_t, depth, reortho="full")
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="Unexpected input") as want:
        jpallas_arnoldi.hessenberg_dia_fused(dia_j, 4, reortho="junk")
    with pytest.raises(TypeError, match="Unexpected input") as got:
        fused_arnoldi.hessenberg_dia_fused(dia_t, 4, reortho="junk")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("reortho", ["full", "none"])
def test_exhausted_krylov_space_matches_the_jax_kernel_exactly(reortho):
    """A = 1.5 I with a one-hot v0: the residual is exactly zero at step 0."""
    n, depth = 256, 6
    idx = np.arange(n)
    mat_j = jsparse.csr_from_coo(idx, idx, 1.5 * np.ones(n, np.float32), shape=(n, n))
    dia_j = jsparse.dia_pack(mat_j)
    vals_j = jsparse.dia_values(dia_j, mat_j.data)
    v0 = np.zeros(n, np.float32)
    v0[7] = 1.0

    def loss(Q, H, res, c):
        return (Q[:, 0] ** 2).sum() + H.sum() + res.sum() + c

    fused_j = functools.partial(jpallas_arnoldi.hessenberg_dia_fused, interpret=True)(dia_j, depth, reortho=reortho)
    out_j = _jax_done(fused_j(jnp.asarray(v0), vals_j))
    grads_j = _jax_done(jax.grad(lambda v, p: loss(*fused_j(v, p)), argnums=(0, 1))(jnp.asarray(v0), vals_j))
    dia_t, vals_t = sparse.dia_from_jax(dia_j, np.asarray(vals_j), device="cpu")
    v, p = torch.tensor(v0, requires_grad=True), vals_t.clone().requires_grad_()
    out_t = fused_arnoldi.hessenberg_dia_fused(dia_t, depth, reortho=reortho)(v, p)
    grads_t = torch.autograd.grad(loss(*out_t), [v, p])
    Q, H, res, _c = (t.detach() for t in out_t)
    assert float(H[0, 0]) == 1.5 and float(H.abs().sum()) == 1.5
    assert float(Q[:, 1:].abs().max()) == 0.0 and float(res.abs().max()) == 0.0
    for got, want in zip(out_t, out_j):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    for got, want in zip(grads_t, grads_j):
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# K9's launch plan on an H100 SXM: 132 SMs, 227 KB (232,448 bytes) of
# opt-in shared memory a block.
H100_SMS, H100_SMEM = 132, 232_448


def _plan(n, depth, reortho="full", sms=H100_SMS, smem=H100_SMEM):
    """The plan on the Laplacian's 5 diagonals (3 for the tridiagonal n = 4,739)."""
    return fused_arnoldi.launch_plan(n, depth, reortho, sms, smem, num_diags=3 if n == 4_739 else 5)


@pytest.mark.parametrize(("n", "depth", "reortho"), [(16_384, 90, "full"), (16_384, 90, "none"),
                                                     (16_384, 250, "full"), (4_739, 12, "full")])
def test_launch_plan_keeps_the_basis_resident_at_small_n(n, depth, reortho):
    """The block's (K + 1) x rows floats fit beside the coefficients: 128
    blocks of 128 rows at n = 16,384 (128 KB of basis at K = 250)."""
    plan = _plan(n, depth, reortho)
    assert plan.path == "resident" and plan.stage_floats == 0
    assert plan.rows % 4 == 0 and plan.blocks * plan.rows >= n > (plan.blocks - 1) * plan.rows
    assert plan.smem_bytes >= 4 * (depth + 1) * plan.rows
    assert plan.smem_bytes <= H100_SMEM - fused_arnoldi.SMEM_RESERVE
    assert plan.sweeps == (3 if reortho == "full" else 2)
    assert all(plan.tile_rows(i) == plan.rows for i in (0, depth - 1))
    if n == 16_384:
        assert (plan.blocks, plan.rows) == (128, 128)


@pytest.mark.parametrize(("n", "depth", "tile_rows_last"), [(1_000_000, 90, 308), (100_489, 90, 308),
                                                            (262_144, 250, 108)])
def test_launch_plan_streams_the_basis_where_it_does_not_fit(n, depth, tile_rows_last):
    """Streamed: the largest staging buffers that fit. A B or C tile at step
    i holds i + 2 rows (Q[:i+1] and w), an A tile i + D rows (Q[:i] and the
    values) and D + 1 windows of T + 4 floats of the previous residual, so
    tiles are shallowest at the last step; a block launches a producer warp
    beside its computing threads."""
    plan = _plan(n, depth)
    assert plan.path == "streamed" and plan.blocks <= H100_SMS
    assert plan.block_threads == plan.threads + 32 <= fused_arnoldi.MAX_BLOCK_THREADS
    assert 4 * (depth + 1) * plan.rows > H100_SMEM  # the block's slice would not fit
    assert plan.tile_rows(depth - 1) == tile_rows_last
    for step in range(depth):
        t = plan.tile_rows(step)
        assert t % 4 == 0 and 4 <= t <= min(plan.rows, plan.threads)
        assert (step + 2) * t <= plan.stage_floats  # a buffer holds the tile
        ta, d = plan.tile_rows(step, "A"), plan.num_diags
        assert ta % 4 == 0 and 4 <= ta <= t
        assert (step + d) * ta + (d + 1) * (ta + 4) <= plan.stage_floats
    assert fused_arnoldi.STAGES >= 2 and fused_arnoldi.STAGES * 4 * plan.stage_floats < plan.smem_bytes
    assert plan.tile_rows(0) == min(plan.rows, plan.threads)  # the first steps: one row a thread


@pytest.mark.parametrize(("n", "depth"), [(100, 7), (4_736, 12), (16_384, 250), (100_489, 90),
                                          (1_000_000, 90), (1 << 20, 30)])
@pytest.mark.parametrize("sms", [66, 114, 132])
def test_launch_plan_gives_at_most_one_block_an_sm(n, depth, sms):
    """One persistent, co-resident block an SM at most, covering n with
    contiguous rows, within the card's shared memory; scratch for the slab."""
    plan = _plan(n, depth, sms=sms)
    assert plan.blocks <= sms * 1 and plan.threads == fused_arnoldi.THREADS
    assert plan.block_threads <= fused_arnoldi.MAX_BLOCK_THREADS
    assert plan.blocks * plan.rows >= n > (plan.blocks - 1) * plan.rows
    assert plan.smem_bytes <= H100_SMEM
    assert plan.partial_floats == (2 * depth + 3) * -(-plan.blocks // 4) * 4  # slabs padded to 16 bytes


def test_launch_plan_refuses_what_the_kernel_cannot_run():
    """No silent re-planning: a depth outside [1, n], an unknown option and
    a card whose shared memory cannot hold a block's layout even with the
    coefficients in device memory (6,368 bytes at 512 threads) raise."""
    with pytest.raises(ValueError, match="no K9 plan"):
        _plan(16_384, 16_385)
    with pytest.raises(ValueError, match="no K9 plan"):
        _plan(16_384, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _plan(16_384, 90, smem=4_096)
    with pytest.raises(TypeError, match="Unexpected input"):
        _plan(16_384, 90, "junk")


@pytest.mark.parametrize(("n", "depth", "path"), [(9_216, 842, "streamed"), (9_216, 843, "direct"),
                                                  (9_216, 1_000, "direct"), (1_000_000, 8_000, "direct"),
                                                  (16_384, 16_384, "direct")])
def test_launch_plan_runs_any_depth(n, depth, path):
    """Past the depth whose deepest A tile would hold fewer than 32 rows
    (843 at five diagonals on an H100, the head sized by the diagonals)
    the plan takes the direct path: no
    producer, no staging buffers, the basis read from device memory a row a
    thread. No depth is refused. (9,216, 1,000) is [parity-arnoldi]'s deep
    case."""
    plan = _plan(n, depth)
    assert plan.path == path
    if path == "streamed":
        assert plan.tile_rows(depth - 1, "A") == fused_arnoldi.MIN_TILE
    else:
        assert plan.stage_floats == 0 and plan.block_threads == plan.threads
        assert all(plan.tile_rows(i, s) == min(plan.rows, plan.threads) for i in (0, depth - 1) for s in "AB")
    assert plan.smem_bytes <= H100_SMEM - fused_arnoldi.SMEM_RESERVE


@pytest.mark.parametrize(("n", "depth", "smem"), [(1_000_000, 30_000, H100_SMEM), (16_384, 16_384, 65_536),
                                                  (9_216, 1_000, 12_000)])
def test_launch_plan_keeps_the_coefficients_in_device_memory_where_they_do_not_fit(n, depth, smem):
    """The direct path's 2 x depth coefficients (240 KB at depth 30,000)
    go to device memory, a slice of 2 x padded depth floats a block, where
    they do not fit beside the rest of its layout: any depth <= n runs, as
    the JAX package's ``hessenberg`` does. (9,216, 1,000) with 12,000 bytes
    is [parity-arnoldi]'s case of this plan on the card."""
    plan = _plan(n, depth, smem=smem)
    padded = (depth + 4) // 4 * 4
    assert plan.path == "direct" and plan.coef_floats == 2 * padded * plan.blocks
    head = fused_arnoldi.head_floats(5) + plan.threads
    assert plan.smem_bytes == 4 * (head + 2 * plan.threads) <= smem - fused_arnoldi.SMEM_RESERVE
    assert 4 * (head + 2 * padded + 2 * plan.threads) > smem - fused_arnoldi.SMEM_RESERVE
    assert _plan(n, min(depth, 800)).coef_floats == 0  # shallower: in shared memory
