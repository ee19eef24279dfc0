"""The port's row-partitioned DIA operators (K11's module) against the JAX package.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``:
its ``ppermute`` operator ``parallel.sharded_dia_operator`` and its Pallas
halo kernel ``sharded_dia_operator_pallas`` in interpret mode, as its own
tests run it. The port's operators take the plain halo body on the CPU
(K11's plain version, through the same wrapper that launches K11 for a
CUDA tensor). The same numpy inputs go to both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu import parallel as jparallel  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu.parallel import pallas_halo as jpallas_halo  # noqa: E402
from lanczos_adjoints_tpu_torch import parallel  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_dia, native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.parallel import fused_halo  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

N = 16_384
H100_SMS = 132
# The JAX halo tests' tolerances (tests/test_parallel/test_pallas_halo.py).
TOL_VALUE, TOL_GRAD = 1e-5, 1e-4

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def _operator(n, offsets):
    """(JAX DIAData, port DIAData, float32 values as numpy) of the JAX test's operator."""
    mat = test_util.banded_symmetric(n, offsets)
    dia_j = jsparse.dia_pack(mat)
    vals = np.asarray(jsparse.dia_values(dia_j, mat.data), dtype=np.float32)
    dia_t, _ = sparse.dia_from_jax(dia_j, vals, device="cpu")
    return dia_j, dia_t, vals


def _jax_sharded(mesh, v, vals):
    return jparallel.shard_rows(jnp.asarray(v), mesh), jparallel.shard_rows(jnp.asarray(vals), mesh, dim=1)


def _port_operators(dia_t, mesh_t):
    return {
        "ppermute": parallel.sharded_dia_operator(dia_t, mesh_t),
        "fused": parallel.sharded_dia_operator_fused(dia_t, mesh_t),
    }


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-130, -1, 0, 1, 130)])
def test_operators_match_the_jax_ppermute_and_pallas_halo(offsets):
    dia_j, dia_t, vals = _operator(N, offsets)
    mesh_j = jparallel.device_mesh(8)
    v = np.random.default_rng(0).normal(size=N).astype(np.float32)
    args_j = _jax_sharded(mesh_j, v, vals)
    want = {
        "ppermute": np.asarray(jparallel.sharded_dia_operator(dia_j, mesh_j)(*args_j)),
        "pallas": np.asarray(jpallas_halo.sharded_dia_operator_pallas(dia_j, mesh_j, interpret=True)(*args_j)),
    }
    mesh_t = parallel.device_mesh(8, device="cpu")
    for name, op in _port_operators(dia_t, mesh_t).items():
        got = op(torch.tensor(v), torch.tensor(vals)).numpy()
        for ref, w in want.items():
            np.testing.assert_allclose(got, w, atol=TOL_VALUE, rtol=0, err_msg=f"{name} vs {ref}")


def test_gradients_match_jax_grad_through_both_operators():
    offsets = (-128, -1, 0, 1, 128)
    dia_j, dia_t, vals = _operator(N, offsets)
    mesh_j = jparallel.device_mesh(8)
    v = np.random.default_rng(1).normal(size=N).astype(np.float32)
    u = np.random.default_rng(2).normal(size=N).astype(np.float32)
    args_j = _jax_sharded(mesh_j, v, vals)
    want = {}
    for name, op in (("ppermute", jparallel.sharded_dia_operator(dia_j, mesh_j)),
                     ("pallas", jpallas_halo.sharded_dia_operator_pallas(dia_j, mesh_j, interpret=True))):
        grads = jax.grad(lambda vv, vl, op=op: jnp.sum(jnp.asarray(u) * op(vv, vl)), argnums=(0, 1))(*args_j)
        want[name] = [np.asarray(g) for g in grads]
    mesh_t = parallel.device_mesh(8, device="cpu")
    for name, op in _port_operators(dia_t, mesh_t).items():
        args = [torch.tensor(v, requires_grad=True), torch.tensor(vals, requires_grad=True)]
        got = torch.autograd.grad(op(*args), args, torch.tensor(u))
        for ref, w in want.items():
            for g, wg, what in zip(got, w, ("dv", "dvals")):
                np.testing.assert_allclose(g.numpy(), wg, atol=TOL_GRAD, rtol=0,
                                           err_msg=f"{what}: {name} vs {ref}")


# Operators the JAX package computes and K11 once refused on the card: 65
# and 100 diagonals (the DIA kernels took at most 64), and a halo wider
# than half the local rows (n = 1,000 over 8 partitions, halo 63 of 125
# rows: the first and last 63 rows of a partition overlap), up to all of
# them (n = 1,040 over 8, halo 130 of 130 rows).
WIDE_CASES = [(2048, tuple(range(-32, 33))),
              (2048, tuple(3 * k for k in range(-50, 51) if k)),
              (1000, (-63, 0, 63)),
              (1000, (-63, -62, -1, 0, 1, 62, 63)),
              (1040, (-130, -1, 0, 1, 130))]


@pytest.mark.parametrize(("n", "offsets"), WIDE_CASES,
                         ids=["65 diagonals", "100 diagonals", "halo 63 of 125 rows", "halo 63, 7 diagonals",
                              "halo 130 of 130 rows"])
def test_many_diagonals_and_wide_halos_match_the_jax_ppermute_operator(monkeypatch, n, offsets):
    """The port's operator on the card's route (K11's wrapper, its plain
    version on CPU tensors) and its gradients against the JAX ppermute
    operator, which takes any number of diagonals and any halo <= local rows."""
    _hold_to_the_jax_ppermute_operator(monkeypatch, n, offsets, 8)


@pytest.mark.parametrize(("n", "n_partitions"), [(N, 1), (N, 2), (4098, 3)])
def test_the_card_route_matches_the_jax_ppermute_operator_on_p_partitions(monkeypatch, n, n_partitions):
    """As above on 1, 2 and 3 of the 8 virtual devices; 4,098 rows over 3
    partitions leave 1,366 local rows, not a multiple of 4 (K11's path of
    1 row a thread on the card)."""
    _hold_to_the_jax_ppermute_operator(monkeypatch, n, (-130, -7, 0, 7, 130), n_partitions)


def _hold_to_the_jax_ppermute_operator(monkeypatch, n, offsets, n_partitions):
    dia_j, dia_t, vals = _operator(n, offsets)
    assert len(dia_t.offsets) == len(offsets)
    mesh_j = jparallel.device_mesh(n_partitions)
    rng = np.random.default_rng(4)
    v, u = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    args_j = _jax_sharded(mesh_j, v, vals)
    op_j = jparallel.sharded_dia_operator(dia_j, mesh_j)
    want = np.asarray(jax.jit(op_j)(*args_j))  # compiled: eager dispatch of D rolls is slow
    grads_j = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda vv, vl: jnp.sum(jnp.asarray(u) * op_j(vv, vl)), argnums=(0, 1)))(*args_j)]
    monkeypatch.setattr(native, "on_card", lambda device: True)
    op = parallel.sharded_dia_operator(dia_t, parallel.device_mesh(n_partitions, device="cpu"))
    args = [torch.tensor(v, requires_grad=True), torch.tensor(vals, requires_grad=True)]
    out = op(*args)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL_VALUE, rtol=0)
    for g, wg in zip(torch.autograd.grad(out, args, torch.tensor(u)), grads_j):
        np.testing.assert_allclose(g.numpy(), wg, atol=TOL_GRAD, rtol=0)


@pytest.mark.parametrize("n_partitions", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-130, -7, 0, 7, 130), (-1024, -1, 0, 1, 1024)])
def test_plain_halo_equals_the_unsharded_dia_matvec_exactly(n_partitions, offsets):
    """The same products summed in the same order (k = 0 .. D - 1 from
    zero), so bit for bit; random values in every slot, the wrapped ones
    too. n is N or the nearest multiple of P below it (5,461 local rows
    over 3 partitions, not a multiple of 4), and at least P x halo
    (64 x 1,024 rows: every row an edge row)."""
    n = n_partitions * max(N // n_partitions, fused_halo.halo_width(offsets))
    rng = np.random.default_rng(4)
    v, u = (torch.tensor(rng.standard_normal(n), dtype=torch.float32) for _ in range(2))
    vals = torch.tensor(rng.standard_normal((len(offsets), n)), dtype=torch.float32)
    want = fused_dia.dia_matvec_plain(offsets, v, vals)
    assert torch.equal(fused_halo.halo_dia_plain(offsets, v, vals, n_partitions), want)
    assert torch.equal(fused_halo.halo_dia_rows(offsets, v, vals, n_partitions), want)
    # One allocation per partition, as K11 takes them on the card.
    parts = fused_halo.halo_dia_parts(
        offsets, [c.clone() for c in v.chunk(n_partitions)],
        [c.contiguous() for c in vals.chunk(n_partitions, dim=1)],
    )
    assert torch.equal(torch.cat(parts), want)
    assert torch.equal(fused_halo.halo_dvals_plain(offsets, v, u, n_partitions),
                       fused_dia.dia_dvals_plain(offsets, v, u))
    # Summed with fused multiply-adds (K4's and K11's rounding on the card):
    # the same sums within a rounding a term.
    fused = fused_halo.halo_dia_plain(offsets, v, vals, n_partitions, fused=True)
    torch.testing.assert_close(fused, want, rtol=0, atol=4e-7 * len(offsets) * float(want.abs().max()))


def test_nonsymmetric_values_keep_each_operators_vjp():
    """``sharded_dia_operator`` gives the true transpose product for ``dv``
    (the JAX ppermute operator's autodiff), off the card by autograd and
    on it by K11 on the transposed operator; ``sharded_dia_operator_fused``
    keeps the JAX Pallas VJP, ``dv = A u``."""
    offsets = (-130, -7, 0, 7, 130)
    dia_j, dia_t, _ = _operator(N, offsets)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((len(offsets), N)).astype(np.float32)
    v, u = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    mesh_j = jparallel.device_mesh(8)
    args_j = _jax_sharded(mesh_j, v, vals)
    op_j = jparallel.sharded_dia_operator(dia_j, mesh_j)
    dv_j, dvals_j = (np.asarray(g) for g in jax.grad(
        lambda vv, vl: jnp.sum(jnp.asarray(u) * op_j(vv, vl)), argnums=(0, 1))(*args_j))
    mesh_t = parallel.device_mesh(8, device="cpu")
    transposed = fused_halo.sharded_dia_operator_fused(dia_t, mesh_t, check_tiling=False, symmetric=False)
    for op in (parallel.sharded_dia_operator(dia_t, mesh_t), transposed):
        args = [torch.tensor(v, requires_grad=True), torch.tensor(vals, requires_grad=True)]
        dv, dvals = torch.autograd.grad(op(*args), args, torch.tensor(u))
        np.testing.assert_allclose(dv.numpy(), dv_j, atol=TOL_GRAD, rtol=0)
        np.testing.assert_allclose(dvals.numpy(), dvals_j, atol=TOL_GRAD, rtol=0)
    symmetric = parallel.sharded_dia_operator_fused(dia_t, mesh_t)
    args = [torch.tensor(v, requires_grad=True), torch.tensor(vals)]
    (dv,) = torch.autograd.grad(symmetric(*args), args[:1], torch.tensor(u))
    assert torch.equal(dv, fused_dia.dia_matvec_plain(offsets, torch.tensor(u), torch.tensor(vals)))


def test_every_jax_error_has_its_counterpart():
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    cases = [
        # (n, offsets, factory, match): n % P, halo > local_n, the fused
        # kernel's tiling (n % (P x 1024)), halo rows against local rows.
        (1001, (-1, 0, 1), "sharded_dia_operator", "divide evenly"),
        (64, (-9, 0, 9), "sharded_dia_operator", "exceeds local rows"),
        (1024, (-1, 0, 1), "sharded_dia_operator_pallas", "divide into"),
        (8192, (-130, 0, 130), "sharded_dia_operator_pallas", "halo rows"),
    ]
    for n, offsets, factory, match in cases:
        dia_j, dia_t, _ = _operator(n, offsets)
        jbuild = getattr(jparallel, factory, None) or getattr(jpallas_halo, factory)
        tbuild = (parallel.sharded_dia_operator if factory == "sharded_dia_operator"
                  else parallel.sharded_dia_operator_fused)
        with pytest.raises(ValueError, match=match):
            jbuild(dia_j, mesh_j)
        with pytest.raises(ValueError, match=match):
            tbuild(dia_t, mesh_t)
    # Without the JAX tiling rule K11 takes any n % P == 0 with
    # halo <= local rows (the JAX ppermute operator's rule), and refuses
    # the rest.
    _dj, dia_t, vals = _operator(1000, (-60, 0, 60))
    op = parallel.sharded_dia_operator_fused(dia_t, mesh_t, check_tiling=False)
    assert op(torch.ones(1000), torch.tensor(vals)).shape == (1000,)
    _dj, dia_t, _ = _operator(1000, (-126, 0, 126))
    with pytest.raises(ValueError, match="exceeds local rows"):
        parallel.sharded_dia_operator_fused(dia_t, mesh_t, check_tiling=False)
    with pytest.raises(ValueError, match="divide evenly"):
        parallel.sharded_dia_operator_fused(_operator(1001, (-1, 0, 1))[1], mesh_t, check_tiling=False)
    with pytest.raises(TypeError, match="float32"):
        fused_halo.halo_dia_rows((-1, 0, 1), torch.ones(1024).double(), torch.ones(3, 1024).double(), 8)
    with pytest.raises(ValueError, match="exceeds local rows"):
        fused_halo.halo_dia_rows((-2, 0, 2), torch.ones(8), torch.ones(3, 8), 8)
    with pytest.raises(ValueError, match="partitions"):
        fused_halo.halo_dia_rows((-1, 0, 1), torch.ones(1040), torch.ones(3, 1040), native.MAX_PARTITIONS + 1)
    with pytest.raises(ValueError, match="value blocks"):
        fused_halo.halo_dia_parts((-1, 0, 1), [torch.ones(8)] * 2, [torch.ones(3, 8)])


@pytest.fixture
def _on_card(monkeypatch):
    """The card's dispatch on CPU tensors, with every K11 wrapper call logged."""
    monkeypatch.setattr(native, "on_card", lambda device: True)
    calls = []
    wrapped = fused_halo.halo_dia_rows

    def spy(offsets, v, vals, n_partitions, *, kernel=fused_halo.HALO_DIA):
        calls.append(kernel.name)
        return wrapped(offsets, v, vals, n_partitions, kernel=kernel)

    monkeypatch.setattr(fused_halo, "halo_dia_rows", spy)
    return calls


def test_on_the_card_the_sharded_operator_takes_k11_and_tridiag_stays_generic(_on_card):
    depth, offsets = 10, (-128, -1, 0, 1, 128)
    mat = test_util.five_diagonal(N, 128)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device="cpu")
    matvec = parallel.sharded_dia_operator(dia, parallel.device_mesh(8, device="cpu"))
    assert dia.offsets == offsets and not hasattr(matvec, "dia_data")
    log = []
    estimate = lanczos.tridiag(matvec, depth, reortho="none", dispatch_log=log)
    args = [torch.ones(N, requires_grad=True), vals.clone().requires_grad_()]
    (xs, (alphas, betas)), (x_res, beta_res) = estimate(*args)
    outs = [xs, alphas, betas, x_res, beta_res]
    dv, dvals = torch.autograd.grad(outs, args, [torch.ones_like(o) for o in outs])
    assert log == ["tridiag:generic"]
    # K forward products and K adjoint products A lambda; the adjoint
    # never asks for the matvec's dv, so no transposed launch.
    assert _on_card.count("halo_dia_matvec") == 2 * depth
    assert "halo_dia_matvec_transposed" not in _on_card
    assert bool(torch.isfinite(dv).all()) and bool(torch.isfinite(dvals).all())
    # A dv of the matvec itself goes through K11 on the transpose.
    del _on_card[:]
    v = torch.ones(N, requires_grad=True)
    torch.autograd.grad(matvec(v, vals), [v], torch.ones(N))
    assert _on_card == ["halo_dia_matvec", "halo_dia_matvec_transposed"]


@pytest.mark.parametrize(("n", "n_partitions", "vector", "max_blocks"), [
    (1 << 20, 8, True, 132),  # the slice's operator: 131,072 rows a partition
    (1 << 20, 1, True, 1056),
    (1 << 20, 64, True, 16),
    (1_000_000, 64, False, 16),  # 15,625 local rows
    (1000, 8, False, 132),  # 125 local rows
    (16_383, 3, False, 352),
])
def test_plan_takes_4_rows_a_thread_where_the_local_rows_allow(n, n_partitions, vector, max_blocks):
    """4 rows a thread (float4 values and output) where local_n % 4 == 0;
    at most one wave of the card's 8 x 132 block slots over all partitions."""
    plan = fused_halo.halo_plan((-1, 0, 1), n, n_partitions, H100_SMS)
    assert plan.local_n == n // n_partitions and plan.halo == 1
    assert plan.vector is vector and plan.max_blocks == max_blocks
    assert plan.rows(n, 0, 512) == (4 if vector else 1)


def test_plan_takes_1_row_a_thread_on_misaligned_operands():
    """A launch on the vector path needs every pointer it reads or writes by
    float4 (the values and the output) 16-byte aligned and a row stride
    that is a multiple of 4."""
    plan = fused_halo.halo_plan((-130, 0, 130), 1 << 20, 8, H100_SMS)
    assert plan.rows(1 << 20, 1024, 2048, 4096) == 4
    assert plan.rows(1 << 20, 1028, 2048) == 1  # values offset by one float
    assert plan.rows(1 << 20, 1024, 2056) == 1  # output offset by two floats
    assert plan.rows((1 << 20) + 2, 1024, 2048) == 1  # a row stride of 2 mod 4
    # Views offset by one float take 1 row a thread; the CPU runs the
    # plain version all the same.
    v, vals = torch.ones(1 << 20), torch.ones(3, 1 << 20)
    shifted = torch.empty(vals.numel() + 1)[1:].view(vals.shape).copy_(vals)
    assert plan.rows(1 << 20, shifted.data_ptr()) == 1
    assert torch.equal(fused_halo.halo_dia_rows((-130, 0, 130), v, shifted, 8),
                       fused_halo.halo_dia_rows((-130, 0, 130), v, vals, 8))


@pytest.mark.parametrize(("offsets", "n", "n_partitions", "match"), [
    ((-1, 0, 1), 1024, 0, "partitions"),
    ((-1, 0, 1), 65 * 16, native.MAX_PARTITIONS + 1, "partitions"),
    ((-1, 0, 1), 1001, 8, "divide evenly"),
    ((-126, 0, 126), 1000, 8, "exceeds local rows"),
    ((), 1024, 8, "at least one diagonal"),
])
def test_plan_refuses_what_k11_does_not_take(offsets, n, n_partitions, match):
    with pytest.raises(ValueError, match=match):
        fused_halo.halo_plan(offsets, n, n_partitions, H100_SMS)
