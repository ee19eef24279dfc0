"""The port's multi-device layer and its DIA Lanczos slice against the JAX package.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``;
the port's mesh is 8 partitions on the CPU. The slice is the measured path
of ``experiments/benchmarks/multihost_scaling/benchmark.py``: the
5-diagonal operator through the sharded DIA operator under
``tridiag(reortho="none")``, one forward + VJP with the all-ones
cotangent, held in float64 (scoped ``jax.enable_x64``) and float32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from lanczos_adjoints_tpu import krylov as jkrylov  # noqa: E402
from lanczos_adjoints_tpu import parallel as jparallel  # noqa: E402
from lanczos_adjoints_tpu.models import gp as jgp  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch import parallel  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.models import gp  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import gram, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

# The JAX sharded-policy tests' tolerance (test_sharded_gram_policy.py).
TOL_GRAM = 1e-5
# float64: the same recursion in another summation order, amplified by
# the depth; float32: the port's Lanczos parity tolerances
# (tests/test_torch_lanczos_dia.py: 1e-4 values, 1e-3 relative gradients).
TOL64, TOL32_VALUE, TOL32_GRAD = 1e-10, 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


def test_meshes_hold_the_jax_shape_and_refuse_distinct_cards():
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    assert dict(mesh_j.shape) == mesh_t.shape == {"rows": 8}
    assert mesh_t.size == 8 and mesh_t.device == torch.device("cpu")
    grid = parallel.make_mesh({"rows": 4, "probes": 2}, device="cpu")
    assert grid.shape == {"rows": 4, "probes": 2} and grid.axis_names == ("rows", "probes")
    assert parallel.NamedSharding(grid, "probes").size == 2
    assert parallel.device_mesh(2, device=["cpu", "cpu"]).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        parallel.device_mesh(2, device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="positive"):
        parallel.device_mesh(0, device="cpu")


def test_shard_rows_and_replicate_place_the_whole_tensor():
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    a = np.arange(5 * 16, dtype=np.float32).reshape(5, 16)
    got = parallel.shard_rows(torch.tensor(a), mesh_t, dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jparallel.shard_rows(jnp.asarray(a), mesh_j, dim=1)))
    np.testing.assert_array_equal(parallel.replicate(torch.tensor(a), mesh_t).numpy(),
                                  np.asarray(jparallel.replicate(jnp.asarray(a), mesh_j)))
    with pytest.raises(ValueError, match="divide evenly"):
        parallel.shard_rows(torch.tensor(a), mesh_t, dim=0)
    with pytest.raises(ValueError):
        jparallel.shard_rows(jnp.asarray(a), mesh_j, dim=0)


def test_sharded_dense_operator_matches_jax():
    rng = np.random.default_rng(0)
    matrix, v = rng.standard_normal((64, 48)).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    want = jparallel.sharded_dense_operator(mesh_j)(
        jparallel.replicate(jnp.asarray(v), mesh_j), jparallel.shard_rows(jnp.asarray(matrix), mesh_j))
    got = parallel.sharded_dense_operator(mesh_t)(torch.tensor(v), torch.tensor(matrix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_GRAM, rtol=TOL_GRAM)
    with pytest.raises(ValueError, match="divide evenly"):
        parallel.sharded_dense_operator(mesh_t)(torch.tensor(v), torch.tensor(matrix[:63]))


def _kernels(n=64, d=3, seed=0):
    """Both packages' scaled Matern-3/2 kernels at the same raw parameters, and data."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    raw_ell, raw_out = np.full((d,), 0.3, np.float32), np.float32(0.5)
    param_j, _ = jgp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
    param_t, _ = gp.kernel_scaled_matern_32(shape_in=(d,), shape_out=())
    kernel_j = param_j(raw_lengthscale=jnp.asarray(raw_ell), raw_outputscale=jnp.asarray(raw_out))
    raw_t = (torch.tensor(raw_ell), torch.tensor(raw_out))
    kernel_t = param_t(raw_lengthscale=raw_t[0], raw_outputscale=raw_t[1])
    return kernel_j, kernel_t, raw_t, x, v


def test_sharded_gram_matvec_matches_jax():
    kernel_j, kernel_t, raw_t, x, v = _kernels()
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    want = jparallel.sharded_gram_matvec(kernel_j, mesh_j)(jnp.asarray(x), jnp.asarray(x), jnp.asarray(v[:, 0]))
    got = parallel.sharded_gram_matvec(kernel_t, mesh_t)(torch.tensor(x), torch.tensor(x),
                                                         torch.tensor(v[:, 0]), *raw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_GRAM, rtol=TOL_GRAM)


@pytest.mark.parametrize("n", [64, 63])
def test_sharded_gram_policy_matches_jax_single_and_multi_rhs(n):
    """63 rows do not divide by 8: both packages run the base policy unsharded."""
    kernel_j, kernel_t, raw_t, x, v = _kernels(n=n)
    mesh_j, mesh_t = jparallel.device_mesh(8), parallel.device_mesh(8, device="cpu")
    policy_j = jparallel.sharded_gram_policy(jgp.gram_matvec(), mesh_j)(kernel_j)
    policy_t = parallel.sharded_gram_policy(gram.gram_matvec(), mesh_t)(kernel_t)
    for rhs in (v[:, 0], v):
        want = policy_j(jnp.asarray(x), jnp.asarray(x), jnp.asarray(rhs))
        got = policy_t(torch.tensor(x), torch.tensor(x), torch.tensor(rhs), *raw_t)
        assert got.shape == rhs.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_GRAM, rtol=TOL_GRAM)


def test_sharded_gram_policy_gradients_match_the_unsharded_policy():
    _kj, kernel_t, raw_t, x, v = _kernels()
    mesh_t = parallel.device_mesh(8, device="cpu")
    grads = []
    for policy in (gram.gram_matvec(), parallel.sharded_gram_policy(gram.gram_matvec(), mesh_t)):
        raw = [r.clone().requires_grad_() for r in raw_t]
        rhs = torch.tensor(v[:, 0])
        grads.append(torch.autograd.grad(rhs @ policy(kernel_t)(torch.tensor(x), torch.tensor(x), rhs, *raw), raw))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The DIA slice: multihost_scaling's measured path at a test size
# ---------------------------------------------------------------------------

N, BANDWIDTH, DEPTH = 16_384, 128, 10


def _jax_one_vjp(dia_j, values, dtype):
    """``measured_virtual_mesh``'s ``one_vjp`` (benchmark.py:316-320) on its 8-device mesh."""
    mesh = jparallel.device_mesh(8)
    matvec = jparallel.sharded_dia_operator(dia_j, mesh)
    factorise = jkrylov.tridiag(lambda v, vals: matvec(v, vals), DEPTH, reortho="none")
    v0 = jparallel.shard_rows(jnp.ones((N,), dtype), mesh)
    vals = jparallel.shard_rows(jnp.asarray(values, dtype), mesh, dim=1)
    out, vjp = jax.vjp(factorise, v0, vals)
    flat, unflatten = ravel_pytree(out)
    dv, dvals = vjp(unflatten(jnp.ones_like(flat)))
    return np.asarray(dv), np.asarray(dvals), np.asarray(out[0][1][0])


def _port_one_vjp(dia_t, values, dtype):
    matvec = parallel.sharded_dia_operator(dia_t, parallel.device_mesh(8, device="cpu"))
    log = []
    factorise = lanczos.tridiag(matvec, DEPTH, reortho="none", dispatch_log=log)
    args = [torch.ones(N, dtype=dtype, requires_grad=True),
            torch.tensor(values, dtype=dtype, requires_grad=True)]
    (xs, (alphas, betas)), (x_res, beta_res) = factorise(*args)
    outs = [xs, alphas, betas, x_res, beta_res]
    dv, dvals = torch.autograd.grad(outs, args, [torch.ones_like(o) for o in outs])
    assert log == ["tridiag:generic"]
    return dv.numpy(), dvals.numpy(), alphas.detach().numpy()


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_sharded_lanczos_vjp_matches_the_jax_multi_device_slice(precision):
    mat = test_util.five_diagonal(N, BANDWIDTH)
    dia_j = jsparse.dia_pack(mat)
    values = np.asarray(jsparse.dia_values(dia_j, mat.data))
    dia_t, _ = sparse.dia_from_jax(dia_j, values, device="cpu")
    assert dia_t.offsets == (-BANDWIDTH, -1, 0, 1, BANDWIDTH)
    if precision == "float64":
        with jax.enable_x64(True):
            want = _jax_one_vjp(dia_j, values, jnp.float64)
        got = _port_one_vjp(dia_t, values, torch.float64)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL64 * np.max(np.abs(w)), rtol=0)
        return
    want = _jax_one_vjp(dia_j, values, jnp.float32)
    got = _port_one_vjp(dia_t, values, torch.float32)
    np.testing.assert_allclose(got[2], want[2], atol=TOL32_VALUE, rtol=TOL32_VALUE)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=TOL32_GRAD * np.max(np.abs(w)), rtol=0)
