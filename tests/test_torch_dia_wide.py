"""Operators of more than 64 diagonals through the port's card routes
against the JAX package, which builds and computes a DIA operator of any
number of diagonals (``sparse_operator``; ``dia_max_diags`` only steers
``format="auto"``).

The port's dispatch predicate is made to hold on the CPU, so each entry
point takes the route it takes on the card: the DIA matvec (K4, K5), the
fused Lanczos forward and adjoint (K6, K7) under ``tridiag`` and the fused
Arnoldi forward (K9) under ``hessenberg``, each kernel through its plain
version on CPU tensors. The JAX side runs its own route on the CPU (the
roll matvec under the generic recursions). Same numpy inputs on both
sides; the tolerances are the JAX package's fused tests': 1e-5 for the
matvec, 1e-4 for Krylov values and 1e-3 (Lanczos) or 1e-4 (Arnoldi,
re-orthogonalised) relative for their gradients.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.krylov import arnoldi as jarnoldi  # noqa: E402
from lanczos_adjoints_tpu.krylov import lanczos as jlanczos  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import native, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

N = 512
# 65 diagonals, a band; 100, spread over +-150 without the main diagonal.
OFFSETS = {"65 diagonals": tuple(range(-32, 33)), "100 diagonals": tuple(3 * k for k in range(-50, 51) if k)}


@pytest.fixture(autouse=True)
def _card_route(monkeypatch):
    pin_float32()
    monkeypatch.setattr(native, "on_card", lambda device: True)


def _operators(offsets):
    """``(JAX matvec, JAX values, port matvec, port values)`` of one banded
    symmetric operator, both built by ``sparse_operator(format="auto")``
    with ``dia_max_diags`` above its diagonals."""
    mat = test_util.banded_symmetric(N, offsets)
    mat_j = jsparse.csr_from_coo(mat.rows, mat.indices, mat.data.astype(np.float32), shape=mat.shape)
    mv_j, vals_j = jsparse.sparse_operator(mat_j, format="auto", dia_max_diags=128)
    mv_t, vals_t = sparse.sparse_operator(mat, format="auto", dia_max_diags=128, device="cpu")
    assert mv_t.dia_data.offsets == tuple(sorted(offsets)) and vals_t.shape == (len(offsets), N)
    return mv_j, vals_j, mv_t, vals_t


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)


def _jax_vjp(fn, v, vals, cot):
    out, vjp = jax.vjp(jax.jit(fn), jnp.asarray(v), vals)  # compiled: eager dispatch of D rolls is slow
    leaves, tree = jax.tree_util.tree_flatten(out)
    grads = vjp(jax.tree_util.tree_unflatten(tree, [jnp.asarray(c, l.dtype) for c, l in zip(cot, leaves)]))
    return [np.asarray(leaf) for leaf in leaves], [np.asarray(g) for g in grads]


def _torch_vjp(fn, v, vals, cot):
    args = [torch.tensor(v, requires_grad=True), vals.clone().requires_grad_()]
    leaves = _leaves(fn(*args))
    grads = torch.autograd.grad(leaves, args, [torch.tensor(c, dtype=t.dtype) for c, t in zip(cot, leaves)])
    return [t.detach().numpy() for t in leaves], [g.numpy() for g in grads]


def _leaves(out):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _cotangent(leaves, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(np.shape(leaf)).astype(np.float32) for leaf in leaves]


@pytest.mark.parametrize("case", OFFSETS)
def test_dia_matvec_and_its_vjp_take_any_number_of_diagonals(case):
    mv_j, vals_j, mv_t, vals_t = _operators(OFFSETS[case])
    rng = np.random.default_rng(1)
    v, u = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    out_j, grads_j = _jax_vjp(mv_j, v, vals_j, [u])
    out_t, grads_t = _torch_vjp(mv_t, v, vals_t, [u])
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-5, rtol=0)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", OFFSETS)
def test_tridiag_and_its_vjp_take_any_number_of_diagonals(case):
    """On the card's route ``tridiag`` runs K6 and K7 (through their plain
    versions here): the dispatch log says so."""
    depth = 12
    mv_j, vals_j, mv_t, vals_t = _operators(OFFSETS[case])
    v = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    log = []
    est_j = jlanczos.tridiag(mv_j, depth, reortho="none")
    cot = _cotangent(jax.tree_util.tree_leaves(jax.jit(est_j)(jnp.asarray(v), vals_j)), 3)
    out_j, grads_j = _jax_vjp(est_j, v, vals_j, cot)
    out_t, grads_t = _torch_vjp(lanczos.tridiag(mv_t, depth, reortho="none", dispatch_log=log), v, vals_t, cot)
    assert log == ["tridiag:dia_fused"]
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads_t, grads_j):
        assert _rel(got, want) < 1e-3


@pytest.mark.parametrize("case", OFFSETS)
def test_hessenberg_and_its_vjp_take_any_number_of_diagonals(case):
    """On the card's route ``hessenberg`` runs K9 (through its plain version
    here) and the closed-form adjoint over the transposed K4 and K5."""
    depth = 10
    mv_j, vals_j, mv_t, vals_t = _operators(OFFSETS[case])
    v = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    log = []
    est_j = jarnoldi.hessenberg(mv_j, depth, reortho="full")
    cot = _cotangent(jax.tree_util.tree_leaves(jax.jit(est_j)(jnp.asarray(v), vals_j)), 5)
    out_j, grads_j = _jax_vjp(est_j, v, vals_j, cot)
    est_t = arnoldi.hessenberg(mv_t, depth, reortho="full", dispatch_log=log)
    out_t, grads_t = _torch_vjp(est_t, v, vals_t, cot)
    assert log == ["hessenberg:dia_fused"]
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads_t, grads_j):
        assert _rel(got, want) < 1e-4
