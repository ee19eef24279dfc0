"""Wave/heat PDE toolkit with Arnoldi matrix exponentials.

Counterpart of ``lanczos_adjoints_tpu/models/pde.py``: tensor-product
meshes and stencils, initial conditions, parametrised heat and wave
right-hand sides, boundary paddings, MSE losses, the explicit Euler and
matrix-exponential solvers (Arnoldi, with the closed-form adjoint of
``krylov.arnoldi``, and a dense reference), the mesh MLP and the Lanczos
Gaussian-random-field sampler.

The stencil right-hand side is a convolution (``F.conv2d`` with the
flipped stencil, as the JAX package lowers it through
``lax.conv_general_dilated``); it carries no DIA tag, so the Arnoldi
solver runs the generic loop over it, on the card as in the JAX package.
``expm_arnoldi`` takes the small ``K x K`` exponential from
``torch.linalg.matrix_exp``, a different algorithm than
``jax.scipy.linalg.expm``'s Pade 13: the two agree to float32 rounding
on the small, well-scaled matrices here. The diffrax solver is not
ported (diffrax is a JAX library).
"""

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lanczos_adjoints_tpu_torch.krylov import arnoldi, lanczos
from lanczos_adjoints_tpu_torch.utils.precision import requires_float32


def mesh_tensorproduct(x, y, /):
    return torch.stack(torch.meshgrid(x, y, indexing="xy"))


def stencil_laplacian(dx, *, dtype=None, device=None):
    """Standard 5-point 2-D Laplacian stencil (the ``-4`` centre).

    The JAX package's deliberate divergence from the reference, whose
    ``-2`` centre adds a spurious zeroth-order term; see
    ``stencil_laplacian_reference``.
    """
    stencil = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], dtype=dtype, device=device)
    return stencil / dx**2


def stencil_laplacian_reference(dx):
    """The reference's (-2)-centred stencil, kept for parity experiments."""
    stencil = torch.tensor([[0.0, 1.0, 0.0], [1.0, -2.0, 1.0], [0.0, 1.0, 0.0]])
    return stencil / dx**2


def stencil_advection_diffusion(dx):
    diffusion = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    advection = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, -1.0], [0.0, -1.0, 0.0]])
    return diffusion / dx**2 + advection / (2 * dx)


def mesh_and_stencil(resolution, *, dtype=torch.float32, device="cuda"):
    """The unit square's ``(2, n, n)`` mesh at ``resolution`` points a side and
    its Laplacian stencil, as the PDE scripts build them."""
    xs_1d = torch.linspace(0.0, 1.0, resolution, dtype=dtype, device=device)
    mesh = mesh_tensorproduct(xs_1d, xs_1d)
    return mesh, stencil_laplacian(float(xs_1d[1] - xs_1d[0]), dtype=dtype, device=device)


def _conv2d_valid(stencil, x):
    """2-D valid convolution of ``x`` with ``stencil`` (``convolve2d(stencil, x, "valid")``)
    over the last two axes; leading axes are a batch, one ``conv2d`` for all.

    ``F.conv2d`` cross-correlates, so it takes the flipped stencil, as
    the JAX package's ``lax.conv_general_dilated`` does.
    """
    kernel = torch.flip(stencil, (0, 1)).to(dtype=x.dtype, device=x.device)
    out = F.conv2d(x.reshape(-1, 1, *x.shape[-2:]), kernel[None, None])
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


# ---------------------------------------------------------------------------
# Initial conditions
# ---------------------------------------------------------------------------


def pde_init_bell(c, /):
    def parametrize(*, center_logits):
        center = torch.sigmoid(center_logits)

        def fun(x, /):
            if x.ndim != 3 or x.shape[0] != 2:
                raise ValueError(f"expected a (2, n, n) mesh, got {tuple(x.shape)}")
            diff = x - center[:, None, None]
            return torch.exp(-(c**2) * torch.sum(diff * diff, dim=0))

        return fun

    # A shape template, as the JAX package's ``jnp.empty``: it holds no values.
    return parametrize, {"center_logits": torch.empty((2,), device="meta")}


def pde_init_sine():
    def parametrize(*, scale_sin, scale_cos):
        def fun(x, /):
            if x.ndim != 3 or x.shape[0] != 2:
                raise ValueError(f"expected a (2, n, n) mesh, got {tuple(x.shape)}")
            return torch.sin(scale_sin * x[0]) * torch.cos(scale_cos * x[1])

        return fun

    return parametrize, {"scale_sin": 5.0, "scale_cos": 3.0}


# ---------------------------------------------------------------------------
# Right-hand sides
# ---------------------------------------------------------------------------


def _check_square(x, ndim):
    """An ``(n, n)`` field (``ndim == 2``), or a ``(2, n, n)`` state or a batch
    ``(..., 2, n, n)`` of them (``ndim == 3``)."""
    ok = x.ndim == 2 if ndim == 2 else (x.ndim >= 3 and x.shape[-3] == 2)
    if not ok or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"unexpected state shape {tuple(x.shape)}")


def pde_heat(c: float, /, stencil, *, boundary: Callable):
    def parametrize():
        def rhs(x, /):
            _check_square(x, 2)
            return c * _conv2d_valid(stencil, boundary(x))

        return rhs

    return parametrize, {}


def pde_heat_affine(c: float, drift_like, /, stencil, *, boundary: Callable):
    def parametrize(*, drift):
        def rhs(x, /):
            _check_square(x, 2)
            return c * _conv2d_valid(stencil, boundary(x)) + drift

        return rhs

    return parametrize, {"drift": torch.empty_like(drift_like)}


def pde_heat_anisotropic(scale_like, /, stencil, *, constrain, boundary: Callable):
    def parametrize(*, scale):
        scale_constrained = constrain(scale)

        def rhs(x, /):
            _check_square(x, 3)
            u, du = x.unbind(-3)
            u_new = -_conv2d_valid(stencil, boundary(u)) * scale_constrained
            return torch.stack([u_new, du], dim=-3)

        return rhs

    return parametrize, {"scale": torch.empty_like(scale_like)}


def pde_wave_anisotropic(scale_like, /, stencil, *, constrain, boundary: Callable):
    """Second-order wave equation as the first-order system [u', c Lap u].

    The state is ``(2, n, n)``, or a batch ``(..., 2, n, n)`` of them
    through one convolution (the JAX package ``vmap``s instead).
    """

    def parametrize(*, scale):
        scale_constrained = constrain(scale)

        def rhs(x, /):
            _check_square(x, 3)
            u, du = x.unbind(-3)
            u_new = _conv2d_valid(stencil, boundary(u)) * scale_constrained
            return torch.stack([du, u_new], dim=-3)

        return rhs

    return parametrize, {"scale": torch.empty_like(scale_like)}


def boundary_dirichlet():
    return lambda x: F.pad(x, (1, 1, 1, 1), mode="constant", value=0.0)


def boundary_neumann():
    return lambda x: F.pad(x[None], (1, 1, 1, 1), mode="replicate")[0]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def loss_mse():
    def loss(sol, /, *, targets):
        return torch.mean((sol - targets) ** 2)

    return loss


def loss_mse_relative(*, nugget, reduce=torch.mean):
    def loss(sol, /, *, targets):
        mse_abs = (sol - targets) ** 2
        return reduce(mse_abs / (nugget + torch.abs(targets)))

    return loss


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def solver_euler(ts, vector_field, /):
    """Explicit Euler over the time grid ``ts``."""

    def solve(y0, *p):
        y = y0
        for dt in torch.diff(ts):
            y = y + dt * vector_field(y, *p)
        return y, {"num_matvecs": len(ts) - 1}

    return solve


def solver_rk4(ts, vector_field, /):
    """Classical RK4 over the time grid ``ts``: ``solve(y0, *p) -> y1``
    (the JAX data generator's solver, ``make_data.py``)."""

    def solve(y0, *p):
        y = y0
        for dt in torch.diff(ts):
            k1 = vector_field(y, *p)
            k2 = vector_field(y + dt / 2 * k1, *p)
            k3 = vector_field(y + dt / 2 * k2, *p)
            k4 = vector_field(y + dt * k3, *p)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        return y

    return solve


def solver_diffrax(t0, t1, vector_field, /, *, num_steps, method, adjoint):
    """Not ported: diffrax is a JAX library (the JAX package gates it too)."""
    msg = (
        "solver_diffrax is not ported: it needs diffrax, a JAX library. Use "
        "solver_euler or solver_expm(expm_arnoldi(...)) instead."
    )
    raise NotImplementedError(msg)


def solver_expm(t0, t1, vector_field, /, expm):
    """One-shot matrix-exponential solver ``y1 = exp((t1 - t0) A) y0``.

    ``solve(y0, *params)``; ``vector_field(y, *params)`` is linear in
    ``y``. The parameters pass to the Krylov method explicitly.
    """

    def solve(y0, *p):
        def matvec_p(v, *p_):
            return vector_field(v.reshape(y0.shape), *p_).reshape(-1)

        value, info = expm(matvec_p, t1 - t0, y0.reshape(-1), *p)
        return value.reshape(y0.shape), info

    return solve


def expm_arnoldi(krylov_depth, *, reortho="full", custom_vjp=True):
    """Krylov matrix exponential: ``exp(dt A) y0 ~ (1/c) Q expm(dt H) e1``.

    Differentiable through the Arnoldi adjoint; ``krylov_depth``
    operator applications per evaluation. ``torch.linalg.matrix_exp``
    picks its own scaling (the JAX package's ``max_squarings`` has no
    counterpart).
    """

    @requires_float32
    def expm(matvec, dt, y0_flat, *p):
        algorithm = arnoldi.hessenberg(matvec, krylov_depth, reortho=reortho, custom_vjp=custom_vjp)
        Q, H, _res, c = algorithm(y0_flat, *p)
        expmat = torch.linalg.matrix_exp(dt * H)
        return (1.0 / c) * (Q @ expmat[:, 0]), {"num_matvecs": krylov_depth}

    return expm


def expm_pade():
    """Dense reference: materialise A by forward-mode Jacobian and exponentiate it."""

    def expm(matvec, dt, y0_flat, *p):
        matrix = torch.func.jacfwd(lambda v: matvec(v, *p))(y0_flat)
        return torch.linalg.matrix_exp(dt * matrix) @ y0_flat, {}

    return expm


# ---------------------------------------------------------------------------
# MLP over the mesh
# ---------------------------------------------------------------------------

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


class MLP(torch.nn.Module):
    """Mesh coordinates -> a scalar field: the JAX package's flax MLP.

    ``Linear(2, f0) -> activation -> ... -> Linear(., 1)``, times
    ``softplus(output_scale_raw)``, applied to the ``(2, n, n)`` mesh and
    returned as ``(n, n)``.
    """

    def __init__(self, features: Sequence[int], activation: Callable, *, output_scale_raw, device=None):
        super().__init__()
        if features[-1] != 1:
            raise ValueError(f"the last layer must have one feature, got {features}")
        widths = [2, *features]
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(a, b, device=device) for a, b in zip(widths[:-1], widths[1:])
        )
        self.activation = activation
        self.output_scale = F.softplus(torch.tensor(float(output_scale_raw), device=device)).item()

    def forward(self, mesh):
        x = mesh.reshape(2, -1).T
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        out = self.layers[-1](x).reshape(-1) * self.output_scale
        return out.reshape(mesh[0].shape)


def model_mlp(mesh_like, features, /, activation: Callable, *, output_scale_raw, seed: int = 0):
    """The mesh MLP with flax's initialisation (lecun-normal kernels, zero biases).

    The weights are drawn with numpy from ``seed`` (flax draws other
    numbers from its key; ``params_from_jax`` carries a flax model's).
    """
    if mesh_like.ndim != 3:
        raise ValueError(f"expected a (2, n, n) mesh, got {tuple(mesh_like.shape)}")
    model = MLP(features, activation, output_scale_raw=output_scale_raw, device=mesh_like.device)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for layer in model.layers:
            fan_out, fan_in = layer.weight.shape
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
            draw = rng.standard_normal((fan_out, fan_in))
            while np.any(out := np.abs(draw) > 2.0):
                draw[out] = rng.standard_normal(int(out.sum()))
            layer.weight.copy_(torch.tensor(draw * std, dtype=layer.weight.dtype, device=layer.weight.device))
            layer.bias.zero_()
    return model


def params_from_jax(model: MLP, variables):
    """Load flax variables (as numpy arrays) into ``model``.

    ``variables["params"]["Dense_i"]`` holds ``kernel (in, out)`` and
    ``bias (out,)``; ``nn.Linear.weight`` is ``(out, in)``.
    """
    params = variables["params"]
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            dense = params[f"Dense_{i}"]
            like = {"dtype": layer.weight.dtype, "device": layer.weight.device}
            layer.weight.copy_(torch.tensor(np.asarray(dense["kernel"]).T, **like))
            layer.bias.copy_(torch.tensor(np.asarray(dense["bias"]), **like))
    return model


# ---------------------------------------------------------------------------
# GRF sampler
# ---------------------------------------------------------------------------


def _standard_normal(key, shape, like):
    """``shape`` normal draws from the generator ``key``, or ``key`` itself
    where it is a tensor of the draws."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            raise ValueError(f"expected draws of shape {tuple(shape)}, got {tuple(key.shape)}")
        return key.to(like)
    return torch.randn(shape, generator=key, device=key.device).to(like)


def sampler_lanczos(*, mean, cov_matvec, num, lanczos_rank):
    """Gaussian-random-field sampler: ``x = mean + C^(1/2) eps`` via Lanczos.

    ``sample(key)`` draws ``num`` fields from the ``torch.Generator``
    ``key``, or takes ``key`` as the ``(num, *mean.shape)`` normal draws;
    ``cov_matvec(v)`` applies the covariance.
    """
    factorise = lanczos.tridiag(cov_matvec, lanczos_rank, reortho="full")

    @requires_float32
    def sample_one(eps):
        norm = torch.linalg.vector_norm(eps)
        eps = eps / norm
        (Q, (diag, offdiag)), _ = factorise(eps)
        K = torch.diag(diag) + torch.diag(offdiag, 1) + torch.diag(offdiag, -1)
        w, V = torch.linalg.eigh(K)
        w = torch.clamp(w, min=0.0)
        factor = (V * torch.sqrt(w)[None, :]) @ V.T
        return norm * (Q.T @ (factor @ (Q @ eps)))

    def sample(key):
        eps = _standard_normal(key, (num, *mean.shape), mean)
        return torch.stack([sample_one(e) for e in eps]) + mean[None, ...]

    return sample
