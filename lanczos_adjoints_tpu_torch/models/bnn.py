"""BNN / GGN linearised-Laplace utilities.

Counterpart of ``lanczos_adjoints_tpu/models/bnn.py``: the MLP, the
uncertainty metrics, the losses, the log-determinant solvers, the GGN
operators, the posterior samplers, the vectorisation helpers, the
memory-lean Jacobians and Gaussian log-pdfs, the linearised-Laplace
predictives and the prior-precision calibration losses.

Conventions of the port:

- A network's parameters are the ``{name: tensor}`` dict that
  ``torch.func.functional_call`` takes; ``vectorize_nn`` flattens it in
  the JAX package's ``ravel_pytree`` order (``models._flat``), so a flat
  vector, probe or draw carries across unchanged (``params_from_jax``).
- ``jax.linearize`` / ``linear_transpose`` become one ``torch.func.jvp``
  and one ``torch.func.vjp`` of the batched apply; ``jax.jacfwd``
  becomes ``torch.func.jacfwd``.
- Where the JAX package draws from a key, these functions take a
  ``torch.Generator``, or the draws themselves as a tensor.
- The calibration losses' operator ``G + alpha I`` is a
  ``torch.autograd.Function`` (``_DampedGGN``): it is symmetric, so its
  vector-Jacobian product in ``v`` is one more GGN product, and its
  gradient in ``alpha`` is ``<g, v>``. The Krylov adjoints then
  differentiate ``log alpha`` without a second-order pass through the
  network; the parameters, inputs and labels get a gradient only if
  they ask for one.

No function here reaches a Pallas kernel in the JAX package; the large
products are the network's own matmuls.

The divergences of the JAX package from its reference are kept
(``COMPONENTS.md``): the ECE bins shifted to 0-based and clamped, the
predictive sampler's ``sqrt(w)``, one linearisation of the batched apply
for the GGN, and ``slq_num_batches`` dividing the probe total.
"""

import math
import warnings
from typing import Callable

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.krylov import lanczos
from lanczos_adjoints_tpu_torch.models._flat import ravel
from lanczos_adjoints_tpu_torch.models.bnn_baselines import _draw, hutchinson_diagonal
from lanczos_adjoints_tpu_torch.solvers import cg as _cg
from lanczos_adjoints_tpu_torch.trace.hutchinson import hutchinson as _hutchinson

# flax's default kernel init, ``lecun_normal``: variance scaling by 1/fan_in,
# a normal truncated at +-2 standard deviations, rescaled to unit variance.
TRUNCATED_NORMAL_STDDEV = 0.87962566103423978

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class MLP(torch.nn.Module):
    """``Linear`` layers ``in -> hidden... -> out``, the activation after each hidden one."""

    def __init__(self, in_features: int, hidden, out_dims: int, activation: Callable):
        super().__init__()
        widths = [in_features, *hidden, out_dims]
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        self.activation = activation

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        return self.layers[-1](x)


def model_mlp(*, out_dims, activation: Callable, hidden=(50, 50, 5, 5)):
    """``(init, apply)`` of an ``MLP``, the flax MLP's counterpart.

    ``init(generator, x)`` builds the module for ``x``'s flattened width
    and returns its parameters on ``x``'s device and dtype, drawn as flax
    draws them (``lecun_normal`` kernels, zero biases; the draws differ
    from JAX's); ``apply(params, x)`` is ``functional_call`` of the
    module. ``apply`` needs ``init`` to have run once.
    """
    built = {}

    def init(generator: torch.Generator, x):
        # The module only names the parameters that ``apply`` binds: its own
        # stay on the meta device, never drawn.
        with torch.device("meta"):
            built["module"] = MLP(math.prod(x.shape[1:]), hidden, out_dims, activation)
        params = {}
        for i, layer in enumerate(built["module"].layers):
            n_in, n_out = layer.in_features, layer.out_features
            kernel = torch.empty((n_in, n_out), dtype=x.dtype, device=generator.device)
            torch.nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
            kernel = kernel * (math.sqrt(1.0 / n_in) / TRUNCATED_NORMAL_STDDEV)
            params[f"layers.{i}.weight"] = kernel.T.contiguous().to(x.device)
            params[f"layers.{i}.bias"] = torch.zeros(n_out, dtype=x.dtype, device=x.device)
        return params

    def apply(params, x):
        if "module" not in built:
            msg = "model_mlp's apply needs init to have run once"
            raise RuntimeError(msg)
        return torch.func.functional_call(built["module"], params, (x,))

    return init, apply


def params_from_jax(variables_or_flat, device="cuda"):
    """The flat vector of a flax parameter tree, or of a flat array, as a tensor.

    A nested dict (``{"params": {"Dense_0": {"bias", "kernel"}, ...}}``)
    is flattened as ``ravel_pytree`` does, sorted keys at every level; a
    flat array is taken as it is. The result is what ``vectorize_nn``
    returns for the port's dict of the same network.
    """
    def leaves(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from leaves(tree[key])
        else:
            yield torch.as_tensor(np.array(tree), device=device).reshape(-1)

    return torch.cat(list(leaves(variables_or_flat)))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def metric_accuracy(*, probs, labels_hot):
    assert probs.ndim == 2 and labels_hot.ndim == 2
    acc = torch.argmax(probs, dim=-1) == torch.argmax(labels_hot, dim=-1)
    return torch.mean(acc.to(probs.dtype), dim=-1)


def metric_nll(*, logits, labels_hot, sum_or_mean_fun=torch.sum):
    assert logits.ndim == 2 and labels_hot.ndim == 2
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = torch.sum(labels_hot * logprobs, dim=-1)
    return -sum_or_mean_fun(nll, dim=0)


def metric_confidence(*, probs):
    assert probs.ndim == 2
    return torch.mean(torch.max(probs, dim=-1).values, dim=0)


def _bin_edges(num_bins, dtype, device):
    """``jnp.histogram(..., range=(0, 1))``'s edges: ``i * (1 / num_bins)``, then 1."""
    step = torch.arange(num_bins, dtype=dtype, device=device) * torch.tensor(
        1.0 / num_bins, dtype=dtype, device=device
    )
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def metric_ece(*, probs, labels_hot, num_bins):
    """Expected calibration error: (weighted average, max) over non-empty bins.

    As the JAX package: ``digitize`` (here ``bucketize(right=True)``)
    shifted to 0-based and clamped, so that a confidence of exactly 1.0
    stays in the top bin.
    """
    bins = _bin_edges(num_bins, probs.dtype, probs.device)
    preds = probs.argmax(dim=1)
    labels = labels_hot.argmax(dim=1)
    confs = torch.max(probs, dim=1).values
    conf_idxs = torch.clamp(torch.bucketize(confs, bins, right=True) - 1, 0, num_bins - 1)

    bin_ids = torch.arange(num_bins, device=probs.device)
    member = (conf_idxs[None, :] == bin_ids[:, None]).to(probs.dtype)  # (num_bins, n)
    counts = member.sum(dim=1)
    safe_counts = torch.clamp(counts, min=1)
    correct = (preds == labels).to(probs.dtype)
    accs = (member * correct[None, :]).sum(dim=1) / safe_counts
    mean_confs = (member * confs[None, :]).sum(dim=1) / safe_counts

    nonempty = counts > 0
    ce = torch.abs(mean_confs - accs)
    weights = torch.where(nonempty, counts, torch.zeros_like(counts))
    weights = weights / torch.clamp(weights.sum(), min=1)
    ce_avg = torch.sum(torch.where(nonempty, ce * weights, torch.zeros_like(ce)))
    ce_max = torch.max(torch.where(nonempty, ce, torch.full_like(ce, -math.inf)))
    return ce_avg, ce_max


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def loss_training_cross_entropy(logits, labels_hot):
    return torch.mean(loss_training_cross_entropy_single(logits, labels_hot), dim=0)


def loss_training_cross_entropy_single(logits, labels_hot):
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.sum(logprobs * labels_hot, dim=-1)


def loss_calibration(*, ggn_fun, hyperparam_unconstrain, logdet_fun):
    """Negative Laplace log-marginal for prior-precision calibration."""

    def loss(a, variables, x_train, y_train, *logdet_params):
        alpha = hyperparam_unconstrain(a)
        log_prior = len(variables) / 2 * torch.log(alpha) - 0.5 * alpha * torch.dot(
            variables, variables
        )
        M = ggn_fun(alpha, variables, x_train, y_train)
        logdet = logdet_fun(M, *logdet_params)
        return -(log_prior - 0.5 * logdet)

    return loss


def loss_log_prob_like_in_redux(*, ggn_fun, hyperparam_unconstrain, logdet_fun):
    def loss(a, variables, x_train, y_train, *logdet_params):
        alpha = hyperparam_unconstrain(a)
        M = ggn_fun(alpha, variables, x_train, y_train)
        logdet = logdet_fun(M, *logdet_params)
        tmp1 = -len(variables) / 2 * math.log(2 * math.pi) + logdet / 2
        return tmp1 - torch.dot(variables, variables) / 2

    return loss


# ---------------------------------------------------------------------------
# Logdet solvers
# ---------------------------------------------------------------------------


def solver_logdet_dense():
    def logdet(M):
        _sign, value = torch.linalg.slogdet(M)
        return value

    return logdet


def slq_log_clipped(*, clip_value=1.0):
    def log(x):
        eps = torch.finfo(x.dtype).eps
        return torch.log(torch.where(x < eps, clip_value, x))

    return log


def _split_batches(num_samples: int, num_batches: int) -> int:
    """Probes per batch when ``num_batches`` *divides* the probe total.

    ``slq_num_batches`` is a memory knob: the estimator draws
    ``slq_num_samples`` probes in all, ``per_batch`` at a time, so that
    one batch's Krylov bases are the peak working set.
    """
    if num_samples % num_batches:
        msg = (
            f"slq_num_samples={num_samples} must be divisible by "
            f"slq_num_batches={num_batches}"
        )
        raise ValueError(msg)
    global _WARNED_BATCH_SEMANTICS
    if num_batches > 1 and not _WARNED_BATCH_SEMANTICS:
        _WARNED_BATCH_SEMANTICS = True
        warnings.warn(
            "slq_num_batches now DIVIDES slq_num_samples (total probes "
            f"fixed at {num_samples}, {num_samples // num_batches} per "
            "batch); it previously multiplied them. Configs tuned against "
            "the old semantics draw fewer probes and higher variance.",
            stacklevel=3,
        )
    return num_samples // num_batches


_WARNED_BATCH_SEMANTICS = False


def _rademacher_sampler(num, n):
    """``sample(key, like)``: ``(num, n)`` probes from a generator, or ``key`` if a tensor."""

    def sample(key, like):
        return _draw(key, (num, n), like, "rademacher")

    return sample


def _like(args):
    """The first floating tensor of ``args``: the probes' dtype and device."""
    return next(a for a in args if isinstance(a, torch.Tensor) and a.is_floating_point())


class _Recomputed(torch.autograd.Function):
    """``fn(probes, *args)`` without saving its graph: the backward pass runs it again.

    The JAX package's per-batch ``jax.checkpoint``. ``torch.utils.checkpoint``
    does not serve: its non-reentrant form rests on saved-tensor hooks,
    which ``torch.func.vjp`` (the GGN product) refuses, and its reentrant
    form does not run under ``torch.autograd.grad``.
    """

    @staticmethod
    def forward(ctx, fn, probes, *args):
        ctx.fn = fn
        ctx.save_for_backward(probes, *args)
        return fn(probes, *args)

    @staticmethod
    def backward(ctx, cotangent):
        probes, *args = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        grads = [None] * len(args)
        with torch.enable_grad():
            a = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(args)]
            found = torch.autograd.grad(ctx.fn(probes, *a), [a[i] for i in wanted], cotangent,
                                        allow_unused=True)
        for i, g in zip(wanted, found):
            grads[i] = g
        return (None, None, *grads)


def _slq_mean(integrand, sampler, key, num_batches, *args):
    """Average a Hutchinson-SLQ estimate over sequential probe batches.

    ``key`` is a generator, which advances from one batch to the next, or
    all the probes (batch after batch). Past one batch, each batch draws
    its probes first and then runs under ``_Recomputed``, so that both
    passes hold one batch's Krylov bases at a time.
    """
    like = _like(args)

    def estimate(probes, *a):
        return _hutchinson(integrand, lambda p: p)(probes, *a)

    batches = key.chunk(num_batches) if isinstance(key, torch.Tensor) else [key] * num_batches
    if num_batches == 1:
        return estimate(sampler(key, like), *args)
    values = [_Recomputed.apply(estimate, sampler(k, like), *args) for k in batches]
    return torch.mean(torch.stack(values), dim=0)


def solver_logdet_slq(*, lanczos_rank, slq_num_samples, slq_num_batches):
    """SLQ logdet of a dense matrix (clipped log)."""
    per_batch = _split_batches(slq_num_samples, slq_num_batches)

    def logdet(M, key):
        sampler = _rademacher_sampler(per_batch, len(M))
        integrand = lanczos.integrand_spd(slq_log_clipped(), lanczos_rank, lambda v, m: m @ v)
        return _slq_mean(integrand, sampler, key, slq_num_batches, M)

    return logdet


def solver_logdet_slq_implicit(
    *, lanczos_rank, slq_num_samples, slq_num_batches, N, matfun=None
):
    """SLQ logdet of an implicit operator ``Av(v, *args)``.

    The clipped log by default, as in the JAX package: on a numerically
    rank-deficient GGN the happy-breakdown truncation leaves a zero Ritz
    block of zero weight, and ``0 * log(0)`` is NaN where ``0 * log(1)``
    is 0. ``matfun=torch.log`` gives the plain log.
    """
    per_batch = _split_batches(slq_num_samples, slq_num_batches)
    sampler = _rademacher_sampler(per_batch, N)
    matfun = slq_log_clipped() if matfun is None else matfun

    def logdet(Av: Callable, key, *args):
        integrand = lanczos.integrand_spd(matfun, lanczos_rank, Av)
        return _slq_mean(integrand, sampler, key, slq_num_batches, *args)

    return logdet


def solver_clipped_mass_slq(
    *, lanczos_rank, slq_num_samples, slq_num_batches, N, eps=None
):
    """SLQ estimate of ``trace(1[A < eps])``: the spectral mass the clipped log maps to 0.

    Near zero on a full-rank operator; clearly positive where the default
    clipped log biases the logdet.
    """
    per_batch = _split_batches(slq_num_samples, slq_num_batches)
    sampler = _rademacher_sampler(per_batch, N)

    def indicator(x):
        cut = torch.finfo(x.dtype).eps if eps is None else eps
        return torch.where(x < cut, torch.ones_like(x), torch.zeros_like(x))

    def clipped_mass(Av: Callable, key, *args):
        integrand = lanczos.integrand_spd(indicator, lanczos_rank, Av)
        return _slq_mean(integrand, sampler, key, slq_num_batches, *args)

    return clipped_mass


# ---------------------------------------------------------------------------
# GGN operators
#
# The GGN of a sum-loss is  G = J^T H J  with J the Jacobian of the
# *batched* apply and H the block diagonal of per-sample loss Hessians.
# Every operator below linearises the batched apply once per product: one
# ``torch.func.jvp`` and one ``torch.func.vjp``, the batch inside each
# pass, so each layer runs as one large matmul.
# ---------------------------------------------------------------------------


def _linearize_batched(model_fun, param_unflatten, params_vec, x_batch):
    """``(preds, jvp, vjp)`` of the batched apply at flat parameters.

    ``jvp: (P,) -> (B, O)`` and ``vjp: (B, O) -> (P,)``.
    """

    def apply_flat(p_vec):
        return model_fun(param_unflatten(p_vec), x_batch)

    preds, vjp_fn = torch.func.vjp(apply_flat, params_vec)

    def jvp(v):
        return torch.func.jvp(apply_flat, (params_vec,), (v,))[1]

    return preds, jvp, lambda cotangent: vjp_fn(cotangent)[0]


def _cross_entropy_hessians(preds):
    """``diag(p) - p p^T`` with ``p = softmax(preds)``: the cross-entropy's Hessian."""
    probs = torch.softmax(preds, dim=-1)
    return torch.diag_embed(probs) - probs[:, :, None] * probs[:, None, :]


def _loss_hessians(loss_single, preds, y_batch):
    """Per-sample Hessians of the loss in output space: ``(B, O, O)``.

    The cross-entropy's in closed form; any other loss by
    ``torch.func.hessian``.
    """
    if loss_single is loss_training_cross_entropy_single:
        return _cross_entropy_hessians(preds)
    return torch.func.vmap(torch.func.hessian(loss_single, argnums=0))(preds, y_batch)


def _cholesky_or_nan(H):
    """Batched Cholesky factors, NaN where a matrix is not positive definite.

    ``jnp.linalg.cholesky`` returns NaN there; ``torch.linalg.cholesky``
    would raise.
    """
    L, info = torch.linalg.cholesky_ex(H)
    failed = (info > 0)[..., None, None]
    return torch.where(failed, torch.full_like(L, math.nan), L)


def ggn_vp(*, loss_single, model_fun, param_unflatten):
    """GGN-vector product ``v -> J^T H J v`` from one batched linearisation."""

    def gvp(v_vec, params_vec, x_batch, y_batch):
        preds, jvp, vjp = _linearize_batched(model_fun, param_unflatten, params_vec, x_batch)
        Jv = jvp(v_vec)
        H = _loss_hessians(loss_single, preds, y_batch)
        return vjp(torch.einsum("boi,bi->bo", H, Jv))

    return gvp


# The JAX package's name for the same operator.
ggn_vp_parallel = ggn_vp


def ggn_vp_running(*, loss_single, model_fun, param_unflatten, chunk_size=1):
    """Low-memory GGN-vector product: the batch in chunks of ``chunk_size``, summed.

    Rows past the last whole chunk are dropped, as in the JAX package.
    """
    chunked = ggn_vp(loss_single=loss_single, model_fun=model_fun, param_unflatten=param_unflatten)

    def gvp(v_vec, params_vec, x_batch, y_batch):
        num = x_batch.shape[0] // chunk_size
        out = torch.zeros_like(v_vec)
        for i in range(num):
            rows = slice(i * chunk_size, (i + 1) * chunk_size)
            out = out + chunked(v_vec, params_vec, x_batch[rows], y_batch[rows])
        return out

    return gvp


def kernel_vp(*, loss_single, model_fun, param_unflatten):
    """Batched NTK-form product ``v -> H J J^T L v`` over the batch, ``L = chol(H)``.

    An output-space operator ``(B, O) -> (B, O)`` with the cross-sample
    NTK entries. The cross-entropy's Hessian is singular, so its factor
    is NaN, as in the JAX package.
    """

    def kvp(v_outs, params_vec, x_batch, y_batch):
        preds, jvp, vjp = _linearize_batched(model_fun, param_unflatten, params_vec, x_batch)
        H = _loss_hessians(loss_single, preds, y_batch)
        Hv = torch.einsum("boi,bi->bo", _cholesky_or_nan(H), v_outs)
        return torch.einsum("boi,bi->bo", H, jvp(vjp(Hv)))

    return kvp


def kernel_vp_parallel(*, loss_single, model_fun, param_unflatten):
    """Per-sample (block-diagonal) NTK product, summed over the batch.

    Each sample contributes ``H_b J_b J_b^T L_b v`` with its own Jacobian
    row only; ``v`` has the shape of one sample's output.
    """

    def kvp(v_like_outs, params_vec, x_batch, y_batch):
        total = torch.zeros_like(v_like_outs)
        for b in range(x_batch.shape[0]):
            preds, jvp, vjp = _linearize_batched(
                model_fun, param_unflatten, params_vec, x_batch[b][None, ...]
            )
            H = _loss_hessians(loss_single, preds, y_batch[b][None, ...])
            Hv = torch.einsum("boi,bi->bo", _cholesky_or_nan(H), v_like_outs[None, ...])
            total = total + torch.einsum("boi,bi->bo", H, jvp(vjp(Hv)))[0]
        return total

    return kvp


def ggn_full(*, loss_single, model_fun, param_unflatten):
    """Materialised GGN ``J^T H J + alpha I`` (small models only)."""

    def ggn_fun(alpha, variables, x_train, y_train):
        def apply_flat(v):
            return model_fun(param_unflatten(v), x_train)

        preds = apply_flat(variables)
        H = _loss_hessians(loss_single, preds, y_train)
        J = torch.func.jacfwd(apply_flat)(variables)
        eye = torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
        return torch.einsum("bop,boq,bqr->pr", J, H, J) + alpha * eye

    return ggn_fun


def ggn_diag(*, loss_single, model_fun, param_unflatten):
    full = ggn_full(loss_single=loss_single, model_fun=model_fun, param_unflatten=param_unflatten)

    def ggn_fun(alpha, variables, x_train, y_train):
        return torch.diag(torch.diag(full(alpha, variables, x_train, y_train)))

    return ggn_fun


def ggn_vp_dataloader(
    param_vec,
    loss_single,
    model_fun,
    param_unflatten,
    data_loader,
    sum_type="parallel",
    batch_fields=("image", "label"),
):
    """GGN matvec summed over the batches of a data loader.

    ``batch_fields`` name the inputs and targets in each batch; the
    batches move to ``param_vec``'s device, floating ones to its dtype.
    """
    make = {"parallel": ggn_vp, "running": ggn_vp_running}[sum_type]
    gvp_batch = make(loss_single=loss_single, model_fun=model_fun, param_unflatten=param_unflatten)
    x_field, y_field = batch_fields

    def to_param(a):
        t = torch.as_tensor(a, device=param_vec.device)
        return t.to(param_vec.dtype) if t.is_floating_point() else t

    def ggn_vec_prod(v_vec):
        total = torch.zeros_like(param_vec)
        for batch in data_loader:
            total = total + gvp_batch(
                v_vec, param_vec, to_param(batch[x_field]), to_param(batch[y_field])
            )
        return total

    return ggn_vec_prod


def predictive_cov(*, ggn_fun, model_fun, param_unflatten, hyperparam_unconstrain):
    def evaluate(a, variables, x_train, y_train, x_test):
        alpha = hyperparam_unconstrain(a)
        covariance = torch.linalg.inv(ggn_fun(alpha, variables, x_train, y_train))
        J_test = torch.func.jacfwd(lambda v: model_fun(param_unflatten(v), x_test))(variables)
        return torch.einsum("bop,pq,brq->bor", J_test, covariance, J_test)

    return evaluate


# ---------------------------------------------------------------------------
# Posterior samplers
# ---------------------------------------------------------------------------


def sampler_cholesky(*, ggn_fun, num):
    def sample(key, alpha, variables, x_train, y_train):
        ggn = ggn_fun(alpha, variables, x_train, y_train)
        ggn_inv_sqrt = torch.linalg.cholesky(torch.linalg.inv(ggn))
        eps = _draw(key, (num, *variables.shape), variables, "normal")
        return (ggn_inv_sqrt @ eps.T).T + variables[None, ...]

    return sample


def sampler_lanczos(*, ggn_fun, num, lanczos_rank):
    """Sample from N(variables, GGN^{-1}) via Lanczos square roots."""

    def sample(key, alpha, variables, x_train, y_train):
        ggn = ggn_fun(alpha, variables, x_train, y_train)
        factorise = lanczos.tridiag(lambda v: ggn @ v, lanczos_rank, reortho="full")
        eps = _draw(key, (num, *variables.shape), variables, "normal")
        draws = []
        for single in eps:
            (Q, tridiag_), _ = factorise(single)
            tri_inv_sqrt = torch.linalg.cholesky(torch.linalg.inv(_dense_tridiag(*tridiag_)))
            draws.append(Q.T @ (tri_inv_sqrt @ (Q @ single)))
        return torch.stack(draws) + variables[None, ...]

    return sample


def lanczos_sampler(*, ggn_vp, num_samples, lanczos_rank, key, params_vec, signs=None):
    """Matrix-free posterior sampler with eigenvalue clamping.

    ``key``: a generator, or the ``(num_samples, P)`` normal draws. A
    sample moves along each Ritz vector by its own draw, so it depends on
    the vectors' signs, which eigh leaves to its LAPACK or cuSOLVER
    build. They are fixed (``_fixed_signs``: the largest-magnitude entry
    positive), then multiplied by ``signs``, the ``(num_samples,
    lanczos_rank)`` +-1 of another run relative to that convention (e.g.
    the JAX package's, ``laplace_s1.npz``), given beside its draws.
    """
    eps = _draw(key, (num_samples, *params_vec.shape), params_vec, "normal")
    if signs is None:
        signs = torch.ones((num_samples, lanczos_rank), dtype=params_vec.dtype, device=params_vec.device)
    signs = torch.as_tensor(signs, device=params_vec.device).to(params_vec.dtype)
    if signs.shape != (num_samples, lanczos_rank):
        msg = f"signs of shape {tuple(signs.shape)}, not {(num_samples, lanczos_rank)}"
        raise ValueError(msg)
    factorise = lanczos.tridiag(ggn_vp, lanczos_rank, reortho="full")

    def posterior_sample(single, sign):
        (Q, tridiag_), _ = factorise(single)
        w, V = torch.linalg.eigh(_dense_tridiag(*tridiag_))
        eigvecs = Q.T @ (_fixed_signs(V) * sign)
        small = w < 1e-9
        eigvals = torch.where(small, torch.ones_like(w), w)
        inv_eigvals = torch.where(small, torch.zeros_like(w), 1.0 / eigvals)
        coeffs = torch.sqrt(inv_eigvals) * single[:lanczos_rank]
        return params_vec + eigvecs @ coeffs

    return torch.stack([posterior_sample(single, sign) for single, sign in zip(eps, signs)])


def _fixed_signs(V):
    """Eigenvectors with their largest-magnitude entry positive.

    ``lanczos_sampler`` moves along each Ritz vector by the matching
    draw, so its samples depend on the eigenvectors' signs, which eigh
    leaves to the LAPACK or cuSOLVER build; this fixes them, so that a
    draw gives one sample on every device.
    """
    rows = torch.argmax(torch.abs(V), dim=0)
    signs = torch.sign(V[rows, torch.arange(V.shape[1], device=V.device)])
    return V * torch.where(signs == 0, torch.ones_like(signs), signs)


def _dense_tridiag(diagonal, off_diagonal):
    return (
        torch.diag(diagonal) + torch.diag(off_diagonal, 1) + torch.diag(off_diagonal, -1)
    )


# ---------------------------------------------------------------------------
# Vectorisation helpers
# ---------------------------------------------------------------------------


def vectorize_nn(model_fn, params):
    """Flatten a parameter dict (the JAX package's order) and wrap the apply."""
    params_vec, unflatten_fn = ravel(params)

    def model_apply_vec(params_vectorized, x):
        return model_fn(unflatten_fn(params_vectorized), x)

    return params_vec, unflatten_fn, model_apply_vec


def bind_model_state(model_apply, *, batch_stats=None, dropout_rng=None):
    """Wrap an ``nn.Module`` (or an apply function) into ``(params, x) -> logits``.

    Non-parameter state is bound by what it is, as in the JAX package,
    which applies flax modules with ``train=False``: given
    ``batch_stats`` (the module's buffers, e.g. BatchNorm's running
    statistics) or ``dropout_rng``, the module runs in eval mode with its
    buffers bound, so BatchNorm uses the statistics and dropout is off
    (flax's dropout rng is unused at ``train=False``; the generator is
    accepted for the same reason). With neither, a module is applied by
    ``functional_call`` and a function returned as it is.
    """
    if not isinstance(model_apply, torch.nn.Module):
        if batch_stats is not None or dropout_rng is not None:
            msg = "state is bound to an nn.Module; an apply function takes none"
            raise TypeError(msg)
        return model_apply
    state = dict(batch_stats or {})
    if batch_stats is None and dropout_rng is None:
        return lambda params, x: torch.func.functional_call(model_apply, params, (x,))

    def model_fn(params, x):
        was_training = model_apply.training
        model_apply.eval()
        try:
            return torch.func.functional_call(model_apply, {**params, **state}, (x,))
        finally:
            model_apply.train(was_training)

    return model_fn


def get_model_apply_fn(model_name, model_apply, batch_stats=None, rng=None):
    """The JAX package's alias of ``bind_model_state`` (the name is unused)."""
    del model_name
    return bind_model_state(model_apply, batch_stats=batch_stats, dropout_rng=rng)


def img_to_patch(x, patch_size, flatten_channels=True):
    """``[B, H, W, C]`` image batch into a ViT patch sequence."""
    import einops

    if flatten_channels:
        pattern = "b (h p1) (w p2) c -> b (h w) (p1 p2 c)"
    else:
        pattern = "b (h p1) (w p2) c -> b (h w) p1 p2 c"
    return einops.rearrange(x, pattern, p1=patch_size, p2=patch_size)


# ---------------------------------------------------------------------------
# Memory-lean Jacobians and Gaussian log-pdfs
# ---------------------------------------------------------------------------


def jacfwd_map(fun: Callable) -> Callable:
    """Forward-mode Jacobian, one ``torch.func.jvp`` per basis vector, in sequence.

    The basis axis comes last, as ``jax.jacfwd`` puts it.
    """

    def jacfun(x):
        flat, unflatten = ravel(x)
        basis = torch.eye(len(flat), dtype=flat.dtype, device=flat.device)
        rows = [torch.func.jvp(fun, (unflatten(flat),), (unflatten(e),))[1] for e in basis]
        return torch.movedim(torch.stack(rows), 0, -1)

    return jacfun


def logpdf_cholesky() -> Callable:
    """Gaussian logpdf via the materialised covariance and its Cholesky factor.

    The covariance is materialised with ``jacfwd_map`` (the JAX package
    uses ``jax.jacfwd``; the matrix is the same).
    """

    def logpdf(y, /, *, mean, cov: Callable):
        cholesky = torch.linalg.cholesky(jacfwd_map(cov)(mean))
        logdet = torch.sum(torch.log(torch.diag(cholesky)))
        tmp = torch.linalg.solve_triangular(cholesky, (y - mean)[:, None], upper=False)[:, 0]
        mahalanobis = torch.dot(tmp, tmp)
        (n,) = mean.shape
        return -logdet - 0.5 * mahalanobis - n / 2 * math.log(2 * math.pi), {}

    return logpdf


def logpdf_eigh() -> Callable:
    """Gaussian logpdf via an eigendecomposition, small eigenvalues clamped."""

    def logpdf(y, /, *, mean, cov: Callable):
        w, V = torch.linalg.eigh(jacfwd_map(cov)(mean))
        small = w < 1e-6
        logdet = torch.sum(torch.log(torch.where(small, torch.ones_like(w), w))) / 2
        inv_eigvals = torch.where(small, torch.zeros_like(w), 1.0 / w)
        factor = (V * torch.sqrt(inv_eigvals[..., None, :])) @ V.T
        tmp = factor @ (y - mean)
        mahalanobis = torch.dot(tmp, tmp)
        (n,) = mean.shape
        return -logdet - 0.5 * mahalanobis - n / 2 * math.log(2 * math.pi), {}

    return logpdf


# ---------------------------------------------------------------------------
# Linearised-Laplace predictives
#
# Both need the linearised test-time covariance  C = J_test G^{-1} J_test^T
# as a flat matvec; `_laplace_predictive` builds it once. Its CG solve
# differentiates as a linear solve in forward mode too (solvers.cg), so
# the Jacobian of the matvec is C itself.
# ---------------------------------------------------------------------------


def _laplace_predictive(model_apply, unflatten, ggn_fun, params_vec, x_test, *, solve):
    """Linearised predictive: flat mean, flat covariance matvec, unflattener."""
    mean_pred, jvp_fn, vjp_fn = _linearize_batched(model_apply, unflatten, params_vec, x_test)
    mean_flat, unflat_out = ravel(mean_pred)

    def cov_matvec(v_flat):
        ginv_Jtv, _info = solve(ggn_fun, vjp_fn(unflat_out(v_flat)))
        return ravel(jvp_fn(ginv_Jtv))[0]

    return mean_flat, cov_matvec, unflat_out


def predictive_posterior_loglikelihood(
    *, model_apply, unflatten, logpdf, ggn_fun, solve=None
):
    """``p(y | x) = N(y | f(x), J G^{-1} J^T)``; the inner solve injectable."""
    solve = solve or _cg.krylov_solve_cg_fixed_step_reortho(20)

    def eval_logprob(params_vec, x_test, y_test):
        mean_flat, cov_matvec, _ = _laplace_predictive(
            model_apply, unflatten, ggn_fun, params_vec, x_test, solve=solve
        )
        return logpdf(ravel(y_test)[0], mean=mean_flat, cov=cov_matvec)

    return eval_logprob


def predictive_logit_sampler(*, model_apply, unflatten, num_samples, ggn_fun, solve=None):
    """Sample predictive logits from the linearised-Laplace posterior.

    The samples use the covariance's square root ``V sqrt(w) V^T`` (the
    JAX package's fix of its reference's ``sqrt(1/w)``). ``key``: a
    generator, or the ``(num_samples, B * O)`` normal draws.
    """
    solve = solve or _cg.krylov_solve_cg_fixed_step_reortho(20)

    def eval_test_set(params_vec, x_test, y_test, key):
        del y_test  # kept for signature parity with the loglikelihood
        mean_flat, cov_matvec, unflat_out = _laplace_predictive(
            model_apply, unflatten, ggn_fun, params_vec, x_test, solve=solve
        )
        w, V = torch.linalg.eigh(jacfwd_map(cov_matvec)(mean_flat))
        eigvals = torch.where(w < 1e-6, torch.zeros_like(w), w)
        cov_sqrt = (V * torch.sqrt(eigvals[..., None, :])) @ V.T
        eps = _draw(key, (num_samples, *mean_flat.shape), mean_flat, "normal")
        samples = mean_flat[None, :] + eps @ cov_sqrt.T
        return torch.stack([unflat_out(s) for s in samples])

    return eval_test_set


# ---------------------------------------------------------------------------
# Calibration losses
#
# Both maximise the Laplace evidence over the prior precision alpha:
# log p(D | alpha) ~ log-prior(alpha) - 1/2 logdet(G + alpha I), with the
# logdet by SLQ or by a Hutchinson diagonal.
# ---------------------------------------------------------------------------


class _DampedGGN(torch.autograd.Function):
    """``G(params, x, y) v + alpha v`` with its symmetric vector-Jacobian product.

    Backward: ``G g + alpha g`` for ``v`` (one more GGN product) and
    ``<g, v>`` for ``alpha``. The parameters, inputs and labels get their
    gradient only when they require one, by autograd through the product
    again (a second-order pass through the network).
    """

    @staticmethod
    def forward(ctx, gvp, v, alpha, params_vec, x, y):
        ctx.gvp = gvp
        ctx.save_for_backward(v, alpha, params_vec, x, y)
        return gvp(v, params_vec, x, y) + alpha * v

    @staticmethod
    def backward(ctx, g):
        v, alpha, params_vec, x, y = ctx.saved_tensors
        need_v, need_alpha, *need_rest = ctx.needs_input_grad[1:]
        dv = ctx.gvp(g, params_vec, x, y) + alpha * g if need_v else None
        dalpha = torch.sum(g * v).reshape(alpha.shape) if need_alpha else None
        rest = [None, None, None]
        wanted = [i for i, need in enumerate(need_rest) if need]
        if wanted:
            with torch.enable_grad():
                q = [t.detach().requires_grad_(i in wanted) for i, t in enumerate((params_vec, x, y))]
                out = ctx.gvp(v, *q)
                found = torch.autograd.grad(out, [q[i] for i in wanted], g, allow_unused=True)
            for i, grad in zip(wanted, found):
                rest[i] = grad
        return (None, dv, dalpha, *rest)


def _damped_ggn_matvec(model_apply, unflatten):
    """Flat matvec of ``G + alpha I``, the calibration losses' operator."""
    gvp = ggn_vp(
        loss_single=loss_training_cross_entropy_single,
        model_fun=model_apply,
        param_unflatten=unflatten,
    )

    def matvec(v_vec, alpha, params_vec, x, y):
        return _DampedGGN.apply(gvp, v_vec, alpha, params_vec, x, y)

    return matvec


def _log_prior(alpha, params_vec, n_params):
    return torch.log(alpha) * n_params - alpha * torch.dot(params_vec, params_vec)


def calibration_loss(
    model_apply,
    unflatten,
    hyperparam_unconstrain,
    n_params,
    *,
    lanczos_rank=10,
    slq_num_samples=10,
    slq_num_batches=1,
):
    """Prior-precision calibration via the SLQ logdet of the implicit GGN.

    ``loss(log_alpha, params_vec, img, label, key)``; ``key`` is a
    generator or the ``(slq_num_samples, n_params)`` Rademacher probes.
    """
    ggn_mat = _damped_ggn_matvec(model_apply, unflatten)
    logdet_fun = solver_logdet_slq_implicit(
        lanczos_rank=lanczos_rank,
        slq_num_samples=slq_num_samples,
        slq_num_batches=slq_num_batches,
        N=n_params,
    )

    def loss(log_alpha, params_vec, img, label, key):
        alpha = hyperparam_unconstrain(log_alpha)
        logdet = logdet_fun(ggn_mat, key, alpha, params_vec, img, label)
        return -(_log_prior(alpha, params_vec, n_params) - logdet)

    return loss


def calibration_loss_diagonal(
    model_apply,
    unflatten,
    hyperparam_unconstrain,
    hutchinson_samples,
    num_levels,
    n_params,
    *,
    key=0,
):
    """Calibration with a multi-level Hutchinson diagonal logdet.

    The probes are the same at every call, as the JAX package's fixed
    ``PRNGKey(0)``: ``key`` is an integer seed of a fresh generator on
    the parameters' device, or the ``(num_levels, hutchinson_samples,
    n_params)`` probes themselves.
    """
    gvp = ggn_vp(
        loss_single=loss_training_cross_entropy_single,
        model_fun=model_apply,
        param_unflatten=unflatten,
    )

    def loss(log_alpha, params_vec, img, label):
        alpha = hyperparam_unconstrain(log_alpha)
        probes = key
        if not isinstance(key, torch.Tensor):
            probes = torch.Generator(device=params_vec.device).manual_seed(key)
        diag = hutchinson_diagonal(
            gvp_fn=lambda v: gvp(v, params_vec, img, label),
            params=params_vec,
            n_samples=hutchinson_samples,
            key=probes,
            computation_type="serial",
            num_levels=num_levels,
        )
        diag = torch.where(diag < 1e-4, torch.zeros_like(diag), diag)
        logdet = torch.sum(torch.log(diag + alpha))
        return -(_log_prior(alpha, params_vec, n_params) - logdet)

    return loss


# The JAX package's names ("callibration", its reference's spelling).
callibration_loss = calibration_loss
callibration_loss_diagonal = calibration_loss_diagonal
