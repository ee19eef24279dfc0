"""BNN baseline estimators: exact and Hutchinson GGN diagonals, the last-layer GGN.

Counterpart of ``lanczos_adjoints_tpu/models/bnn_baselines.py``.
Parameters are the ``{name: tensor}`` dicts of ``models.bnn.model_mlp``,
flattened in the JAX package's order (``models._flat``). Where the JAX
package draws from a key, these functions take a ``torch.Generator``, or
the draws themselves as a tensor, so that a test can hand them JAX's own.
"""

from typing import Callable

import torch

from lanczos_adjoints_tpu_torch.models._flat import flax_path, ravel

LIKELIHOODS = ("classification", "regression")


def _check_likelihood(likelihood):
    if likelihood not in LIKELIHOODS:
        msg = f"likelihood={likelihood!r} unsupported"
        raise ValueError(msg)


def _output_hessian(preds, likelihood):
    """Per-sample Hessians of the loss in output space, ``(N, O, O)``."""
    if likelihood == "classification":
        probs = torch.softmax(preds, dim=-1)
        return torch.diag_embed(probs) - probs[:, :, None] * probs[:, None, :]
    eye = torch.eye(preds.shape[-1], dtype=preds.dtype, device=preds.device)
    return (2.0 * eye).expand(preds.shape[0], -1, -1)


def exact_diagonal(model_fn, params, output_dims, x_train, likelihood="classification"):
    """Exact GGN diagonal, accumulated sample by sample.

    One Jacobian ``(O, P)`` of the outputs a sample (reverse mode): the
    brute-force oracle the stochastic estimators are compared against.
    """
    _check_likelihood(likelihood)
    params_flat, unflatten = ravel(params)

    def model_flat(p_flat, x):
        return model_fn(unflatten(p_flat), x)

    diag = torch.zeros_like(params_flat)
    for i in range(x_train.shape[0]):
        x = x_train[i][None, ...]
        preds = model_flat(params_flat, x)  # (1, O)
        H = _output_hessian(preds, likelihood)[0]
        J = torch.func.jacrev(lambda p, x=x: model_flat(p, x)[0, :output_dims])(params_flat)
        diag = diag + torch.einsum("op,oq,qp->p", J, H, J)
    return unflatten(diag)


def _draw(key, shape, like, kind):
    """``shape`` draws from the generator ``key``, or ``key`` itself if it is a tensor."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            msg = f"given draws of shape {tuple(key.shape)}, expected {tuple(shape)}"
            raise ValueError(msg)
        return key.to(dtype=like.dtype, device=like.device)
    if kind == "normal":
        draws = torch.randn(shape, generator=key, device=key.device, dtype=like.dtype)
    else:
        bits = torch.randint(0, 2, shape, generator=key, device=key.device)
        draws = (2 * bits - 1).to(like.dtype)
    return draws.to(like.device)


def tree_random_normal_like(key, tree):
    flat, unflatten = ravel(tree)
    return unflatten(_draw(key, flat.shape, flat, "normal"))


def tree_random_rademacher_like(key, tree):
    flat, unflatten = ravel(tree)
    return unflatten(_draw(key, flat.shape, flat, "rademacher"))


def hutchinson_diagonal(
    gvp_fn: Callable,
    params,
    n_samples: int,
    key,
    num_levels: int = 1,
    computation_type: str = "serial",
):
    """Multi-level Hutchinson estimator of ``diag(G)`` with control variates.

    Each level refines the running estimate ``D`` with
    ``E[v * (G v - D v)] = diag(G) - D``. ``key`` is a generator, from
    which the ``(num_levels, n_samples, P)`` Rademacher probes are drawn
    level by level, or those probes. ``"serial"`` sums the probes one by
    one, ``"parallel"`` evaluates them under ``torch.func.vmap``.
    """
    if computation_type not in ("serial", "parallel"):
        msg = f"computation_type={computation_type!r} unsupported"
        raise ValueError(msg)
    flat, unflatten = ravel(params)
    probes = _draw(key, (num_levels, n_samples, flat.shape[0]), flat, "rademacher")

    def gvp_flat(v_flat):
        return ravel(gvp_fn(v_flat))[0]

    diag = torch.zeros_like(flat)
    for level in range(num_levels):

        def single(v, diag_running=diag):
            return v * (gvp_flat(v) - diag_running * v)

        if computation_type == "parallel":
            correction = torch.mean(torch.func.vmap(single)(probes[level]), dim=0)
        else:
            total = torch.zeros_like(flat)
            for v in probes[level]:
                total = total + single(v)
            correction = total / n_samples
        diag = diag + correction
    return unflatten(diag)


def last_layer_ggn(model_fn, params, x_train, likelihood="classification"):
    """Materialised GGN of the last layer's parameters only.

    The last layer is the module whose flax path sorts last (the last
    ``nn.Linear`` of ``model_mlp``, flax's last ``Dense``). Returns the
    ``(k, k)`` GGN and the indices of its ``k`` parameters in the flat
    vector.
    """
    _check_likelihood(likelihood)
    flat_all, unflatten_all = ravel(params)
    modules = {name: flax_path(name)[:-1] or flax_path(name)[:1] for name in params}
    last = max(modules.values())
    mask = ravel({
        name: torch.full_like(t, float(modules[name] == last)) for name, t in params.items()
    })[0]
    (idx,) = torch.nonzero(mask > 0, as_tuple=True)

    def model_last(p_last, x):
        return model_fn(unflatten_all(flat_all.index_put((idx,), p_last)), x)

    p_last = flat_all[idx]
    preds = model_last(p_last, x_train)  # (N, O)
    J = torch.func.jacfwd(lambda p: model_last(p, x_train))(p_last)  # (N, O, k)
    H = _output_hessian(preds, likelihood)
    return torch.einsum("nok,noq,nql->kl", J, H, J), idx
