"""Flat parameter vectors in flax's ``ravel_pytree`` order.

The JAX package flattens a flax parameter tree with ``ravel_pytree``: the
nested dicts in sorted key order, a ``Dense`` layer's ``bias`` before its
``kernel``, the kernel ``(in, out)`` row-major. The port's parameters are
the ``{name: tensor}`` dict of ``torch.func.functional_call``, where an
``nn.Linear`` holds ``weight (out, in)``. ``ravel`` lays such a dict out
in the flax order, so that a flat vector, a probe or a posterior sample
drawn on the JAX side means the same entries here: ``layers.<i>`` is
flax's ``Dense_<i>``, ``weight`` its ``kernel`` (stored transposed), and
names sort as the flax paths do (``Dense_10`` before ``Dense_2``).
"""

import torch


def flax_path(name: str) -> tuple:
    """The flax path of a parameter name: ``layers.3.weight`` -> ``("Dense_3", "kernel")``."""
    parts = name.split(".")
    path, i = [], 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            path.append(f"Dense_{parts[i + 1]}")
            i += 2
        else:
            path.append("kernel" if parts[i] == "weight" else parts[i])
            i += 1
    return tuple(path)


def _is_kernel(name, tensor):
    return name.split(".")[-1] == "weight" and tensor.ndim == 2


def ravel(tree):
    """``(flat, unravel)`` for a tensor or a ``{name: tensor}`` dict."""
    if isinstance(tree, torch.Tensor):
        shape = tree.shape
        return tree.reshape(-1), lambda flat: flat.reshape(shape)
    names = sorted(tree, key=flax_path)
    layout = [(name, tuple(tree[name].shape), _is_kernel(name, tree[name])) for name in names]
    flat = torch.cat([
        (tree[name].T if kernel else tree[name]).reshape(-1) for name, _s, kernel in layout
    ])
    sizes = [torch.Size(shape).numel() for _n, shape, _k in layout]

    def unravel(vec):
        out = {}
        for (name, shape, kernel), part in zip(layout, torch.split(vec, sizes)):
            out[name] = part.reshape(shape[::-1]).T if kernel else part.reshape(shape)
        return out

    return flat, unravel
