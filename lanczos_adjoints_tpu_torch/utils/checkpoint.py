"""Training checkpoint/resume.

Counterpart of ``lanczos_adjoints_tpu/utils/checkpoint.py``: ``save``,
``restore`` and ``latest_step``, with the same directory layout (one
``ckpt_{step:08d}`` entry a step and an atomically replaced ``LATEST``
marker). A state is a dict of tensors, numbers, lists and dicts (the
flat parameters, an optimiser's ``state_dict``, a ``torch.Generator``'s
state), written with ``torch.save`` and read back with
``torch.load(weights_only=True)``, which unpickles nothing else.
"""

import os

import torch


def save(directory: str, step: int, state: dict) -> str:
    """Save ``state`` as the checkpoint of ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    _write_latest(directory, step)
    return path


def restore(directory: str, state_like: dict):
    """Restore the latest checkpoint, or return ``(None, -1)`` if there is none.

    Each tensor at the top level of the state goes to the device of the
    tensor of the same key in ``state_like``; the keys must match.
    """
    step = latest_step(directory)
    if step < 0:
        return None, -1
    path = os.path.join(directory, f"ckpt_{step:08d}.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if sorted(state) != sorted(state_like):
        msg = f"checkpoint {path} holds {sorted(state)}, expected {sorted(state_like)}"
        raise ValueError(msg)
    for key, like in state_like.items():
        if isinstance(like, torch.Tensor):
            state[key] = state[key].to(like.device)
    return state, step


def latest_step(directory: str) -> int:
    marker = os.path.join(directory, "LATEST")
    if not os.path.exists(marker):
        return -1
    with open(marker) as fp:
        return int(fp.read().strip())


def _write_latest(directory: str, step: int):
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as fp:
        fp.write(str(step))
    os.replace(tmp, os.path.join(directory, "LATEST"))
