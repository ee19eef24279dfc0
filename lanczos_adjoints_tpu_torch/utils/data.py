"""Data pipelines: UCI preprocessing, train/test splits, numpy collate.

Counterpart of ``lanczos_adjoints_tpu/utils/data.py``: seeding,
Wu-et-al.-style UCI preprocessing and loading, head/tail and shuffled
train/test splits, and the numpy collate function. The shuffled split
takes a seed (a numpy permutation, not JAX's for the same seed) or the
permutation itself, e.g. a JAX run's, exported to the repository
(``train.gp.JaxDraws``). The torchvision image loaders of the JAX module
are not ported: torchvision is not a dependency of the port and their
data is not in the repository.
"""

import os
import random
from pathlib import Path

import numpy as np
import torch

# The repository's own data directory, in place of the JAX module's
# absolute path to it.
REPO_DATA = Path(__file__).resolve().parents[2] / "data"


def set_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators (every card's too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def uci_preprocessing(inputs, targets, test_mask_column, *, verbose=False):
    """Split by a 0/1 test-mask column and z-score with the training statistics."""
    test_mask = test_mask_column.astype(bool)
    x_train, y_train = inputs[~test_mask], targets[~test_mask]
    x_test, y_test = inputs[test_mask], targets[test_mask]

    mu_x = x_train.mean(axis=0, keepdims=True)
    std_x = x_train.std(axis=0, keepdims=True)
    std_x = np.where(std_x < 1e-12, 1.0, std_x)
    mu_y, std_y = y_train.mean(), y_train.std()

    x_train = (x_train - mu_x) / std_x
    x_test = (x_test - mu_x) / std_x
    y_train = (y_train - mu_y) / std_y
    y_test = (y_test - mu_y) / std_y

    if verbose:
        print(f"train {x_train.shape}, test {x_test.shape}")
    stats = {"mu_x": mu_x, "std_x": std_x, "mu_y": mu_y, "std_y": std_y}
    return (x_train, y_train), (x_test, y_test), stats


def read_csv(path, dtype) -> np.ndarray:
    """A headerless comma-separated table, ``.gz`` read transparently, as a 2-D array."""
    return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)


def load_uci_data(name: str, *, split: int = 0, root="./data/uci", verbose=False):
    """Load a Wu-et-al.-packaged UCI dataset (``data.csv.gz`` + ``test_mask.csv.gz``).

    ``split`` selects one of the mask columns. Searches ``root``, then the
    repository's ``data/uci``; raises ``FileNotFoundError`` naming both.
    """
    candidates = [str(root), str(REPO_DATA / "uci")]
    for cand in candidates:
        data_path = os.path.join(cand, name, "data.csv.gz")
        mask_path = os.path.join(cand, name, "test_mask.csv.gz")
        if os.path.exists(data_path) and os.path.getsize(data_path) > 0:
            frame = read_csv(data_path, np.float64)
            masks = read_csv(mask_path, np.int64)
            inputs, targets = frame[:, :-1], frame[:, -1]
            return uci_preprocessing(inputs, targets, masks[:, split], verbose=verbose)
    msg = f"UCI dataset {name!r} not found under {candidates}"
    raise FileNotFoundError(msg)


def split_train_test(inputs, targets, /, *, train_fraction: float = 0.9):
    """Deterministic head/tail split."""
    n_train = int(train_fraction * len(inputs))
    return (
        (inputs[:n_train], targets[:n_train]),
        (inputs[n_train:], targets[n_train:]),
    )


def split_train_test_shuffle(seed_or_permutation, inputs, targets, /, *, train_fraction: float = 0.9):
    """Shuffled head/tail split.

    ``seed_or_permutation``: an int, permuting with
    ``np.random.default_rng(seed)`` (which differs from the JAX package's
    permutation for the same seed), or the permutation of
    ``range(len(inputs))`` itself.
    """
    if isinstance(seed_or_permutation, (int, np.integer)):
        perm = np.random.default_rng(seed_or_permutation).permutation(len(inputs))
    else:
        perm = np.asarray(seed_or_permutation)
        if perm.shape != (len(inputs),):
            msg = f"a permutation of shape {perm.shape} for {len(inputs)} rows"
            raise ValueError(msg)
    return split_train_test(inputs[perm], targets[perm], train_fraction=train_fraction)


def numpy_collate_fn(batch):
    """A ``torch.utils.data.DataLoader`` collate producing numpy arrays."""
    images, labels = zip(*batch)
    return {
        "image": np.stack([np.asarray(img) for img in images]),
        "label": np.stack([np.asarray(lbl) for lbl in labels]),
    }
