"""In-process datasets, numpy only.

A copy of the synthetic dataset of ``lanczos_adjoints_tpu.utils.uci``
(the port imports nothing of the JAX package), plus a numpy-seeded
shuffled train/test split.
"""

import numpy as np


def uci_synthetic_gp500k(normalize: bool = True):
    """Synthetic regression at the reference's GP scale ceiling.

    N = 500,000 points in d = 8 (a 0.8 train fraction gives the 400,000
    training points of the reference's largest run), targets from a
    smooth nonlinear map of random projections plus noise. Same seed and
    arithmetic as the JAX package's copy, so the arrays are bitwise equal.
    """
    rng = np.random.default_rng(20260820)
    n, d = 500_000, 8
    inputs = rng.standard_normal((n, d)).astype(np.float32)
    w1 = rng.standard_normal((d,)).astype(np.float32)
    w2 = rng.standard_normal((d,)).astype(np.float32)
    targets = (
        np.sin(inputs @ w1)
        + 0.5 * np.cos(2.0 * (inputs @ w2))
        + 0.1 * (inputs[:, 0] * inputs[:, 1])
        + 0.1 * rng.standard_normal((n,)).astype(np.float32)
    ).astype(np.float32)
    if normalize:
        inputs = (inputs - inputs.mean(0)) / (inputs.std(0) + 1e-8)
        targets = targets - targets.mean()
    return inputs, targets


def split_train_test_shuffle(seed: int, inputs, targets, /, *, train_fraction=0.9):
    """Shuffled head/tail split with a numpy permutation.

    The JAX package permutes with a JAX key
    (``lanczos_adjoints_tpu.utils.data.split_train_test_shuffle``); this
    permutation comes from ``np.random.default_rng(seed)`` and therefore
    differs from it for the same seed.
    """
    perm = np.random.default_rng(seed).permutation(len(inputs))
    inputs, targets = inputs[perm], targets[perm]
    n_train = int(train_fraction * len(inputs))
    return (
        (inputs[:n_train], targets[:n_train]),
        (inputs[n_train:], targets[n_train:]),
    )
