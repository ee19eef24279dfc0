"""Inputs the benchmark makes from ``--seed`` and hands to the program and to the reference alike."""

import numpy as np
import torch

SEED_SPACE = 1 << 63


def seed_of(seed: int, stream: int) -> int:
    """A non-negative seed for the generator of one input stream of a run."""
    return (int(seed) * 1_000_003 + stream) % SEED_SPACE


def synthetic_gp(seed: int, *, num_data: int, ndim: int, train_fraction: float):
    """``synthetic_gp500k`` (the port's ``utils/uci.py``), drawn from ``seed``.

    A frozen copy of its arithmetic: standard-normal inputs, targets from a
    smooth nonlinear map of two random projections plus noise, inputs
    standardised and targets centred over all ``num_data`` points; then a
    shuffled head/tail split, as `train.gp.split` makes it. Returns the
    training rows ``(X (N_train, d), y (N_train,))`` as float32 numpy.
    """
    rng = np.random.default_rng(seed_of(seed, 0))
    inputs = rng.standard_normal((num_data, ndim)).astype(np.float32)
    w1 = rng.standard_normal((ndim,)).astype(np.float32)
    w2 = rng.standard_normal((ndim,)).astype(np.float32)
    targets = (
        np.sin(inputs @ w1)
        + 0.5 * np.cos(2.0 * (inputs @ w2))
        + 0.1 * (inputs[:, 0] * inputs[:, 1])
        + 0.1 * rng.standard_normal((num_data,)).astype(np.float32)
    ).astype(np.float32)
    inputs = (inputs - inputs.mean(0)) / (inputs.std(0) + 1e-8)
    targets = targets - targets.mean()
    perm = np.random.default_rng(seed_of(seed, 1)).permutation(num_data)
    n_train = int(num_data * train_fraction)
    train = perm[:n_train]
    return np.ascontiguousarray(inputs[train]), np.ascontiguousarray(targets[train])


def rademacher(generator: torch.Generator, shape, *, device) -> torch.Tensor:
    """+-1 float32 probes."""
    bits = torch.randint(0, 2, shape, generator=generator, device=device, dtype=torch.int8)
    return bits.to(torch.float32) * 2 - 1


def laplacian_2d_coo(m: int):
    """The 5-point Dirichlet Laplacian on an m x m grid as COO ``(rows, cols, vals)``:
    4 on the diagonal, -1 for each grid neighbour (``bench.py``'s operator)."""
    n = m * m
    idx = np.arange(n)
    i, j = idx // m, idx % m
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = i + di, j + dj
        ok = (ni >= 0) & (ni < m) & (nj >= 0) & (nj < m)
        rows.append(idx[ok])
        cols.append((ni * m + nj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
