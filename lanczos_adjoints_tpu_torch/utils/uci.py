"""UCI regression datasets, numpy only.

Counterpart of ``lanczos_adjoints_tpu/utils/uci.py`` (the port imports
nothing of the JAX package): one ``uci_<name>()`` loader per dataset,
backed by a cache of ``{inputs,targets}.npy`` pairs or the
Wu-et-al.-style ``<name>/data.csv.gz``, searched in ``./data`` and the
repository's ``data`` directory. A miss raises ``FileNotFoundError``:
nothing is downloaded. ``normalize=True`` z-scores the inputs and
centres the targets (the reference's RMSE is in target units);
``"standardize"`` z-scores both. ``uci_synthetic_gp500k`` is generated in
process, bitwise the JAX package's arrays.
"""

import functools
import os

import numpy as np

from lanczos_adjoints_tpu_torch.utils.data import REPO_DATA, read_csv

_SEARCH_PATHS = ("./data/uci_processed", str(REPO_DATA / "uci_processed"))
_CSV_SEARCH_PATHS = ("./data/uci", str(REPO_DATA / "uci"))


def _from_cache(name: str):
    for root in _SEARCH_PATHS:
        d = os.path.join(root, name)
        if os.path.exists(os.path.join(d, "inputs.npy")):
            return np.load(os.path.join(d, "inputs.npy")), np.load(os.path.join(d, "targets.npy"))
    return None


def _from_csv(name: str):
    for root in _CSV_SEARCH_PATHS:
        path = os.path.join(root, name, "data.csv.gz")
        if os.path.exists(path) and os.path.getsize(path) > 0:
            frame = read_csv(path, np.float64)
            return frame[:, :-1], frame[:, -1]
    return None


def _cache(name: str, inputs, targets, cache_dir="./data/uci_processed"):
    d = os.path.join(cache_dir, name)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "inputs.npy"), inputs)
    np.save(os.path.join(d, "targets.npy"), targets)


def _use_cache_or_bundled(fn):
    """The loader of ``fn``'s dataset: the cache, else the csv, else ``FileNotFoundError``."""

    @functools.wraps(fn)
    def wrapped(*, normalize=True):
        name = fn.__name__.removeprefix("uci_")
        found = _from_cache(name) or _from_csv(name)
        if found is None:
            msg = (
                f"UCI dataset {name!r} is not cached under {_SEARCH_PATHS + _CSV_SEARCH_PATHS} "
                f"and nothing is downloaded. Place data/uci_processed/{name}/{{inputs,targets}}.npy."
            )
            raise FileNotFoundError(msg)
        inputs, targets = found
        if normalize == "standardize":
            inputs = _zscore(inputs)
            targets = _zscore(targets)
        elif normalize:
            inputs = _zscore(inputs)
            targets = targets - targets.mean(axis=0, keepdims=True)
        return inputs, targets

    return wrapped


def _zscore(arr):
    mean = arr.mean(axis=0, keepdims=True)
    std = arr.std(axis=0, keepdims=True)
    return (arr - mean) / np.where(std < 1e-12, 1.0, std)


@_use_cache_or_bundled
def uci_road_network():
    """3D road network (N~434k, d=3)."""


@_use_cache_or_bundled
def uci_song():
    """YearPredictionMSD (N~515k, d=90)."""


@_use_cache_or_bundled
def uci_air_quality():
    """Air quality (N~9k, d=13)."""


@_use_cache_or_bundled
def uci_bike_sharing():
    """Bike sharing (N~17k, d=17)."""


@_use_cache_or_bundled
def uci_kegg_undirected():
    """KEGG undirected (N~64k, d=27)."""


@_use_cache_or_bundled
def uci_parkinson():
    """Parkinson telemonitoring (N~6k, d=20)."""


@_use_cache_or_bundled
def uci_protein():
    """Protein structure (N~46k, d=9)."""


@_use_cache_or_bundled
def uci_sgemm():
    """SGEMM GPU kernel performance (N~241k, d=14)."""


@_use_cache_or_bundled
def uci_concrete():
    """Concrete compressive strength (N=1030, d=8)."""


@_use_cache_or_bundled
def uci_power_plant():
    """Combined-cycle power plant (N~10k, d=4)."""


@_use_cache_or_bundled
def uci_kin40k():
    """kin40k robot kinematics (N=40k, d=8)."""


@_use_cache_or_bundled
def uci_elevators():
    """Elevators (N~16.6k, d=18)."""


@_use_cache_or_bundled
def uci_slice():
    """CT slice localisation (N~53k, d=385)."""


@_use_cache_or_bundled
def uci_kegg_directed():
    """KEGG directed (N~53k, d=20)."""


@_use_cache_or_bundled
def uci_bike():
    """Bike (Wu et al. split)."""


@_use_cache_or_bundled
def uci_pol():
    """Pol telecomm."""


@_use_cache_or_bundled
def uci_pumadyn32nm():
    """Pumadyn-32nm."""


@_use_cache_or_bundled
def uci_metro():
    """Metro interstate traffic."""


@_use_cache_or_bundled
def uci_pm25():
    """Beijing PM2.5."""


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
