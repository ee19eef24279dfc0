"""Export the JAX ``adj400k`` GP run's split, probes and epoch-1 state as a fixture.

The JAX driver (``experiments/applications/gaussian_process/train/_common.py``)
draws everything from ``PRNGKey(--seed)``: one split for the train/test
permutation, one for the initial parameters, then one per epoch for the
SLQ probes, and one after the last epoch for ``mll_eval``'s probes. The
``adj400k`` run (``scripts/round5_tpu_phase2.sh``) passed ``--split_step
--slq_host_batches 5``: an epoch's key is split five ways, and each part
draws 3 Rademacher probes of the 400,000 training points. This script
replays that key path with the JAX package on the CPU and writes what the
PyTorch port needs to train on the run's own draws without JAX:

- ``permutation``: the split's permutation of the 500,000 points (int32);
- ``probes``: epochs 0-2, ``(3, 5, 3, 400,000)`` signs packed along the
  last axis with ``np.packbits`` (bit 1 is +1);
- ``eval_probes``: the 15 probes of 100,000 test points that ``mll_eval``
  drew after epoch 11, packed the same way;
- ``epoch_keys``, ``eval_key``: the keys the probes were drawn from;
- ``ckpt1_params``, ``ckpt1_mu``, ``ckpt1_nu``, ``ckpt1_count``,
  ``ckpt1_key``: the run's state after epoch 1, read from its committed
  orbax checkpoint ``ckpt_00000001`` (flat parameters, Adam's moments and
  step count, the key).

Before writing, it asserts that its key path reproduces the run's initial
parameters (``train.gp.ADJ400K_INIT``), the key of ``ckpt_00000001``
after epochs 0 and 1, and the key of ``ckpt_00000011`` after epoch 11.

Run from the repository root (about 15 s)::

    python scripts/export_gp_adj400k_draws.py [--out PATH]

The default ``--out`` is ``lanczos_adjoints_tpu_torch/train/adj400k_draws.npz``.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "lanczos_adjoints_tpu_torch/train/adj400k_draws.npz"
CHECKPOINTS = (REPO / "results/applications/gaussian_process/train/optim_logml_adjoints_adaptive"
               / "checkpoints_adj400k_synthetic_gp500k_s1")
SEED = 1
NUM_DATA = 500_000
NUM_TRAIN = NUM_DATA * 4 // 5
NUM_TEST = NUM_DATA - NUM_TRAIN
EPOCHS = 3
RUN_EPOCHS = 12
HOST_BATCHES = 5
NUM_SAMPLES = 15


def pack_signs(probes) -> np.ndarray:
    """+-1 probes -> their signs as bits (1 for +1), packed along the last axis."""
    return np.packbits(np.asarray(probes) > 0, axis=-1)


def _checkpoint(step):
    import orbax.checkpoint as ocp

    params, state, key = ocp.PyTreeCheckpointer().restore(str(CHECKPOINTS / f"ckpt_{step:08d}"))
    return params, state["inner_state"][0], np.asarray(key)


def export() -> dict:
    """Every array of the fixture, from the JAX key path on the CPU."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from lanczos_adjoints_tpu.models import gp
    from lanczos_adjoints_tpu.trace import sampler_rademacher
    from lanczos_adjoints_tpu.utils import exp_util
    from lanczos_adjoints_tpu_torch.train.gp import ADJ400K_INIT

    # _common.py:470-505: the split's key, then the initial parameters' key.
    key = jax.random.PRNGKey(SEED)
    key, subkey = jax.random.split(key)
    permutation = np.asarray(jax.random.permutation(subkey, NUM_DATA), dtype=np.int32)
    key, subkey = jax.random.split(key)
    _m, p_mean = gp.mean_constant(shape_out=())
    _k, p_kernel = gp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())
    _l, p_lik = gp.likelihood_pdf_p(None, None, None, constrain=None)
    init, _ = ravel_pytree(exp_util.tree_random_like(subkey, (p_mean, p_kernel, p_lik)))
    np.testing.assert_allclose(np.asarray(init), np.asarray(ADJ400K_INIT), rtol=0, atol=1e-7,
                               err_msg="the key path does not reproduce ADJ400K_INIT")

    # _common.py:551-553 and :376-380: one split an epoch, five host batches of 3 probes.
    sample = sampler_rademacher(jnp.ones((NUM_TRAIN,)), num=NUM_SAMPLES // HOST_BATCHES)
    probes, epoch_keys = [], []
    for epoch in range(RUN_EPOCHS):
        key, subkey = jax.random.split(key)
        if epoch < EPOCHS:
            keys = jax.random.split(subkey, HOST_BATCHES)
            epoch_keys.append(np.asarray(keys))
            probes.append([pack_signs(sample(k)) for k in keys])
        if epoch == 1:
            ckpt1 = _checkpoint(1)
            np.testing.assert_array_equal(np.asarray(key), ckpt1[2], err_msg="key after epoch 1")
    np.testing.assert_array_equal(np.asarray(key), _checkpoint(RUN_EPOCHS - 1)[2],
                                  err_msg="key after epoch 11")
    # _common.py:573-574: mll_eval's probes over the test set.
    key, subkey = jax.random.split(key)
    eval_probes = sampler_rademacher(jnp.ones((NUM_TEST,)), num=NUM_SAMPLES)(subkey)

    params, adam, ckpt_key = ckpt1
    return {
        "permutation": permutation,
        "probes": np.asarray(probes, dtype=np.uint8),
        "epoch_keys": np.asarray(epoch_keys, dtype=np.uint32),
        "eval_probes": pack_signs(eval_probes),
        "eval_key": np.asarray(subkey, dtype=np.uint32),
        "ckpt1_params": np.asarray(params, dtype=np.float32),
        "ckpt1_mu": np.asarray(adam["mu"], dtype=np.float32),
        "ckpt1_nu": np.asarray(adam["nu"], dtype=np.float32),
        "ckpt1_count": np.asarray(adam["count"], dtype=np.int32),
        "ckpt1_key": np.asarray(ckpt_key, dtype=np.uint32),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=FIXTURE)
    args = parser.parse_args(argv)
    arrays = export()
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")
    for name, array in arrays.items():
        print(f"  {name}: {array.dtype} {array.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
