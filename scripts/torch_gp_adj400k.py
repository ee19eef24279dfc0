"""Train the GP at the ``adj400k`` configuration for 12 epochs on one GPU and hold it to the JAX run.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 scripts/torch_gp_adj400k.py [--out DIR] [--epochs 12]``.
It runs ``lanczos_adjoints_tpu_torch.train.gp.run`` with the arguments of
the JAX package's ``adj400k`` run (``train.gp.ADJ400K_ARGS``, from
``scripts/round5_tpu_phase2.sh``: N_train = 400,000, d = 8, rank-500
preconditioner in blocks of 64, 50 partitions, blocked SLQ of 15 Lanczos
steps x 15 probes, adaptive PCG ``atol`` 1.0 with at most 25 steps, the
fused Gram kernels, seed 1) from that run's initial parameters
(``train.gp.ADJ400K_INIT``), then prints each epoch's loss beside the JAX
run's, the final parameters beside its ``params_opt``, the test RMSE and
NLL beside its own, and the seconds of each epoch and of the evaluation,
with the card's name and power limit. The JAX run's outcome is read from
the ``.npy`` files it left under ``results/``
(``train.gp.adj400k_jax_result``); its times are not compared. The eleven
series of this run go to ``--out`` (default: a temporary directory,
removed at the end).
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lanczos_adjoints_tpu_torch.train import gp as train_gp  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

_jax = train_gp.adj400k_jax_result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None, help="directory for this run's series")
    parser.add_argument("--epochs", type=int, default=12)
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gp_adj400k: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    pin_float32()
    with tempfile.TemporaryDirectory() as tmp:
        out = cli.out or tmp
        args = train_gp.build_argparser(argparse.ArgumentParser()).parse_args(
            [*train_gp.ADJ400K_ARGS, "--num_epochs", str(cli.epochs), "--out", out])
        result = train_gp.run(args, solver_mode="adaptive", params0=np.asarray(train_gp.ADJ400K_INIT))

    losses, jax_losses = np.asarray(result.series["loss_curve"]), _jax("loss_curve")
    stamps = np.asarray(result.series["loss_timestamps"])
    epoch_s = np.diff(np.concatenate([[0.0], stamps]))
    print("epoch  loss (port)  loss (JAX run)  gap      seconds")
    for i, (loss, want, secs) in enumerate(zip(losses, jax_losses, epoch_s)):
        print(f"{i:5d}  {loss:.6f}     {want:.6f}        {loss / want - 1:+.3%}  {secs:.3f}")
    params, jax_params = result.params.cpu().numpy(), _jax("params_opt")
    print("params_opt (port):", [round(float(p), 6) for p in params])
    print("params_opt (JAX): ", [round(float(p), 6) for p in jax_params])
    want = {"rmse": float(_jax("test_rmses")), "nll": float(_jax("test_nlls"))}
    print(f"test RMSE {result.test_rmse:.6f} (JAX run {want['rmse']:.6f}, gap "
          f"{result.test_rmse / want['rmse'] - 1:+.3%}); test NLL {result.test_nll:.6f} (JAX run "
          f"{want['nll']:.6f}, gap {result.test_nll / want['nll'] - 1:+.3%})")
    print(f"evaluation: predict_mean {result.seconds['predict_mean']:.3f} s "
          f"({float(result.predict_info['solve']['num_steps']):.0f} PCG steps), mll_eval "
          f"{result.seconds['mll_eval']:.3f} s ({float(result.eval_info['logpdf']['solve']['num_steps']):.0f} "
          f"PCG steps)")
    print(json.dumps({
        "card": card, "loss_curve": losses.tolist(), "jax_loss_curve": jax_losses.tolist(),
        "gaps": (losses / jax_losses[: len(losses)] - 1).tolist(), "epoch_s": epoch_s.tolist(),
        "params_opt": params.tolist(), "jax_params_opt": jax_params.tolist(),
        "test_rmse": result.test_rmse, "test_nll": result.test_nll, "jax": want,
        "eval_s": result.seconds, "series": {k: result.series[k] for k in ("cg_errors", "cg_numsteps_all",
                                                                             "noise_curve", "notfinite_curve")},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
