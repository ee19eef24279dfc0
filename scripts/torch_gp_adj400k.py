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

``--epoch0_f64`` instead evaluates epoch 0's SLQ log-determinant on the
JAX run's own split and probes (``train.gp.JaxDraws``) at
``ADJ400K_INIT``: its 15 quadratic forms in float32 through K1 and in
float64 through the plain partitioned policy (100 row blocks, about three
minutes), each host batch's mean and the spread over the five
(``slq_std_rels``), beside the JAX run's. It is the exact-arithmetic
reference that ``chip_smoke.py``'s ``[slice]`` holds ``slq_std_rels[0]``
to (``chip_smoke.SLQ_STD_REL0_F64``).
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


def epoch0_f64() -> int:
    """Epoch 0's 15 SLQ quadratic forms at the JAX draws, float32 (K1) and float64 (plain)."""
    from lanczos_adjoints_tpu_torch.krylov import lanczos
    from lanczos_adjoints_tpu_torch.models import gp
    from lanczos_adjoints_tpu_torch.ops import gram
    from lanczos_adjoints_tpu_torch.trace import slq

    draws = train_gp.JaxDraws()
    args = train_gp.build_argparser(argparse.ArgumentParser()).parse_args(
        [*train_gp.ADJ400K_ARGS, "--num_epochs", "1", "--out", "unused"])
    (X, _y), _test = train_gp.split(args, permutation=draws.permutation)
    key = draws.epoch_key(0, len(X))
    probes = torch.cat([train_gp.sample_given(key) for _ in range(draws.host_batches)])
    _p1, p2, p3 = gp.unflatten_params(torch.tensor(train_gp.ADJ400K_INIT, device="cuda"), 8)
    constrain = gp.constraint_greater_than(train_gp.NOISE_MINVAL)
    batches = {}
    for dtype, policy in ((torch.float32, gram.gram_matvec_fused()),
                          (torch.float64, gram.gram_matvec_partitioned(100, checkpoint=False))):
        kernel = gp.kernel_scaled_matern_32(shape_in=(8,), shape_out=())[0](
            **{k: v.to(dtype) for k, v in p2.items()})
        cov = gp._CovarianceOp(policy, kernel, X.to(dtype))
        integrand = lanczos.integrand_spd_block(slq.log_clipped(), args.num_matvecs,
                                                gp._noisy_matvec(cov, constrain))
        with torch.no_grad():
            quadforms = integrand(probes.T.to(dtype), *kernel.params, p3["raw_noise"].to(dtype))
        quadforms = quadforms.double().cpu().numpy()
        batches[dtype] = quadforms.reshape(draws.host_batches, -1).mean(axis=1)
        print(f"{dtype}: quadratic forms {quadforms.tolist()}")
        print(f"  host batches {batches[dtype].tolist()}, std_rel "
              f"{batches[dtype].std() / abs(batches[dtype].mean()):.6e}")
    b32, b64 = batches[torch.float32], batches[torch.float64]
    std_rel = {name: b.std() / abs(b.mean()) for name, b in (("float32", b32), ("float64", b64))}
    jax_std_rel = float(_jax("slq_std_rels")[0])
    print(f"host batches float32 vs float64: max rel {np.max(np.abs(b32 / b64 - 1)):.3e}; std_rel float32 "
          f"{std_rel['float32']:.6e}, float64 {std_rel['float64']:.6e}, the JAX run {jax_std_rel:.6e} "
          f"({jax_std_rel / std_rel['float64'] - 1:+.3%} from float64)")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None, help="directory for this run's series")
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--epoch0_f64", action="store_true",
                        help="epoch 0's SLQ on the JAX draws in float32 and float64, and nothing else")
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gp_adj400k: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    pin_float32()
    if cli.epoch0_f64:
        return epoch0_f64()
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
