"""The test-NLL estimator study: a trained run's ``params_opt`` under three NLL estimators.

Counterpart of ``experiments/applications/gaussian_process/train/nll_study.py``,
on the GP driver's own ``assemble``/``mll_eval``. The test NLL a run
reports is itself an SLQ estimate, so a gap to a reference can come from
the learned hyperparameters or from the estimator. Given a run's saved
``{--name}_{--dataset}_s{--seed}_params_opt.npy`` (read from ``--out``,
else from the JAX driver's results directory), this re-evaluates the
test-set NLL on the driver's split with

- ``mll_eval`` as trained (``log_clipped`` SLQ),
- ``mll_eval`` with the plain log (the reference's estimator),
- the exact dense Cholesky log-pdf,

the two SLQ estimates over ``--num_eval_keys`` generators (seeds 100,
101, ...), and prints the learned noise and outputscale beside them. As
in the JAX script: per-probe SLQ, a sequential pivoted Cholesky of rank
100, PCG to ``atol=1e-4``. ``--draws PATH`` (e.g. ``train.gp.DRAWS``)
splits with a JAX run's exported permutation, which its ``params_opt``
was trained on, in place of numpy's from ``--seed``.

    python -m lanczos_adjoints_tpu_torch.train.nll_study --name NAME --dataset elevators [--out DIR]
"""

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import gp
from lanczos_adjoints_tpu_torch.train import gp as train_gp
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32, requires_float32

ESTIMATORS = ("log_clipped", "plain log")


def build_argparser(parser):
    """The JAX script's arguments, plus the driver's ``--matvec``, ``--num_data``,
    ``--mesh`` (for its split), ``--device``, ``--out`` and ``--draws``."""
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="elevators")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--num_matvecs", type=int, default=10)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--num_eval_keys", type=int, default=5)
    parser.add_argument("--num_partitions", type=int, default=1)
    parser.add_argument("--matvec", type=str, default="auto", choices=["auto", "fused"])
    parser.add_argument("--num_data", type=int, default=-1)
    parser.add_argument("--mesh", type=str, default="1")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, default=None,
                        help="directory of the run's params_opt (default: the JAX driver's results)")
    parser.add_argument("--draws", type=str, default=None,
                        help="a JAX run's exported draws, whose permutation splits the data")
    return parser


def params_path(args) -> Path:
    directory = Path(args.out) if args.out else train_gp.ADJ400K_JAX_RUN
    return directory / f"{args.name}_{args.dataset}_s{args.seed}_params_opt.npy"


@requires_float32
@torch.no_grad()
def study(args, *, probes=None) -> dict:
    """The exact test NLL and the two SLQ estimates (one per generator).

    ``probes``: ``--num_eval_keys`` blocks of ``(--num_samples, n_test)``
    probes to take in place of the generators' draws.
    """
    path = params_path(args)
    if not os.path.exists(path):
        msg = f"no saved params at {path}; train first"
        raise FileNotFoundError(msg)
    permutation = None if args.draws is None else train_gp.JaxDraws(args.draws, device=args.device).permutation
    (_train_x, _train_y), (test_x, test_y) = train_gp.split(args, permutation=permutation)
    print(f"test set: {tuple(test_x.shape)}")
    ndim = test_x.shape[-1]
    params = torch.as_tensor(np.load(path), dtype=torch.float32, device=args.device)

    stacks = {}
    for label, log in zip(ESTIMATORS, ("clipped", "plain")):
        stacks[label] = train_gp.assemble(
            n_train=len(test_x), ndim=ndim, num_matvecs=args.num_matvecs, num_samples=args.num_samples,
            rank_precon=100, precon_block=1, matvec=train_gp.gram_policy(args.matvec, args.num_partitions),
            slq="vmap", device=args.device, eval_log=log,
            eval_sample=None if probes is None else train_gp.sample_given,
        )
    stack = stacks[ESTIMATORS[0]]
    p1, p2, p3 = gp.unflatten_params(params, ndim)
    learned = {"noise": float(stack.constrain(p3["raw_noise"])),
               "outputscale": float(stack.constrain(p2["raw_outputscale"])),
               "lengthscale_mean": float(torch.mean(stack.constrain(p2["raw_lengthscale"])))}
    print(f"learned noise {learned['noise']:.5f}  outputscale {learned['outputscale']:.4f}  "
          f"lengthscale|mean| {learned['lengthscale_mean']:.4f}")

    likelihood, _ = gp.likelihood_pdf(gp.gram_matvec(), gp.logpdf_cholesky(), constrain=stack.constrain)
    value, _ = gp.target_logml(stack.prior, likelihood)(
        test_x, test_y, params_mean=p1, params_kernel=p2, params_likelihood=p3)
    result = {"exact": float(-value / len(test_x)), **learned}
    print(f"exact Cholesky test NLL: {result['exact']:.4f}")

    for label, stack_ in stacks.items():
        values = []
        for i in range(args.num_eval_keys):
            key = (torch.Generator(device=args.device).manual_seed(100 + i) if probes is None
                   else train_gp.GivenProbes([probes[i]]))
            values.append(float(stack_.mll_eval(params, key, test_x, test_y)[0]))
        result[label] = values
        mean = float(np.mean(values))
        print(f"SLQ ({label:>11}) NLL: {mean:.4f} +/- {float(np.std(values)):.4f} "
              f"(bias vs exact {mean - result['exact']:+.4f})")
    return result


def main(argv=None) -> int:
    args = build_argparser(argparse.ArgumentParser(description=__doc__.splitlines()[0])).parse_args(argv)
    print(args)
    pin_float32()
    study(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
