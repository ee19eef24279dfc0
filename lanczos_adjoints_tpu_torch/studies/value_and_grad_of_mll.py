"""The time of ``value_and_grad`` of the GP log-marginal likelihood, per Gram matvec policy.

Counterpart of ``experiments/benchmarks/value_and_grad_of_mll/benchmark.py``:
N points in d dimensions (standard normal, drawn with numpy from
``--seed``), targets ``sin(x[:, 0])``, a constant mean and a scaled
Matern-3/2 kernel at zero raw parameters, the likelihood
``models.gp.likelihood_pdf`` over ``logpdf_krylov`` with fixed-step CG
(``--num_matvecs`` steps) and the SLQ log-determinant
(``trace.slq.krylov_logdet_slq``: ``--num_matvecs`` Lanczos steps,
``--num_samples`` batches of one Rademacher probe). The value and the
gradient in the kernel's raw parameters of the negative log-marginal
likelihood, under the plain policies ``vmap`` (``ops.gram.gram_matvec()``)
and ``partitioned(P)`` (``gram_matvec_partitioned(P, checkpoint=True)``).
The probes are drawn with numpy from ``--seed`` and given to the
estimator through ``train.gp.GivenProbes``: the JAX script's keys and a
torch generator never draw the same signs.

``python -m lanczos_adjoints_tpu_torch.studies.value_and_grad_of_mll
[--num_data 16384] [--data_dim 4] [--num_matvecs 10] [--num_samples 2]
[--num_partitions 16] [--seed 0] [--device cuda] --out DIR`` writes
``mll_times.json`` (``{"policy", "time_s", "n"}``: the median over 5
calls after a warm-up, CUDA events on the card). A policy that runs out
of memory is printed as failed and left out of the file, as the JAX
script does; a ``--num_partitions`` that does not divide ``--num_data``
is refused before any run.
"""

import argparse
import json
import os

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import gp
from lanczos_adjoints_tpu_torch.solvers import cg
from lanczos_adjoints_tpu_torch.trace import slq
from lanczos_adjoints_tpu_torch.train.gp import GivenProbes, sample_given
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import median_seconds

TIMED_RUNS = 5


def problem(num_data, data_dim, *, seed=0, device="cuda"):
    """``(x, y)``: standard-normal points from numpy and ``sin(x[:, 0])``."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((num_data, data_dim)), dtype=torch.float32, device=device)
    return x, torch.sin(x[:, 0])


def probes(num_data, num_samples, runs, *, seed=0) -> np.ndarray:
    """``(runs, num_samples, 1, num_data)`` Rademacher signs: one block a batch, a set a call."""
    rng = np.random.default_rng(seed + 1)
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=(runs, num_samples, 1, num_data))


def policies(num_partitions) -> dict:
    return {"vmap": gp.gram_matvec(),
            f"partitioned({num_partitions})": gp.gram_matvec_partitioned(num_partitions, checkpoint=True)}


def value_and_grad_fn(gram, data_dim, num_matvecs, num_samples):
    """``vag(x, y, blocks) -> (value, {"raw_lengthscale", "raw_outputscale"} gradients)`` at zero raw parameters."""
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = gp.kernel_scaled_matern_32(shape_in=(data_dim,), shape_out=())
    prior = gp.model_gp(mean, kernel)
    logdet = slq.krylov_logdet_slq(num_matvecs, sample=sample_given, num_batches=num_samples,
                                   checkpoint=True)
    likelihood, _ = gp.likelihood_pdf(gram, gp.logpdf_krylov(cg.cg_fixed_step(num_matvecs), logdet),
                                      constrain=gp.constraint_greater_than(1e-4))
    mll = gp.target_logml(prior, likelihood)

    def vag(x, y, blocks):
        device = x.device
        pk = {"raw_lengthscale": torch.zeros(data_dim, device=device, requires_grad=True),
              "raw_outputscale": torch.zeros((), device=device, requires_grad=True)}
        key = GivenProbes(torch.as_tensor(b, device=device) for b in blocks)
        value, _info = mll(x, y, key, params_mean={"constant_value": torch.zeros((), device=device)},
                           params_kernel=pk, params_likelihood={"raw_noise": torch.zeros((), device=device)})
        loss = -value
        grads = torch.autograd.grad(loss, [pk["raw_lengthscale"], pk["raw_outputscale"]])
        return loss.detach(), dict(zip(("raw_lengthscale", "raw_outputscale"), grads))

    return vag


def run(args) -> tuple:
    """Returns ``(results, outputs)``: the JSON rows and each policy's first ``(value, grads)``."""
    x, y = problem(args.num_data, args.data_dim, seed=args.seed, device=args.device)
    signs = probes(args.num_data, args.num_samples, TIMED_RUNS + 1, seed=args.seed)
    results, outputs = [], {}
    for name, gram in policies(args.num_partitions).items():
        vag = value_and_grad_fn(gram, args.data_dim, args.num_matvecs, args.num_samples)
        try:
            outputs[name] = vag(x, y, signs[0])  # also the warm-up
            timed = iter(signs[1:])  # fresh probes a call
            t = median_seconds(lambda: vag(x, y, next(timed)), device=args.device, reps=1, outer=TIMED_RUNS)
        except torch.OutOfMemoryError as err:
            torch.cuda.empty_cache()
            print(f"{name}: failed ({type(err).__name__})", flush=True)
            continue
        print(f"{name}: {t * 1e3:.1f} ms per value_and_grad", flush=True)
        results.append({"policy": name, "time_s": t, "n": args.num_data})
    return results, outputs


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_data", type=int, default=16384)
    parser.add_argument("--data_dim", type=int, default=4)
    parser.add_argument("--num_matvecs", type=int, default=10)
    parser.add_argument("--num_samples", type=int, default=2)
    parser.add_argument("--num_partitions", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    if args.num_data % args.num_partitions:
        parser.error(f"--num_partitions {args.num_partitions} does not divide --num_data {args.num_data}")
    return args


def main(argv=None):
    args = parse_args(argv)
    print(args)
    pin_float32()
    results, outputs = run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "mll_times.json"), "w") as fp:
        json.dump(results, fp, indent=2)
    return results, outputs


if __name__ == "__main__":
    main()
