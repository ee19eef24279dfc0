"""The GP marginal-likelihood training driver.

Counterpart of ``experiments/applications/gaussian_process/train/_common.py``
and of ``dryrun_multichip`` in ``__graft_entry__.py``: a scaled
Matern-3/2 kernel with ARD lengthscales; the Gram matvec policy of the
driver's ``--matvec`` (``auto``, the default: the plain PyTorch Gram,
dense for one partition, ``ops.gram.gram_matvec_partitioned`` for more;
or ``fused``: the CUDA kernels); SLQ (``num_matvecs`` Lanczos steps x
``num_samples`` Rademacher probes, ``log_clipped``; blocked, or per probe
as the driver's ``--slq vmap``; with ``--split_step --slq_host_batches
B``, B estimates of ``num_samples / B`` probes each, averaged); adaptive
or fixed-step PCG (``solver_mode``) with a pivoted partial-Cholesky
preconditioner (blocked, or sequential for
``precon_block=1``); Adam on the flat parameter vector with non-finite
steps skipped (``optax.apply_if_finite``); the driver's ``--mesh R`` /
``RxS``: the Gram matvec row-partitioned over ``R`` partitions and, per
probe, the probes over ``S``. ``run`` is the driver's epoch loop, with
its checkpoints, its test-set evaluation (``predict_mean``, ``rmse``,
``mll_eval``) and its eleven ``.npy`` series; ``python -m
lanczos_adjoints_tpu_torch.train.gp --solver_mode adaptive|fixed ...``
runs it with the JAX driver's arguments.

The JAX driver's ``--split_step`` splits its step into three device
calls, which sum to the one-call step; the port accepts it and computes
the step in one graph, and takes ``--slq_host_batches`` from it, since
the batches decide which probes a key draws and the ``slq_std_rels``
series. Its ``predict_mean_split`` (a restarted PCG to the same
tolerance) is not ported: ``predict_mean`` solves in one PCG.
``--device`` (default ``cuda``) takes the place of ``--cpu``, and
``--out DIR`` that of the results directory mirrored from the script's
path. ``JaxDraws`` holds the JAX ``adj400k`` run's own split and probes
(``adj400k_draws.npz``, written by ``scripts/export_gp_adj400k_draws.py``),
which ``run(..., draws=...)`` trains on in place of its own.
"""

import argparse
import math
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from lanczos_adjoints_tpu_torch import parallel
from lanczos_adjoints_tpu_torch.models import gp
from lanczos_adjoints_tpu_torch.ops import gram
from lanczos_adjoints_tpu_torch.precond import low_rank
from lanczos_adjoints_tpu_torch.solvers import cg
from lanczos_adjoints_tpu_torch.trace import hutchinson
from lanczos_adjoints_tpu_torch.trace import slq as trace_slq
from lanczos_adjoints_tpu_torch.utils import checkpoint, data, uci
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32, requires_float32

NOISE_MINVAL = 1e-4
# The JAX package's ``adj400k`` run (``scripts/round5_tpu_phase2.sh:18-20``):
# its driver arguments, less ``--checkpoint_every`` and ``--resume``, and
# the prefix of the ``.npy`` files it left (``adj400k_jax_result``).
ADJ400K_ARGS = (
    "--name", "adj400k", "--seed", "1", "--dataset", "synthetic_gp500k", "--rank_precon", "500",
    "--num_partitions", "50", "--num_matvecs", "15", "--num_samples", "15", "--cg_tol", "1.0",
    "--slq", "blocked", "--matvec", "fused", "--precon_block", "64", "--cg_maxiter", "25",
    "--split_step", "--slq_host_batches", "5",
)
# That run's split, probes and state after epoch 1 (``JaxDraws``).
DRAWS = Path(__file__).with_name("adj400k_draws.npz")
ADJ400K_JAX_RUN = (
    Path(__file__).resolve().parents[2]
    / "results/applications/gaussian_process/train/optim_logml_adjoints_adaptive"
)
# The JAX driver's initial parameters for ``--seed 1``:
# ``exp_util.tree_random_like`` under its key splits PRNGKey(1) -> split ->
# split (``_common.py:470-471,504-505``), in the flat order
# [constant, raw_lengthscale x 8, raw_outputscale, raw_noise].
ADJ400K_INIT = (
    0.947751522064209, -0.9447869062423706, -0.8536641597747803, -0.5306494832038879,
    -0.6204848885536194, 0.9636664390563965, -1.1324776411056519, -0.5327290892601013,
    0.47767162322998047, 0.865656316280365, 0.3122757077217102,
)
# The eleven series ``run`` writes, under the JAX driver's file names.
SERIES = ("loss_timestamps", "loss_curve", "cg_errors", "cg_numsteps_all", "slq_std_rels",
          "noise_curve", "outputscale_curve", "notfinite_curve")
RESULTS = (*SERIES, "test_rmses", "test_nlls", "params_opt")


def adj400k_jax_result(name: str, /) -> np.ndarray:
    """One of the eleven ``.npy`` files of the JAX ``adj400k`` run, e.g. ``"loss_curve"``."""
    return np.load(ADJ400K_JAX_RUN / f"adj400k_synthetic_gp500k_s1_{name}.npy")


def load_data(which: str, /):
    """The dataset ``uci.uci_{which}``, normalised. A UCI dataset whose files
    are not in ``./data`` or the repository's ``data`` raises the loader's
    ``FileNotFoundError``; ``synthetic_gp500k`` is made in process."""
    loader = getattr(uci, f"uci_{which}", None)
    if loader is None:
        msg = f"Unknown dataset {which!r}"
        raise ValueError(msg)
    return loader(normalize=True)


def unpack_signs(packed, n: int, *, device="cuda"):
    """``np.packbits`` signs (bit 1 for +1, along the last axis) -> float32 +-1 probes of ``n``."""
    packed = np.asarray(packed)
    if n > 8 * packed.shape[-1]:
        msg = f"{packed.shape[-1]} bytes hold fewer than {n} signs"
        raise ValueError(msg)
    bits = np.unpackbits(packed, axis=-1, count=n)
    return torch.tensor(bits, device=device).to(torch.float32) * 2 - 1


class GivenProbes:
    """A key whose probes are given: ``sample_given`` takes its blocks in order,
    one a call, where a generator's sampler would draw them."""

    def __init__(self, blocks):
        self._blocks = list(blocks)

    def next(self):
        if not self._blocks:
            msg = "every given probe block has been drawn"
            raise ValueError(msg)
        return self._blocks.pop(0)

    def __len__(self):
        return len(self._blocks)


def sample_given(key: GivenProbes):
    """The ``sample`` of a ``GivenProbes`` key: its next ``(num, n)`` block."""
    return key.next()


class JaxDraws:
    """The JAX ``adj400k`` run's own draws, exported by ``scripts/export_gp_adj400k_draws.py``.

    ``permutation``: its train/test split; ``epoch_key(epoch, n)``: the
    ``GivenProbes`` of an exported epoch (its host batches' probes, in
    order); ``eval_key(n)``: ``mll_eval``'s probes after the run's last
    epoch; ``arrays``: every array of the file, the state of the run's
    checkpoint after epoch 1 (``ckpt1_*``) among them.
    """

    def __init__(self, path=DRAWS, *, device="cuda"):
        with np.load(path) as npz:
            self.arrays = {name: npz[name] for name in npz.files}
        self.permutation = self.arrays["permutation"]
        self.device = device
        self.num_epochs, self.host_batches, self.num_per_batch, _ = self.arrays["probes"].shape

    def epoch_key(self, epoch: int, n: int) -> GivenProbes:
        if not 0 <= epoch < self.num_epochs:
            msg = f"the draws hold epochs 0-{self.num_epochs - 1}, not {epoch}"
            raise ValueError(msg)
        return GivenProbes(unpack_signs(block, n, device=self.device) for block in self.arrays["probes"][epoch])

    def eval_key(self, n: int) -> GivenProbes:
        return GivenProbes([unpack_signs(self.arrays["eval_probes"], n, device=self.device)])


def rmse(x, *, target):
    return torch.sqrt(torch.mean((x - target) ** 2))


def build_argparser(parser):
    """The JAX driver's arguments (``_common.py:39``), less ``--cpu``, plus
    ``--device`` and ``--out``."""
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--rank_precon", type=int, required=True)
    parser.add_argument(
        "--slq", type=str, default="vmap", choices=["vmap", "blocked"],
        help="SLQ probe execution: 'vmap' = per-probe recurrences; 'blocked' = "
        "multi-RHS recurrences, one operator application per step for all probes",
    )
    parser.add_argument(
        "--matvec", type=str, default="auto", choices=["auto", "fused"],
        help="Gram matvec policy: 'auto' = the plain PyTorch Gram, dense for one "
        "partition, else partitioned per --num_partitions; 'fused' = the CUDA kernels",
    )
    parser.add_argument(
        "--precon_block", type=int, default=1,
        help="pivots per sweep for the blocked partial Cholesky (1=sequential)",
    )
    parser.add_argument(
        "--mesh", type=str, default="1",
        help="partition mesh 'R' or 'RxS': the Gram matvec row-partitioned R ways "
        "and, per probe, the SLQ probes S ways",
    )
    parser.add_argument(
        "--train_log", type=str, default="clipped", choices=["clipped", "plain"],
        help="SLQ matfun during training: 'clipped' (log_clipped) or 'plain' (log)",
    )
    parser.add_argument(
        "--split_step", action="store_true",
        help="the JAX driver's three-call step; the same value and gradient, computed "
        "here in one graph. Enables --slq_host_batches",
    )
    parser.add_argument(
        "--slq_host_batches", type=int, default=1,
        help="(--split_step only) the SLQ logdet as this many estimates of "
        "num_samples/B probes each, averaged; slq_std_rels is their spread",
    )
    parser.add_argument("--cg_maxiter", type=int, default=1000,
                        help="adaptive-CG iteration cap for the training solve")
    parser.add_argument("--num_partitions", type=int, required=True)
    parser.add_argument("--num_matvecs", type=int, required=True)
    parser.add_argument("--num_samples", type=int, required=True)
    parser.add_argument("--num_epochs", type=int, required=True)
    parser.add_argument("--num_data", type=int, default=-1)
    parser.add_argument("--cg_tol", type=float, default=1e-2)
    parser.add_argument("--learning_rate", type=float, default=0.05)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True,
                        help="directory for the .npy series and the checkpoints")
    return parser


def gram_policy(matvec: str, num_partitions: int):
    """The Gram policy of the driver's ``--matvec`` (``_common.py:218-223``):
    ``fused`` -> the CUDA kernels (``ops.gram.gram_matvec_fused``, which
    launches K1/K2 on a CUDA tensor or raises); ``auto`` -> the plain
    PyTorch Gram on any device, dense for one partition, else
    ``num_partitions`` row blocks, each recomputed in the backward pass."""
    if matvec == "fused":
        return gram.gram_matvec_fused()
    if matvec != "auto":
        msg = f"matvec={matvec!r}; choose 'auto' or 'fused'"
        raise ValueError(msg)
    if num_partitions == 1:
        return gram.gram_matvec()
    return gram.gram_matvec_partitioned(num_partitions, checkpoint=True)


def parse_mesh(spec: str) -> tuple:
    """'R' or 'RxS' -> (rows_way, probes_way)."""
    if "x" in spec:
        rows_way, probes_way = spec.split("x")
        return int(rows_way), int(probes_way)
    return int(spec), 1


def build_mesh(rows_way: int, probes_way: int, *, device="cuda"):
    """The ``rows x probes`` mesh of partitions on ``device``."""
    return parallel.make_mesh({"rows": rows_way, "probes": probes_way}, device=device)


def assemble(
    *,
    n_train: int,
    ndim: int,
    num_matvecs: int = 15,
    num_samples: int = 15,
    rank_precon: int = 500,
    precon_block: int = 64,
    cg_tol: float = 1.0,
    cg_rtol: float = 0.0,
    cg_maxiter: int = 25,
    cg_miniter: int = 10,
    sample=None,
    matvec=None,
    slq: str = "blocked",
    mesh: str = "1",
    device="cuda",
    solver_mode: str = "adaptive",
    train_log: str = "clipped",
    eval_sample=None,
    slq_host_batches: int = 1,
    eval_log: str = "clipped",
):
    """Build the training loss ``mll_lanczos(params, key, Xs, ys) -> (-mll / N, info)``
    and the evaluation closures ``mll_eval`` and ``predict_mean``.

    Defaults are the reference's largest run (rank-500 preconditioner
    rounded down to a multiple of ``precon_block``, 15 Lanczos steps x 15
    probes, CG ``atol=1.0, rtol=0, maxiter=25, miniter=10``). ``key`` is
    the ``torch.Generator`` that ``sample`` draws its probes from; pass
    ``sample`` to feed fixed probes instead. ``matvec`` is the Gram matvec
    policy (default: the fused CUDA kernels, ``ops.gram.gram_matvec_fused``).
    ``slq`` is the driver's ``--slq``: ``"blocked"`` or ``"vmap"``
    (per probe). ``precon_block=1`` takes the sequential pivoted
    Cholesky. ``mesh`` is the driver's ``--mesh``: ``"R"`` wraps the
    policy in ``parallel.sharded_gram_policy`` over ``R`` row partitions,
    ``"RxS"`` also splits the per-probe mode's probes over ``S``; blocked
    SLQ with ``S > 1`` raises, as in the JAX driver. ``solver_mode`` is
    ``"adaptive"`` (the PCG above) or ``"fixed"`` (``num_matvecs`` PCG
    steps); ``train_log`` the driver's ``--train_log``: ``"clipped"``
    (``log_clipped``) or ``"plain"`` (``torch.log``) for the training SLQ.
    ``slq_host_batches`` is the driver's ``--slq_host_batches``: the
    training logdet is the mean of that many estimates, each over
    ``num_samples / slq_host_batches`` probes (each a call of ``sample``),
    and its ``std_rel`` their spread.

    ``mll_eval(params, key, Xs, ys)`` is the loss on an evaluation set:
    probes of its size (``eval_sample``, or drawn from ``key``),
    ``log_clipped`` (or ``torch.log`` for ``eval_log="plain"``), PCG
    ``atol=1e-4, rtol=0, maxiter=10_000,
    miniter=10``. ``predict_mean(params, x, Xs, ys) -> (mean, {"solve":
    info})`` is the posterior mean at ``x`` given the training set, PCG
    ``atol=1e-2, rtol=0, maxiter=10_000, miniter=10``. Both run without
    a graph.
    """
    if slq not in ("blocked", "vmap"):
        msg = f"slq={slq!r}; choose 'blocked' or 'vmap'"
        raise ValueError(msg)
    for name, log in (("train_log", train_log), ("eval_log", eval_log)):
        if log not in ("clipped", "plain"):
            msg = f"{name}={log!r}; choose 'clipped' or 'plain'"
            raise ValueError(msg)
    rows_way, probes_way = parse_mesh(str(mesh))
    mesh_ = probe_sharding = None
    if rows_way * probes_way > 1:
        if slq == "blocked" and probes_way > 1:
            msg = (
                "blocked SLQ amortises kernel tiles across probes within "
                "each partition; use mesh='R' (rows only) with slq='blocked'"
            )
            raise ValueError(msg)
        mesh_ = build_mesh(rows_way, probes_way, device=device)
        if probes_way > 1:
            probe_sharding = parallel.NamedSharding(mesh_, "probes")
    if solver_mode == "adaptive":
        solve_p = cg.pcg_adaptive(atol=cg_tol, rtol=cg_rtol, maxiter=cg_maxiter, miniter=cg_miniter)
    elif solver_mode == "fixed":
        solve_p = cg.pcg_fixed_step(num_matvecs)
    else:
        msg = f"solver_mode={solver_mode!r}; choose 'adaptive' or 'fixed'"
        raise ValueError(msg)
    if num_samples % slq_host_batches:
        msg = f"--slq_host_batches {slq_host_batches} must divide --num_samples {num_samples}"
        raise ValueError(msg)
    if sample is None:
        sample = hutchinson.sampler_rademacher(
            torch.ones((n_train,), device=device), num=num_samples // slq_host_batches
        )
    logdet = trace_slq.krylov_logdet_slq(
        num_matvecs,
        sample=sample,
        num_batches=slq_host_batches,
        checkpoint=True,
        matfun=trace_slq.log_clipped() if train_log == "clipped" else torch.log,
        blocked=slq == "blocked",
        probe_sharding=probe_sharding,
    )
    rank = int(min(rank_precon, n_train))
    if precon_block > 1:
        # Round the rank down to a block multiple (blocked sweeps).
        rank = max(precon_block, rank // precon_block * precon_block)
        cholesky = low_rank.cholesky_partial_pivot_blocked(rank=rank, block=precon_block)
    else:
        cholesky = low_rank.cholesky_partial_pivot(rank=rank)
    precondition = low_rank.preconditioner(cholesky)
    logpdf_p = gp.logpdf_krylov_p(solve_p, logdet)
    constrain = gp.constraint_greater_than(NOISE_MINVAL)
    policy = matvec or gram.gram_matvec_fused()
    if mesh_ is not None:
        policy = parallel.sharded_gram_policy(policy, mesh_)
    likelihood, _ = gp.likelihood_pdf_p(policy, logpdf_p, precondition, constrain=constrain)
    mean, _ = gp.mean_constant(shape_out=())
    kernel, _ = gp.kernel_scaled_matern_32(shape_in=(ndim,), shape_out=())
    prior = gp.model_gp(mean, kernel)
    loss = gp.target_logml(prior, likelihood)

    @requires_float32
    def mll_lanczos(params, key, Xs, ys):
        p1, p2, p3 = gp.unflatten_params(params, ndim)
        value, info = loss(
            Xs, ys, key, params_mean=p1, params_kernel=p2, params_likelihood=p3
        )
        return -value / len(Xs), info

    @requires_float32
    @torch.no_grad()
    def mll_eval(params, key, Xs, ys):
        sample_ = eval_sample or hutchinson.sampler_rademacher(
            torch.ones((len(Xs),), device=Xs.device), num=num_samples
        )
        logdet_ = trace_slq.krylov_logdet_slq(
            num_matvecs, sample=sample_, num_batches=1, checkpoint=True,
            matfun=trace_slq.log_clipped() if eval_log == "clipped" else torch.log, blocked=slq == "blocked",
        )
        solve_ = cg.pcg_adaptive(atol=1e-4, rtol=0.0, maxiter=10_000, miniter=10)
        likelihood_, _ = gp.likelihood_pdf_p(
            policy, gp.logpdf_krylov_p(solve_, logdet_), precondition, constrain=constrain
        )
        p1, p2, p3 = gp.unflatten_params(params, ndim)
        value, info = gp.target_logml(prior, likelihood_)(
            Xs, ys, key, params_mean=p1, params_kernel=p2, params_likelihood=p3
        )
        return -value / len(Xs), info

    @requires_float32
    @torch.no_grad()
    def predict_mean(params, x, Xs, ys):
        solve_ = cg.pcg_adaptive(atol=1e-2, rtol=0.0, maxiter=10_000, miniter=10)
        likelihood_, _ = gp.likelihood_condition_p(
            policy, solve_, precondition=precondition, constrain=constrain
        )
        p1, p2, p3 = gp.unflatten_params(params, ndim)
        postmean, _ = gp.target_posterior(prior, likelihood_)(
            Xs, ys, params_mean=p1, params_kernel=p2, params_likelihood=p3
        )
        return postmean(x)

    return SimpleNamespace(
        mll_lanczos=mll_lanczos, mll_eval=mll_eval, predict_mean=predict_mean,
        constrain=constrain, num_params=ndim + 3, rank=rank, mesh=mesh_, prior=prior,
    )


class AdamIfFinite:
    """``torch.optim.Adam`` on one flat vector, skipping non-finite gradients.

    The semantics of ``optax.apply_if_finite(optax.adam(lr),
    max_consecutive_errors)``: a step whose gradient holds a NaN or inf
    leaves the parameters and Adam's state untouched, unless more than
    ``max_consecutive_errors`` such steps came in a row.
    """

    def __init__(self, params, *, lr: float, max_consecutive_errors: int = 25):
        self.params = params
        self.adam = torch.optim.Adam([params], lr=lr)
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0

    def step(self) -> bool:
        """Apply the gradient in ``params.grad`` if allowed; return whether it was."""
        finite = bool(torch.all(torch.isfinite(self.params.grad)))
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        applied = finite or self.notfinite_count > self.max_consecutive_errors
        if applied:
            self.adam.step()
        self.adam.zero_grad()
        return applied


def train_step(stack, optimizer: AdamIfFinite, key, Xs, ys):
    """One Adam step on ``stack.mll_lanczos``: ``(loss, info, gradient, applied)``."""
    value, info = stack.mll_lanczos(optimizer.params, key, Xs, ys)
    value.backward()
    grad = optimizer.params.grad.detach().clone()
    applied = optimizer.step()
    return value.detach(), info, grad, applied


def split(args, *, permutation=None):
    """The driver's train/test split: ``--num_data`` rows, rounded down so
    that ``--num_partitions`` (and the mesh's rows) divide the training set,
    shuffled by ``permutation`` (default: numpy's with ``--seed``) and split
    0.8 / 0.2, as tensors on ``--device``."""
    inputs, targets = load_data(args.dataset)
    if args.num_data > 0:
        inputs, targets = inputs[: args.num_data], targets[: args.num_data]
    rows_way, _probes_way = parse_mesh(str(args.mesh))
    coeff = len(inputs) // (5 * args.num_partitions)
    if rows_way > 1:
        coeff = coeff // rows_way * rows_way
    num_data = coeff * 5 * args.num_partitions
    parts = data.split_train_test_shuffle(
        args.seed if permutation is None else permutation, inputs[:num_data], targets[:num_data],
        train_fraction=0.8,
    )
    return [tuple(torch.tensor(a, device=args.device) for a in part) for part in parts]


def _training_state(optimizer: AdamIfFinite, key, series: dict) -> dict:
    return {
        "params": optimizer.params.detach(),
        "adam": optimizer.adam.state_dict(),
        "notfinite_count": optimizer.notfinite_count,
        "total_notfinite": optimizer.total_notfinite,
        "generator": key.get_state(),
        "series": series,
    }


def run(args, *, solver_mode: str, params0=None, draws=None):
    """Train the GP hyperparameters for ``--num_epochs``, then evaluate on the test set.

    ``solver_mode`` is ``"adaptive"`` or ``"fixed"``. ``params0`` (any
    array of ``num_params`` floats) defaults to a standard-normal draw from
    a ``torch.Generator`` seeded with ``--seed``, which differs from the
    JAX driver's draw from its key (``ADJ400K_INIT`` is that draw for
    seed 1). Every epoch's probes come from one ``torch.Generator`` on the
    device, seeded with ``--seed``, which the test-set evaluation then
    draws from too; ``draws`` (a ``JaxDraws``) replaces the split and every
    probe by the JAX run's, and then the epochs may not outrun its
    exported ones. ``--checkpoint_every k`` saves the parameters, Adam's
    state, the skip counters, the generator and the series so far after
    every k-th epoch under ``--out``; ``--resume`` continues from the
    latest of them, so a resumed run's series equal the uninterrupted
    run's. Writes the eleven ``.npy`` files
    ``{--out}/{--name}_{--dataset}_s{--seed}_*.npy``. Returns the test
    RMSE and NLL, the parameters, the series, the evaluations' info and
    their wall times.
    """
    policy = gram_policy(args.matvec, args.num_partitions)
    host_batches = args.slq_host_batches if args.split_step else 1
    if draws is not None and (draws.host_batches, draws.num_per_batch) != (
            host_batches, args.num_samples // host_batches):
        msg = (f"the draws hold {draws.host_batches} host batches of {draws.num_per_batch} probes, not "
               f"{host_batches} of {args.num_samples // host_batches}")
        raise ValueError(msg)
    (train_x, train_y), (test_x, test_y) = split(
        args, permutation=None if draws is None else draws.permutation)
    print(f"dataset {args.dataset}: train {tuple(train_x.shape)}, test {tuple(test_x.shape)}")
    ndim = train_x.shape[-1]
    given = {} if draws is None else {"sample": sample_given, "eval_sample": sample_given}
    stack = assemble(
        n_train=len(train_x), ndim=ndim, num_matvecs=args.num_matvecs,
        num_samples=args.num_samples, rank_precon=args.rank_precon,
        precon_block=args.precon_block, cg_tol=args.cg_tol, cg_rtol=0.0,
        cg_maxiter=args.cg_maxiter, cg_miniter=10,
        matvec=policy, slq=args.slq,
        mesh=args.mesh, device=args.device, solver_mode=solver_mode,
        train_log=args.train_log, slq_host_batches=host_batches, **given,
    )
    if params0 is None:
        params0 = torch.randn(stack.num_params, generator=torch.Generator().manual_seed(args.seed))
    params = torch.as_tensor(np.asarray(params0, dtype=np.float32)).to(args.device)
    optimizer = AdamIfFinite(params.requires_grad_(), lr=args.learning_rate, max_consecutive_errors=25)
    key = torch.Generator(device=args.device).manual_seed(args.seed)
    series = {name: [] for name in SERIES}

    ckpt_dir = os.path.join(args.out, f"checkpoints_{args.name}_{args.dataset}_s{args.seed}")
    first_epoch = 0
    if args.resume:
        state, step = checkpoint.restore(ckpt_dir, _training_state(optimizer, key, series))
        if state is not None:
            with torch.no_grad():
                optimizer.params.copy_(state["params"])
            optimizer.adam.load_state_dict(state["adam"])
            optimizer.notfinite_count = state["notfinite_count"]
            optimizer.total_notfinite = state["total_notfinite"]
            key.set_state(state["generator"])
            series = state["series"]
            first_epoch = step + 1
            print(f"resumed from checkpoint at epoch {step}")

    elapsed = series["loss_timestamps"][-1] if series["loss_timestamps"] else 0.0
    start = time.perf_counter() - elapsed
    for epoch in range(first_epoch, args.num_epochs):
        try:
            epoch_key = key if draws is None else draws.epoch_key(epoch, len(train_x))
            value, info, _grad, _applied = train_step(stack, optimizer, epoch_key, train_x, train_y)
        except KeyboardInterrupt:
            break
        solve = info["logpdf"]["solve"]
        residual = solve["residual_abs"]
        cg_error = float(torch.linalg.vector_norm(residual) / math.sqrt(len(residual)))
        num_steps = int(solve.get("num_steps", args.num_matvecs))
        _p1, p2, p3 = gp.unflatten_params(optimizer.params.detach(), ndim)
        values = {
            "loss_timestamps": time.perf_counter() - start,
            "loss_curve": float(value),
            "cg_errors": cg_error,
            "cg_numsteps_all": num_steps,
            "slq_std_rels": float(info["logpdf"]["logdet"]["std_rel"]),
            "noise_curve": float(stack.constrain(p3["raw_noise"])),
            "outputscale_curve": float(stack.constrain(p2["raw_outputscale"])),
            "notfinite_curve": optimizer.total_notfinite,
        }
        for name, item in values.items():
            series[name].append(item)
        print(
            f"epoch {epoch}: loss {values['loss_curve']:.4f} cg_error {cg_error:.1e} "
            f"cg_steps {num_steps} noise {values['noise_curve']:.4f} "
            f"skipped {values['notfinite_curve']}",
            flush=True,
        )
        if args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0:
            checkpoint.save(ckpt_dir, epoch, _training_state(optimizer, key, series))

    params = optimizer.params.detach()
    t0 = time.perf_counter()
    predicted, predict_info = stack.predict_mean(params, test_x, train_x, train_y)
    test_rmse = float(rmse(predicted, target=test_y))
    t1 = time.perf_counter()
    eval_key = key if draws is None else draws.eval_key(len(test_x))
    test_nll, eval_info = stack.mll_eval(params, eval_key, test_x, test_y)
    test_nll = float(test_nll)
    t2 = time.perf_counter()
    print(f"RMSE {test_rmse:.4f}  NLL {test_nll:.4f}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.name}_{args.dataset}_s{args.seed}")
    arrays = {name: np.asarray(series[name]) for name in SERIES}
    arrays.update(test_rmses=np.asarray(test_rmse), test_nlls=np.asarray(test_nll),
                  params_opt=params.cpu().numpy())
    for name in RESULTS:
        np.save(f"{path}_{name}.npy", arrays[name])
    return SimpleNamespace(
        test_rmse=test_rmse, test_nll=test_nll, params=params, series=series,
        predict_info=predict_info, eval_info=eval_info,
        seconds={"predict_mean": t1 - t0, "mll_eval": t2 - t1}, path=path,
    )


def _errors_of_limits(value, value_ref, grad, grad_ref) -> tuple:
    """The dry run's loss and gradient errors, each as a fraction of its limit."""
    value, value_ref = float(value), float(value_ref)
    grad, grad_ref = (np.asarray(g.detach().cpu(), dtype=np.float64) for g in (grad, grad_ref))
    loss_err = abs(value - value_ref) / (1e-5 * max(1.0, abs(value_ref)) + 1e-5 * abs(value_ref))
    scale = np.maximum(np.abs(grad_ref), 1e-3 * np.max(np.abs(grad_ref)))
    grad_err = float(np.max(np.abs(grad / scale - grad_ref / scale))) / 1e-4
    return loss_err, grad_err


def dryrun_multichip(n_partitions: int, *, device="cuda", policy=None) -> list:
    """The GP training step over an ``n_partitions`` mesh, held to the step without one.

    Counterpart of ``__graft_entry__.py::dryrun_multichip``, with its two
    configurations, sizes and gates: ``n = min(512 R, 4096)`` points in
    d = 4, 10 Lanczos steps, rank 32, PCG ``atol=1e-2`` (``maxiter``
    1000, ``miniter`` 10), on

    1. an ``R x 2`` (rows x probes) mesh: per-probe SLQ with the probes
       sharded, the sequential pivoted Cholesky (``precon_block=1``);
    2. an ``n_partitions`` rows mesh: blocked SLQ over 4 probes.

    Each configuration's loss must agree with the same step assembled
    without a mesh, on the same probes, to rtol 1e-5, and its gradient,
    each entry scaled by ``max(|g|, 1e-3 max |g|)``, to 1e-4; then one
    ``AdamIfFinite`` step on that loss and gradient must be finite.
    ``policy`` is the Gram policy (default: the fused kernels K1/K2).
    Raises ``RuntimeError`` on a divergence; returns one report per
    configuration.
    """
    probes_way = 2 if n_partitions % 2 == 0 else 1
    rows_way = n_partitions // probes_way
    d = 4
    n = min(512 * rows_way, 4096)
    n = n // rows_way * rows_way
    inputs = torch.randn((n, d), generator=torch.Generator().manual_seed(0)).to(device)
    targets = torch.sin(inputs[:, 0]) + 0.1 * inputs[:, 1]
    params = torch.randn(d + 3, generator=torch.Generator().manual_seed(1)).to(device)
    shared = dict(
        n_train=n, ndim=d, num_matvecs=10, rank_precon=32, cg_tol=1e-2, cg_rtol=0.0,
        cg_maxiter=1000, cg_miniter=10, matvec=policy, device=device,
    )
    configs = [
        dict(slq="vmap", mesh=f"{rows_way}x{probes_way}", num_samples=2 * probes_way,
             precon_block=1),
        dict(slq="blocked", mesh=str(n_partitions), num_samples=4, precon_block=16),
    ]
    reports = []
    for config in configs:
        results = {}
        for mesh in (config["mesh"], "1"):
            stack = assemble(**shared, **{**config, "mesh": mesh})
            p = params.clone().requires_grad_()
            value, _info = stack.mll_lanczos(p, torch.Generator(device=device).manual_seed(2),
                                             inputs, targets)
            (grad,) = torch.autograd.grad(value, [p])
            results[mesh] = (value.detach(), grad)
        value, grad = results[config["mesh"]]
        value_ref, grad_ref = results["1"]
        loss_err, grad_err = _errors_of_limits(value, value_ref, grad, grad_ref)
        if not (loss_err <= 1.0 and grad_err <= 1.0):
            msg = (
                f"the {config['mesh']} mesh diverged from the unsharded step ({config['slq']}): "
                f"loss {float(value)} vs {float(value_ref)}, gradient error {grad_err * 1e-4:.3e}"
            )
            raise RuntimeError(msg)
        # One Adam step from the mesh's own loss and gradient.
        optimizer = AdamIfFinite(params.clone().requires_grad_(), lr=0.05)
        optimizer.params.grad = grad.clone()
        applied = optimizer.step()
        if not (applied and bool(torch.isfinite(value)) and bool(torch.isfinite(optimizer.params).all())):
            msg = f"the Adam step over the {config['mesh']} mesh is not finite: loss {float(value)}"
            raise RuntimeError(msg)
        reports.append({
            "slq": config["slq"], "mesh": config["mesh"], "n": n,
            "loss": float(value), "loss_unsharded": float(value_ref),
            "loss_err_of_limit": loss_err, "grad_err_of_limit": grad_err,
            "params_after_step": optimizer.params.detach().cpu().tolist(),
        })
    return reports


def main(argv=None) -> int:
    parser = build_argparser(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    parser.add_argument("--solver_mode", type=str, default="adaptive", choices=["adaptive", "fixed"])
    args = parser.parse_args(argv)
    print(args)
    pin_float32()
    run(args, solver_mode=args.solver_mode)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
