"""The linearised-Laplace drivers: prior-precision calibration and the Laplace predictive's metrics.

Counterpart of ``experiments/applications/linearised_laplace/``
``callibration.py`` (the prior precision alpha calibrated by RMSprop on
the Laplace evidence, its logdet an SLQ estimate over the GGN matvec),
``callibration_diag.py`` (the same with the Hutchinson-diagonal logdet)
and ``compute_metrics_lanczos.py`` (NLL, accuracy, confidence, ECE and
OOD AUROC of the MAP and of the Laplace predictive with Lanczos posterior
samples) and ``plot_callibration_loss.py`` (the calibration loss on a grid
of ``log alpha``, ``--num_loss_samples`` probe sets each, and its figure),
on their synthetic classification stand-in.

``python -m lanczos_adjoints_tpu_torch.train.laplace
{callibration,callibration_diag,compute_metrics_lanczos,gridsearch} ...``
takes the JAX drivers' arguments; ``--device`` (default ``cuda``) replaces
``--cpu`` and ``--out DIR`` the results directory mirrored from the
script's path, where the ``.npy`` and ``.json`` files keep the JAX
names. ``--fixture PATH`` takes the data, the initial parameters and the
probes or draws (with the sampler's Ritz-vector signs) from a fixture of
the JAX drivers' own
(``laplace_s1.npz``, written by ``scripts/export_laplace_s1.py``)
instead of drawing them with numpy and ``torch.Generator`` from
``--seed``; ``gridsearch`` then evaluates at the calibration run's MAP
vector on the grid search's own probes. ``gridsearch --figures DIR``
draws the loss against alpha, the calibrated alpha of ``--calibrated
PATH`` overlaid, where matplotlib is installed. ``--time`` prints the
device's time per calibration ``value_and_grad`` by CUDA events.

Adam (``train_map``) and RMSprop are written out to optax's formulas and
defaults: ``torch.optim.RMSprop`` decays by 0.99 and adds eps outside the
square root, optax by 0.9 and inside.
"""

import argparse
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.models import bnn
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32, requires_float32

FIXTURE = Path(__file__).with_name("laplace_s1.npz")
# The JAX drivers' committed outputs, from a TPU at its default matmul
# precision; printed beside the port's for information only.
JAX_TPU_RESULTS = Path(__file__).resolve().parents[2] / "results/applications/linearised_laplace"
METRICS = ("nll", "accuracy", "confidence", "ece", "ood_auroc")
PREDICTIVES = ("map", "laplace")
# ``callibration.py --hidden 2048,1536``: the reference's VAN-tiny
# parameter class, 3,688,970 parameters.
# How closely the port is held to the JAX drivers' float32 CPU run (the
# fixture): the MAP vector in norm, the calibration curves and alphas, and
# each metric within 1 %, the sampler's Ritz vectors given JAX's signs.
TOL_MAP = 1e-3
TOL_CURVES = 5e-3
TOL_METRICS_REL = 1e-2


def metric_tolerances(fix) -> np.ndarray:
    """Per-metric absolute tolerances, ``(predictives, metrics)``: 1 % of the fixture's.

    At matched Ritz-vector signs (``metrics_signs``) the port and the JAX
    float32 run take the same samples. The JAX package's own
    float32-vs-float64 spread (``metric_spread``, each run at its own
    signs) is reported beside the gate and never widens it.
    """
    return TOL_METRICS_REL * np.abs(fix["metrics"])


def metric_spread(fix) -> np.ndarray:
    """The JAX float32 run's metrics against its float64 run's, each at its own signs."""
    return np.abs(fix["metrics"] - fix["metrics_f64"])


def jax_float32_dot_bias(probes) -> np.ndarray:
    """What the JAX package's float32 SLQ calibration loss on the CPU adds by
    one rounded sum, per probe set ``probes`` (``(..., S, P)`` Rademacher signs).

    Its Arnoldi (``krylov/arnoldi.py::_forward``) divides the unit probe
    ``v`` by ``sqrt(jnp.dot(v, v))``, and XLA's CPU float32 dot sums the P
    equal squares in order: at P = 3,709 the sum is ``1 - 3.2e-5``, the
    first Krylov vector's squared norm ``1 + 3.2e-5``, and each probe's
    quadratic form ``P e1^T log(T) e1`` is ``-P log(sum)`` (~0.119) too
    large. Returns that term averaged over the S probes, the ordered sum
    taken again with numpy's ``cumsum`` (``(...)``).
    """
    signs = np.asarray(probes, dtype=np.float32)
    v = signs / np.linalg.norm(signs, axis=-1, keepdims=True).astype(np.float32)
    ordered = np.cumsum(v * v, axis=-1, dtype=np.float32)[..., -1].astype(np.float64)
    return np.mean(-signs.shape[-1] * np.log(ordered), axis=-1)


def relative_ritz_gaps(ritz_values) -> np.ndarray:
    """Each sample's smallest gap between neighbouring Ritz values, over the
    larger of the two (``(samples, rank)`` -> ``(samples,)``): where one is
    near float32 rounding, two Ritz vectors can rotate, not just flip."""
    w = np.sort(np.asarray(ritz_values, dtype=np.float64), axis=-1)
    return np.min(np.diff(w, axis=-1) / np.abs(w[..., 1:]), axis=-1)


def metrics_table(metrics) -> np.ndarray:
    """``compute_metrics``' dict as the fixture's ``(predictives, metrics)`` table."""
    return np.asarray([[metrics[p][m] for m in METRICS] for p in PREDICTIVES])


FULL_WIDTH_ARGS = (
    "--hidden", "2048,1536", "--data_dim", "256", "--num_classes", "10",
    "--num_epochs", "30", "--lanczos_rank", "10", "--slq_num_samples", "10",
)


def fixture(path=FIXTURE) -> dict:
    """The JAX drivers' seed-1 draws and results (``scripts/export_laplace_s1.py``)."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def make_data(seed_or_rng, *, num=512, dim=16, num_classes=4):
    """Synthetic classification clusters (``callibration.py:28``), drawn with numpy.

    Class ``i % num_classes`` for row ``i``, centred at ``2 N(0, I)`` with
    unit-normal noise; float32 inputs and one-hot labels.
    """
    rng = np.random.default_rng(seed_or_rng)
    centers = 2.0 * rng.standard_normal((num_classes, dim))
    labels = np.arange(num) % num_classes
    x = centers[labels] + rng.standard_normal((num, dim))
    return x.astype(np.float32), np.eye(num_classes, dtype=np.float32)[labels]


def parse_hidden(spec):
    """``"2048,1536"`` -> ``(2048, 1536)``; ``""`` -> the parity default."""
    if not spec:
        return (50, 50, 5, 5)
    return tuple(int(w) for w in spec.split(","))


class Adam:
    """``optax.adam(learning_rate)`` on one tensor: b1 0.9, b2 0.999, eps 1e-8 outside the root."""

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu, self.nu, self.count = torch.zeros_like(params), torch.zeros_like(params), 0

    def update(self, params, grad):
        self.count += 1
        self.mu = (1 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1 - self.b2) * grad**2 + self.b2 * self.nu
        # The bias corrections in the parameters' dtype, as optax takes them.
        b1, b2 = (torch.tensor(b, dtype=params.dtype, device=params.device) for b in (self.b1, self.b2))
        mu_hat = self.mu / (1 - b1**self.count)
        nu_hat = self.nu / (1 - b2**self.count)
        return params + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))


class RMSprop:
    """``optax.rmsprop(learning_rate)`` (optax 0.2.6 defaults) on one tensor.

    ``nu = 0.9 nu + 0.1 g^2`` from ``nu = 0``, then ``-lr g / sqrt(nu + 1e-8)``:
    eps inside the root, no bias correction, no momentum.
    """

    def __init__(self, params, learning_rate, decay=0.9, eps=1e-8):
        self.lr, self.decay, self.eps = learning_rate, decay, eps
        self.nu = torch.zeros_like(params)

    def update(self, params, grad):
        self.nu = (1 - self.decay) * grad**2 + self.decay * self.nu
        return params + (-self.lr) * (torch.rsqrt(self.nu + self.eps) * grad)


@requires_float32
def train_map(apply, params_vec, unflatten, x, y, *, num_epochs=200, learning_rate=1e-2):
    """MAP training by Adam on the mean cross-entropy: ``(params_vec, last loss)``.

    The loss returned is the last step's, taken before its update, as the
    JAX driver's.
    """

    def loss_fn(p):
        return bnn.loss_training_cross_entropy(apply(unflatten(p), x), y)

    step = torch.func.grad_and_value(loss_fn)
    optimizer = Adam(params_vec, learning_rate)
    params_vec = params_vec.detach()
    value = None
    for _ in range(num_epochs):
        grads, value = step(params_vec)
        params_vec = optimizer.update(params_vec, grads)
    return params_vec, float(value)


def value_and_grad(loss, log_alpha, *args):
    """``loss(log_alpha, *args)`` and its derivative in ``log_alpha`` alone."""
    log_alpha = log_alpha.detach().requires_grad_()
    value = loss(log_alpha, *args)
    (grad,) = torch.autograd.grad(value, log_alpha)
    return value.detach(), grad


def _optimise_alpha(loss, extra_args, num_epochs, learning_rate, params_vec, *, epoch_args=None):
    """RMSprop on ``log alpha`` from 0: the loss curve and the calibrated alpha."""
    log_alpha = torch.zeros((), dtype=params_vec.dtype, device=params_vec.device)
    optimizer = RMSprop(log_alpha, learning_rate)
    curve = []
    for epoch in range(num_epochs):
        args = (*extra_args, *(epoch_args(epoch) if epoch_args else ()))
        value, grad = value_and_grad(loss, log_alpha, *args)
        log_alpha = optimizer.update(log_alpha, grad)
        curve.append(float(value))
        if epoch % 10 == 0:
            print(f"epoch {epoch}: loss {curve[-1]:.2f} alpha {float(torch.exp(log_alpha)):.4f}",
                  flush=True)
    return curve, float(torch.exp(log_alpha))


@requires_float32
def calibrate(apply, unflatten, params_vec, x, y, *, num_epochs, lanczos_rank=10, slq_num_samples=10,
              slq_num_batches=1, learning_rate=0.1, probes=None, generator=None):
    """``callibration.py``'s loop: RMSprop on ``log alpha`` over the SLQ calibration loss.

    Each epoch takes its probes from ``probes[epoch]`` (``(epochs, S, P)``)
    or draws them from ``generator``. Returns ``(curve, alpha)``.
    """
    loss = bnn.callibration_loss(
        apply, unflatten, torch.exp, params_vec.shape[0], lanczos_rank=lanczos_rank,
        slq_num_samples=slq_num_samples, slq_num_batches=slq_num_batches,
    )
    return _optimise_alpha(
        loss, (params_vec, x, y), num_epochs, learning_rate, params_vec,
        epoch_args=lambda epoch: (generator if probes is None else probes[epoch],),
    )


@requires_float32
def calibrate_diag(apply, unflatten, params_vec, x, y, *, num_epochs, hutchinson_samples=20, num_levels=2,
                   learning_rate=0.1, probes=0):
    """``callibration_diag.py``'s loop over the Hutchinson-diagonal calibration loss.

    ``probes``: the ``(num_levels, hutchinson_samples, P)`` signs used at
    every epoch, or the seed of the generator that draws them once a call.
    """
    loss = bnn.callibration_loss_diagonal(
        apply, unflatten, torch.exp, hutchinson_samples, num_levels, params_vec.shape[0], key=probes,
    )
    return _optimise_alpha(loss, (params_vec, x, y), num_epochs, learning_rate, params_vec)


def auroc(scores_id, scores_ood):
    """Area under the ROC for separating ID (high) from OOD (low) scores."""
    labels = np.concatenate([np.ones_like(scores_id), np.zeros_like(scores_ood)])
    scores = np.concatenate([scores_id, scores_ood])
    labels = labels[np.argsort(-scores)]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return float(np.trapezoid(tpr, fpr))


@requires_float32
@torch.no_grad()
def compute_metrics(apply, unflatten, params_vec, x, y, x_ood, *, key, alpha=1.0, lanczos_rank=20,
                    num_samples=16, signs=None):
    """``compute_metrics_lanczos.py``'s metrics of the MAP and the Laplace predictive.

    ``key``: a generator, or the ``(num_samples, P)`` normal draws of
    ``bnn.lanczos_sampler``, and ``signs`` the Ritz vectors' signs that go
    with them (default: ``_fixed_signs``' own). Returns ``{"map": {...},
    "laplace": {...}}``.
    """
    gvp = bnn.ggn_vp_parallel(
        loss_single=bnn.loss_training_cross_entropy_single, model_fun=apply, param_unflatten=unflatten
    )
    samples = bnn.lanczos_sampler(
        ggn_vp=lambda v: gvp(v, params_vec, x, y) + alpha * v, num_samples=num_samples,
        lanczos_rank=lanczos_rank, key=key, params_vec=params_vec, signs=signs,
    )

    def predictive_probs(inputs):
        return torch.mean(
            torch.stack([torch.softmax(apply(unflatten(p), inputs), dim=-1) for p in samples]), dim=0
        )

    results = {}
    for name in PREDICTIVES:
        if name == "map":
            probs = torch.softmax(apply(unflatten(params_vec), x), dim=-1)
            probs_ood = torch.softmax(apply(unflatten(params_vec), x_ood), dim=-1)
        else:
            probs, probs_ood = predictive_probs(x), predictive_probs(x_ood)
        nll = bnn.metric_nll(logits=torch.log(probs + 1e-12), labels_hot=y, sum_or_mean_fun=torch.mean)
        ece, _ = bnn.metric_ece(probs=probs, labels_hot=y, num_bins=10)
        results[name] = {
            "nll": float(nll),
            "accuracy": float(bnn.metric_accuracy(probs=probs, labels_hot=y)),
            "confidence": float(bnn.metric_confidence(probs=probs)),
            "ece": float(ece),
            "ood_auroc": auroc(torch.max(probs, dim=-1).values.cpu().numpy(),
                               torch.max(probs_ood, dim=-1).values.cpu().numpy()),
        }
    return results


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

COMMANDS = ("callibration", "callibration_diag", "compute_metrics_lanczos", "gridsearch")
GRID_LOG_ALPHAS = (-2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0)


def build_argparser(parser, command):
    """The JAX driver's arguments, less ``--cpu``, plus ``--device``, ``--out`` and ``--fixture``."""
    parser.add_argument("--seed", type=int, default=1)
    if command == "gridsearch":
        parser.add_argument("--log_alphas", type=float, nargs="+", default=list(GRID_LOG_ALPHAS))
        parser.add_argument("--num_loss_samples", type=int, default=5)
        parser.add_argument("--figures", type=str, default=None,
                            help="draw the loss against alpha into this directory (needs matplotlib)")
        parser.add_argument("--calibrated", type=str, default=None,
                            help="the s{seed}_alpha.npy of a callibration run, overlaid on the figure")
    elif command == "callibration":
        parser.add_argument("--num_epochs", type=int, default=50)
        parser.add_argument("--lanczos_rank", type=int, default=10)
        parser.add_argument("--slq_num_samples", type=int, default=10)
        parser.add_argument("--slq_num_batches", type=int, default=1,
                            help="sequential probe batches (must divide slq_num_samples): a memory knob")
        parser.add_argument("--learning_rate", type=float, default=1e-1)
        parser.add_argument("--time", action="store_true",
                            help="time the calibration value_and_grad by CUDA events")
    elif command == "callibration_diag":
        parser.add_argument("--num_epochs", type=int, default=50)
        parser.add_argument("--hutchinson_samples", type=int, default=20)
        parser.add_argument("--num_levels", type=int, default=2)
        parser.add_argument("--learning_rate", type=float, default=1e-1)
    else:
        parser.add_argument("--alpha", type=float, default=1.0)
        parser.add_argument("--lanczos_rank", type=int, default=20)
        parser.add_argument("--num_samples", type=int, default=16)
    if command not in ("callibration_diag", "gridsearch"):
        parser.add_argument("--hidden", type=str, default="",
                            help="comma-separated MLP widths; '2048,1536' with --data_dim 256 "
                            "--num_classes 10 has 3,688,970 parameters")
        parser.add_argument("--data_dim", type=int, default=16)
        parser.add_argument("--num_data", type=int, default=512)
        parser.add_argument("--num_classes", type=int, default=4)
        parser.add_argument("--map_epochs", type=int, default=200)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True, help="directory for the .npy and .json files")
    parser.add_argument("--fixture", type=str, default=None,
                        help="take the data, initial parameters and draws from this .npz "
                        "(scripts/export_laplace_s1.py) instead of drawing them")
    return parser


def _shapes(args):
    return {"hidden": getattr(args, "hidden", ""), "data_dim": getattr(args, "data_dim", 16),
            "num_data": getattr(args, "num_data", 512), "num_classes": getattr(args, "num_classes", 4)}


def problem(args, command, fix):
    """Data, model and initial parameters on ``--device``: ``(apply, unflatten, init, x, y, x_ood)``."""
    shapes = _shapes(args)
    prefix = "metrics" if command == "compute_metrics_lanczos" else "calib"
    if fix is not None:
        if shapes != _shapes(argparse.Namespace()):
            msg = f"the fixture holds the parity configuration only, not {shapes}"
            raise ValueError(msg)
        x, y, init_vec = fix[f"{prefix}_x"], fix[f"{prefix}_y"], fix[f"{prefix}_init"]
        x_ood = fix.get("metrics_x_ood")
    else:
        rng = np.random.default_rng(args.seed)
        x, y = make_data(rng, num=shapes["num_data"], dim=shapes["data_dim"],
                         num_classes=shapes["num_classes"])
        x_ood = (4.0 * rng.standard_normal(x.shape)).astype(np.float32)
        init_vec = None
    x, y = torch.tensor(x, device=args.device), torch.tensor(y, device=args.device)
    x_ood = None if x_ood is None else torch.tensor(x_ood, device=args.device)
    init, apply = bnn.model_mlp(out_dims=y.shape[-1], activation=torch.tanh,
                                hidden=parse_hidden(shapes["hidden"]))
    params = init(torch.Generator(device=args.device).manual_seed(args.seed), x)
    params_vec, unflatten, _ = bnn.vectorize_nn(apply, params)
    if init_vec is not None:
        params_vec = bnn.params_from_jax(init_vec, device=args.device)
    return apply, unflatten, params_vec, x, y, x_ood


def _tag(args, n_params, rank):
    tag = f"s{args.seed}"
    if getattr(args, "hidden", ""):
        tag += f"_p{n_params}_rank{rank}"
    return tag


def time_step(args, apply, unflatten, params_vec, x, y):
    """Device milliseconds of one calibration ``value_and_grad``, by CUDA events."""
    from lanczos_adjoints_tpu_torch.utils.timing import events_ms

    if not str(args.device).startswith("cuda"):
        msg = "--time reads CUDA events: it needs --device cuda"
        raise ValueError(msg)
    loss = bnn.callibration_loss(apply, unflatten, torch.exp, params_vec.shape[0],
                                 lanczos_rank=args.lanczos_rank, slq_num_samples=args.slq_num_samples,
                                 slq_num_batches=args.slq_num_batches)
    generator = torch.Generator(device=args.device).manual_seed(0)
    log_alpha = torch.zeros((), dtype=params_vec.dtype, device=params_vec.device)

    def step():
        value_and_grad(loss, log_alpha, params_vec, x, y, generator)

    step()
    return events_ms(step, 3)


@requires_float32
@torch.no_grad()
def gridsearch(apply, unflatten, params_vec, x, y, log_alphas, *, num_loss_samples=5, probes=None,
               generator=None):
    """``plot_callibration_loss.py``'s grid: the SLQ calibration loss at each
    ``log_alphas`` entry, ``num_loss_samples`` times, on ``probes[i, j]``
    (``(alphas, samples, S, P)``) or on draws from ``generator``.

    Returns ``(values, losses, stds)``: each evaluation ``(alphas,
    samples)``, and their means and (population) standard deviations.
    """
    loss = bnn.callibration_loss(apply, unflatten, torch.exp, params_vec.shape[0])
    values = np.zeros((len(log_alphas), num_loss_samples))
    for i, log_alpha in enumerate(log_alphas):
        log_alpha_t = torch.tensor(log_alpha, dtype=params_vec.dtype, device=params_vec.device)
        for j in range(num_loss_samples):
            key = generator if probes is None else probes[i, j]
            values[i, j] = float(loss(log_alpha_t, params_vec, x, y, key))
        print(f"alpha {float(np.exp(log_alpha)):.3f}: loss {values[i].mean():.2f} +- {values[i].std():.2f}",
              flush=True)
    return values, values.mean(axis=1), values.std(axis=1)


def plot_gridsearch(log_alphas, losses, stds, figures, *, seed=1, calibrated=None):
    """The loss against alpha with its standard deviation, the calibrated alpha
    (``calibrated``, a ``s{seed}_alpha.npy``) overlaid where it exists:
    ``{figures}/s{seed}_callibration_loss.{pdf,png}``. Imports matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.2), constrained_layout=True)
    ax.errorbar(np.exp(np.asarray(log_alphas)), losses, yerr=stds, marker="o", lw=1.2, capsize=3)
    ax.set_xscale("log")
    ax.set_xlabel(r"prior precision $\alpha$")
    ax.set_ylabel("calibration loss (-log marginal)")
    ax.set_title("Laplace calibration loss vs prior precision")
    if calibrated is not None and os.path.exists(calibrated):
        alpha_star = float(np.load(calibrated))
        ax.axvline(alpha_star, color="tab:red", ls="--", lw=1.0)
        ax.annotate(f"calibrated {alpha_star:.2f}", (alpha_star, max(losses)), color="tab:red", fontsize=8,
                    rotation=90, va="top", ha="right")
    os.makedirs(figures, exist_ok=True)
    paths = [f"{figures}/s{seed}_callibration_loss.pdf", f"{figures}/s{seed}_callibration_loss.png"]
    fig.savefig(paths[0])
    fig.savefig(paths[1], dpi=150)
    plt.close(fig)
    print(f"wrote {figures}/s{seed}_callibration_loss.[pdf|png]")
    return paths


def _grid_probes(args, fix):
    """The fixture's probe sets for ``args.log_alphas``, ``(alphas, samples, S, P)``, or None."""
    if fix is None:
        return None
    grid, known = fix["grid_probes"], fix["grid_log_alphas"].tolist()
    if any(a not in known for a in args.log_alphas) or args.num_loss_samples > grid.shape[1]:
        msg = f"the fixture holds the probes of log_alphas {known} x {grid.shape[1]} samples only"
        raise ValueError(msg)
    return torch.tensor(grid[[known.index(a) for a in args.log_alphas]], device=args.device)


def _run_gridsearch(args, probes, apply, unflatten, params_vec, x, y) -> dict:
    values, losses, stds = gridsearch(
        apply, unflatten, params_vec, x, y, args.log_alphas, num_loss_samples=args.num_loss_samples,
        probes=probes, generator=torch.Generator(device=args.device).manual_seed(args.seed),
    )
    np.savez(f"{args.out}/s{args.seed}_gridsearch.npz", log_alphas=np.asarray(args.log_alphas), losses=losses,
             stds=stds)
    result = {"values": values, "losses": losses, "stds": stds}
    if args.figures:
        if importlib.util.find_spec("matplotlib") is None:
            print("matplotlib is not installed: no figure", flush=True)
        else:
            result["figures"] = plot_gridsearch(args.log_alphas, losses, stds, args.figures, seed=args.seed,
                                                calibrated=args.calibrated)
    return result


def run(command, args) -> dict:
    """One driver, as ``python -m lanczos_adjoints_tpu_torch.train.laplace COMMAND``."""
    fix = fixture(args.fixture) if args.fixture else None
    probes = _grid_probes(args, fix) if command == "gridsearch" else None
    apply, unflatten, params_vec, x, y, x_ood = problem(args, command, fix)
    n_params = params_vec.shape[0]
    if command == "gridsearch" and fix is not None:
        # The grid search evaluates at the calibration run's MAP, which the
        # fixture holds: no training.
        params_vec = bnn.params_from_jax(fix["calib_map"], device=args.device)
        map_loss = float(fix["calib_map_loss"])
        print(f"MAP from the fixture, training loss {map_loss:.4f}, n_params={n_params}", flush=True)
    else:
        params_vec, map_loss = train_map(apply, params_vec, unflatten, x, y,
                                         num_epochs=getattr(args, "map_epochs", 200))
        print(f"MAP training loss: {map_loss:.4f}, n_params={n_params}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    result = {"n_params": n_params, "map_loss": map_loss, "params_map": params_vec}
    if command == "gridsearch":
        return {**result, **_run_gridsearch(args, probes, apply, unflatten, params_vec, x, y)}
    if command == "compute_metrics_lanczos":
        key, signs = torch.Generator(device=args.device).manual_seed(args.seed), None
        if fix is not None:
            key = torch.tensor(fix["metrics_eps"], device=args.device)
            signs = torch.tensor(fix["metrics_signs"], device=args.device)
        metrics = compute_metrics(apply, unflatten, params_vec, x, y, x_ood, key=key, alpha=args.alpha,
                                  lanczos_rank=args.lanczos_rank, num_samples=args.num_samples, signs=signs)
        for name in PREDICTIVES:
            print(name, metrics[name], flush=True)
        with open(f"{args.out}/{_tag(args, n_params, args.lanczos_rank)}_metrics.json", "w") as fp:
            json.dump(metrics, fp, indent=2)
        return {**result, "metrics": metrics}
    if command == "callibration":
        probes = None
        if fix is not None:
            if args.num_epochs > len(fix["calib_probes"]) or args.slq_num_samples != fix["calib_probes"].shape[1]:
                msg = f"the fixture holds {fix['calib_probes'].shape[:2]} (epochs, probes) only"
                raise ValueError(msg)
            probes = torch.tensor(fix["calib_probes"], device=args.device)
        curve, alpha = calibrate(
            apply, unflatten, params_vec, x, y, num_epochs=args.num_epochs, lanczos_rank=args.lanczos_rank,
            slq_num_samples=args.slq_num_samples, slq_num_batches=args.slq_num_batches,
            learning_rate=args.learning_rate, probes=probes,
            generator=torch.Generator(device=args.device).manual_seed(args.seed),
        )
        tag = _tag(args, n_params, args.lanczos_rank)
    else:
        probes = 0 if fix is None else torch.tensor(fix["diag_probes"], device=args.device)
        curve, alpha = calibrate_diag(
            apply, unflatten, params_vec, x, y, num_epochs=args.num_epochs,
            hutchinson_samples=args.hutchinson_samples, num_levels=args.num_levels,
            learning_rate=args.learning_rate, probes=probes,
        )
        tag = f"s{args.seed}"
    print(f"calibrated alpha{' (diag)' if command == 'callibration_diag' else ''}: {alpha:.4f}")
    np.save(f"{args.out}/{tag}_curve.npy", np.asarray(curve))
    np.save(f"{args.out}/{tag}_alpha.npy", alpha)
    result.update(curve=curve, alpha=alpha)
    if getattr(args, "time", False):
        ms = time_step(args, apply, unflatten, params_vec, x, y)
        print(f"calibration value_and_grad: {ms:.2f} ms/step on the device (CUDA events; "
              f"n_params={n_params}, rank={args.lanczos_rank}, samples={args.slq_num_samples})")
        np.save(f"{args.out}/{tag}_step_seconds.npy", np.asarray(ms / 1e3))
        result["step_ms"] = ms
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    commands = parser.add_subparsers(dest="command", required=True)
    for command in COMMANDS:
        build_argparser(commands.add_parser(command), command)
    args = parser.parse_args(argv)
    print(args)
    pin_float32()
    run(args.command, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
