"""The wave-PDE reports: the summary table of the training runs and the three figures.

Counterparts of ``experiments/applications/partial_differential_equation/``
``show_table.py`` (``show_table``: per resolution and method, the epochs,
the final relative MSE, the wall time and the matvecs an epoch, over
seeds; plain numpy, the same text for the same files), ``plot.py``'s
training curves (``plot_training``), ``plot_workprecision.py``
(``plot_workprecision``) and ``plot_solution.py`` (``plot_solution``).
The figures import matplotlib (Agg) when called, so they run only where
it is installed.

``python -m lanczos_adjoints_tpu_torch.train.pde_report table --results DIR``
prints the table of the ``train.pde`` series under ``DIR``;
``python -m lanczos_adjoints_tpu_torch.train.pde_report plot --what
{training,workprecision,solution,all} --results DIR --figures DIR`` draws
the figures (``--workprecision DIR`` for the JSON files, ``--data DIR``
for the pairs, default the bundled ones).
"""

import argparse
import collections
import glob
import json
import os
import re
from pathlib import Path

import numpy as np

DATA = (
    Path(__file__).resolve().parents[2]
    / "data" / "applications" / "partial_differential_equation" / "make_data"
)
_STYLES = {"arnoldi": "o-", "rk4": "s--"}


def _directory(path) -> str:
    return str(path).rstrip("/") + "/"


def table_rows(results):
    """``{(resolution, method): [(final loss, wall s, median matvecs, epochs), ...]}``."""
    results = _directory(results)
    rows = collections.defaultdict(list)
    for f in sorted(glob.glob(f"{results}*_convergence.npy")):
        m = re.match(r"(\d+x\d+)_(\w+)_s(\d+)_convergence", os.path.basename(f))
        if not m:
            continue
        res, method, _seed = m.groups()
        conv = np.load(f)
        stamps = np.load(f.replace("_convergence", "_timestamps"))
        mv = np.load(f.replace("_convergence", "_matvecs"))
        rows[(res, method)].append(
            (
                float(conv[-1]),
                float(stamps[-1]) if len(stamps) else float("nan"),
                float(np.median(mv)) if len(mv) else float("nan"),
                len(conv),
            )
        )
    return rows


def show_table(results) -> str:
    """Print the table of the series under ``results`` and return its text."""
    header = (f"{'config':>16s} {'method':>10s} {'epochs':>7s} {'rel-MSE':>12s} {'wall [s]':>10s} "
              f"{'mv/epoch':>9s}")
    lines = [header, "-" * len(header)]
    for (res, method), entries in sorted(table_rows(results).items()):
        loss = np.array([e[0] for e in entries])
        wall = np.array([e[1] for e in entries])
        mv = entries[0][2]
        epochs = entries[0][3]
        loss_s = f"{loss.mean():.3e}"
        if len(entries) > 1:
            loss_s += f"+/-{loss.std():.0e}"
        lines.append(f"{res:>16s} {method:>10s} {epochs:>7d} {loss_s:>12s} {wall.mean():>10.1f} {mv:>9.0f}")
    text = "\n".join(lines) + "\n"
    print(text, end="")
    return text


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training(resolution, results, figures) -> str:
    """Loss against epoch and against wall time, one line per method:
    ``{figures}/training_{resolution}.pdf``."""
    plt = _pyplot()
    results = _directory(results)
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.2), constrained_layout=True)
    for f in sorted(glob.glob(f"{results}{resolution}x{resolution}_*_convergence.npy")):
        label = os.path.basename(f).split("_")[1]
        conv = np.load(f)
        stamps = np.load(f.replace("_convergence", "_timestamps"))
        axes[0].semilogy(conv, label=label)
        axes[1].semilogy(stamps[: len(conv)], conv[: len(stamps)], label=label)
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("relative MSE")
    axes[1].set_xlabel("wall time [s]")
    axes[0].legend(fontsize=8)
    out = f"{_directory(figures)}training_{resolution}.pdf"
    os.makedirs(figures, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    print("saved", out)
    return out


def plot_workprecision(results, figures, *, seed=1) -> str:
    """Gradient error against matvecs, one series per method and precision:
    ``{figures}/workprecision_s{seed}.pdf``."""
    files = sorted(glob.glob(f"{_directory(results)}workprecision*_s{seed}.json"))
    if not files:
        msg = f"no workprecision files under {results}"
        raise FileNotFoundError(msg)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4.6, 3.4), constrained_layout=True)
    for path in files:
        tag = "f64" if "_x64_" in path else "f32"
        with open(path) as fp:
            rows = json.load(fp)
        by_method = {}
        for row in rows:
            by_method.setdefault(row["method"], []).append((row["num_matvecs"], row["error"]))
        for method, pts in sorted(by_method.items()):
            pts = sorted(pts)
            ax.loglog([p[0] for p in pts], [max(p[1], 1e-16) for p in pts], _STYLES.get(method, "^-"),
                      alpha=1.0 if tag == "f64" else 0.45, label=f"{method} ({tag})")
    ax.set_xlabel("matvecs per solve")
    ax.set_ylabel("relative gradient error")
    ax.legend(fontsize=7)
    ax.grid(True, which="both", alpha=0.3)
    out = f"{_directory(figures)}workprecision_s{seed}.pdf"
    os.makedirs(figures, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    print("saved", out)
    return out


def plot_solution(resolution, results, figures, *, data=DATA, sample=0) -> str:
    """A pair's initial condition and target, the true squared wave speed and
    each learned field under ``results``: ``{figures}/solution_{resolution}.pdf``."""
    prefix = f"{_directory(data)}{resolution}x{resolution}"
    y0s = np.load(f"{prefix}_data_inputs.npy")
    y1s = np.load(f"{prefix}_data_targets.npy")
    truth = np.load(f"{prefix}_data_parameter.npy")
    learned_files = sorted(glob.glob(f"{_directory(results)}{resolution}x{resolution}_*_scale_field.npy"))
    plt = _pyplot()
    ncols = 3 + len(learned_files)
    fig, axes = plt.subplots(1, ncols, figsize=(3.0 * ncols, 3.0), constrained_layout=True)
    axes[0].imshow(y0s[sample, 0], cmap="RdBu")
    axes[0].set_title("$u(t=0)$")
    axes[1].imshow(y1s[sample, 0], cmap="RdBu")
    axes[1].set_title("$u(t=1)$ (RK4 target)")
    im = axes[2].imshow(truth**2, cmap="viridis")
    axes[2].set_title("true $c^2$")
    fig.colorbar(im, ax=axes[2], shrink=0.8)
    for ax, f in zip(axes[3:], learned_files):
        method = os.path.basename(f).split("_")[1]
        im = ax.imshow(np.load(f).reshape(truth.shape), cmap="viridis")
        ax.set_title(f"learned $c^2$ ({method})")
        fig.colorbar(im, ax=ax, shrink=0.8)
    for ax in axes:
        ax.set_xticks([]), ax.set_yticks([])
    out = f"{_directory(figures)}solution_{resolution}.pdf"
    os.makedirs(figures, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    print("saved", out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    commands = parser.add_subparsers(dest="command", required=True)
    table = commands.add_parser("table", help="the summary table of the training series")
    table.add_argument("--results", type=str, required=True, help="directory of the train.pde series")
    plot = commands.add_parser("plot", help="the figures (needs matplotlib)")
    plot.add_argument("--what", type=str, default="all", choices=["training", "workprecision", "solution", "all"])
    plot.add_argument("--resolution", type=int, default=128)
    plot.add_argument("--seed", type=int, default=1)
    plot.add_argument("--sample", type=int, default=0)
    plot.add_argument("--results", type=str, required=True, help="directory of the train.pde series")
    plot.add_argument("--workprecision", type=str, default=None,
                      help="directory of the work-precision JSON files (default: --results)")
    plot.add_argument("--data", type=str, default=str(DATA), help="directory of the data pairs")
    plot.add_argument("--figures", type=str, required=True, help="directory for the figures")
    args = parser.parse_args(argv)
    if args.command == "table":
        show_table(args.results)
        return 0
    if args.what in ("training", "all"):
        plot_training(args.resolution, args.results, args.figures)
    if args.what in ("workprecision", "all"):
        plot_workprecision(args.workprecision or args.results, args.figures, seed=args.seed)
    if args.what in ("solution", "all"):
        plot_solution(args.resolution, args.results, args.figures, data=args.data, sample=args.sample)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
