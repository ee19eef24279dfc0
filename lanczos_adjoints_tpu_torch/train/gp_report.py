"""The GP driver's reports: the table of its runs and the training figure.

Counterparts of ``experiments/applications/gaussian_process/train/``
``show_table.py`` (``show_table``: per dataset, test RMSE and NLL as
mean +/- std over seeds and the mean wall time, from the ``train.gp``
series ``{name}_{dataset}_s{seed}_*.npy``; with ``--compare_reference``
the reference's stored V100 adjoints and GPyTorch rows from
``reference_baselines/``) and ``plot.py`` (``plot_training``: loss
against wall time, the CG residual and the CG iterations per epoch).
The figure imports matplotlib (Agg) when called, so it runs only where
it is installed.

The JAX scripts take the dataset as what precedes the first ``_s`` of a
file name, which cuts a dataset whose name holds ``_s``
(``synthetic_gp500k`` reads as the run's name, and its row prints
``--``). The port reads ``{name}_{dataset}_s{seed}_`` with the seed's
digits (``datasets``); for every other dataset its table is the JAX
script's text, byte for byte.

``python -m lanczos_adjoints_tpu_torch.train.gp_report table --name NAME
[--results DIR] [--label TEXT] [--compare_reference]`` prints the table
(``--results`` defaults to the JAX driver's committed
``optim_logml_adjoints_adaptive/``, ``--label`` to the JAX script's
``ours (TPU v5e)``); ``... plot --name NAME [--results DIR] --figures
DIR`` draws ``{name}_training.pdf``.
"""

import argparse
import glob
import os
import re
from pathlib import Path

import numpy as np

RESULTS = (Path(__file__).resolve().parents[2]
           / "results/applications/gaussian_process/train/optim_logml_adjoints_adaptive")
LABEL = "ours (TPU v5e)"


def _directory(path) -> str:
    return str(path).rstrip("/") + "/"


def datasets(directory, name, key="test_rmses") -> list:
    """The datasets of the runs ``{name}_{dataset}_s{seed}_{key}.npy`` under ``directory``."""
    pattern = re.compile(rf"^{re.escape(name)}_(.+)_s\d+_{re.escape(key)}\.npy$")
    found = (pattern.match(os.path.basename(f)) for f in glob.glob(f"{_directory(directory)}{name}_*_{key}.npy"))
    return sorted({m.group(1) for m in found if m})


def _stats(directory, prefix, ds, *, rmse_key, nll_key, wall_key):
    """(rmse mean/std, nll mean/std, wall mean) over seeds, or None."""
    rmses, nlls, walls = [], [], []
    for f in sorted(glob.glob(f"{directory}{prefix}_{ds}_s*_{rmse_key}.npy")):
        stem = f[: -len(f"_{rmse_key}.npy")]
        rmses.append(float(np.load(f)))
        if nll_key and os.path.exists(f"{stem}_{nll_key}.npy"):
            nlls.append(float(np.load(f"{stem}_{nll_key}.npy")))
        ts = np.load(f"{stem}_{wall_key}.npy")
        walls.append(float(ts[-1]) if len(ts) else 0.0)
    if not rmses:
        return None
    return {
        "rmse": (float(np.mean(rmses)), float(np.std(rmses))),
        "nll": (float(np.mean(nlls)), float(np.std(nlls))) if nlls else None,
        "wall": float(np.mean(walls)),
        "seeds": len(rmses),
    }


def _fmt(stats):
    if stats is None:
        return f"{'--':>16} | {'--':>16} | {'--':>10}"
    rmse = f"{stats['rmse'][0]:.3f} +/- {stats['rmse'][1]:.3f}"
    nll = f"{stats['nll'][0]:.3f} +/- {stats['nll'][1]:.3f}" if stats["nll"] else "--"
    return f"{rmse:>16} | {nll:>16} | {stats['wall']:>10.1f}"


def show_table(name, results=RESULTS, *, label=LABEL, compare_reference=False) -> str:
    """The table's text (also printed). The reference rows come from
    ``reference_baselines/`` beside ``optim_logml_adjoints_adaptive/``, as
    the JAX script finds them."""
    directory = _directory(results)
    ref_dir = directory.replace("/optim_logml_adjoints_adaptive/", "/reference_baselines/")
    header = f"{'dataset':>18} | {'method':>22} | {'RMSE':>16} | {'NLL':>16} | {'wall [s]':>10}"
    lines = [header, "-" * len(header)]
    for ds in datasets(directory, name):
        ours = _stats(directory, name, ds, rmse_key="test_rmses", nll_key="test_nlls",
                      wall_key="loss_timestamps")
        lines.append(f"{ds:>18} | {label:>22} | {_fmt(ours)}")
        if compare_reference and os.path.isdir(ref_dir):
            ref_adj = _stats(ref_dir, "adjoints75", ds, rmse_key="test_rmses", nll_key="test_nlls",
                             wall_key="loss_timestamps")
            ref_gpy = _stats(ref_dir, "gpytorch75", ds, rmse_key="rmse", nll_key=None,
                             wall_key="loss_timestamps")
            lines.append(f"{'':>18} | {'ref adjoints (V100)':>22} | {_fmt(ref_adj)}")
            lines.append(f"{'':>18} | {'ref GPyTorch (V100)':>22} | {_fmt(ref_gpy)}")
    text = "\n".join(lines) + "\n"
    print(text, end="")
    return text


def plot_training(name, results=RESULTS, figures=".") -> str:
    """``{figures}/{name}_training.pdf``: loss against wall time, CG residual
    and CG iterations against epoch, one line a run (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    directory = _directory(results)
    found = datasets(directory, name, key="loss_curve")
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), constrained_layout=True)
    for ds in found:
        for f in sorted(glob.glob(f"{directory}{name}_{ds}_s*_loss_curve.npy")):
            stem = f.removesuffix("_loss_curve.npy")
            curve = np.load(f)
            stamps = np.load(f"{stem}_loss_timestamps.npy")
            axes[0].plot(stamps[: len(curve)], curve[: len(stamps)], label=ds)
            axes[1].semilogy(np.load(f"{stem}_cg_errors.npy"))
            axes[2].plot(np.load(f"{stem}_cg_numsteps_all.npy"))
    axes[0].set_xlabel("wall time [s]")
    axes[0].set_ylabel("negative log-marginal-likelihood / N")
    axes[1].set_xlabel("epoch")
    axes[1].set_ylabel("CG residual (RMS)")
    axes[2].set_xlabel("epoch")
    axes[2].set_ylabel("CG iterations")
    if found:
        axes[0].legend(fontsize=7)
    os.makedirs(figures, exist_ok=True)
    out = os.path.join(figures, f"{name}_training.pdf")
    fig.savefig(out)
    plt.close(fig)
    print("saved", out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    commands = parser.add_subparsers(dest="command", required=True)
    table = commands.add_parser("table", help="RMSE, NLL and wall time per dataset")
    table.add_argument("--name", type=str, required=True)
    table.add_argument("--results", type=str, default=str(RESULTS), help="directory of the train.gp series")
    table.add_argument("--label", type=str, default=LABEL, help="the method column of the runs' rows")
    table.add_argument("--compare_reference", action="store_true",
                       help="add the reference's stored V100 adjoints + GPyTorch rows")
    fig = commands.add_parser("plot", help="the training figure (needs matplotlib)")
    fig.add_argument("--name", type=str, required=True)
    fig.add_argument("--results", type=str, default=str(RESULTS))
    fig.add_argument("--figures", type=str, required=True)
    args = parser.parse_args(argv)
    if args.command == "table":
        return show_table(args.name, args.results, label=args.label,
                          compare_reference=args.compare_reference)
    return plot_training(args.name, args.results, args.figures)


if __name__ == "__main__":
    main()
