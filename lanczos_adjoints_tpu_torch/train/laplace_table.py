"""The linearised-Laplace results table, written with the csv module and string formatting.

Counterpart of ``experiments/applications/linearised_laplace/create_dataframe.py``
without pandas: one row per calibration run
(``callibration/s{seed}_alpha.npy`` and ``_curve.npy``: the calibrated
alpha, the final loss and the number of epochs; then the same under
``callibration_diag/``) and one per predictive of each metrics file
(``compute_metrics_lanczos/s{seed}_metrics.json``), in that order; the
columns in the order they first appear. ``dataframe.csv`` holds every
value as a float (a missing one empty), as pandas writes a float frame;
``table.tex`` is the booktabs tabular of pandas' ``to_latex`` with
``%.3f`` and ``--`` for a missing value, one ``l`` then one ``c`` a
column.

A file whose name its pattern cannot parse (``s1_p3688970_rank10_alpha.npy``
under ``s(\\d+)_alpha``) raises ``ValueError`` naming it; the JAX script
fails there with an ``AttributeError``.

``python -m lanczos_adjoints_tpu_torch.train.laplace_table --results DIR
--out DIR``: ``--results`` holds the drivers' directories
(``callibration/`` and the others), ``--out`` gets the two files.
"""

import argparse
import csv
import glob
import io
import json
import math
import os
import re

import numpy as np

CALIBRATIONS = (("full", "callibration"), ("diagonal", "callibration_diag"))


def _seed(pattern, path):
    match = re.search(pattern, path)
    if match is None:
        msg = f"cannot parse {path!r} with the pattern {pattern!r}"
        raise ValueError(msg)
    return match.group(1)


def collect(base) -> dict:
    """``{row label: {column: value}}``, the rows and columns in the JAX script's order."""
    base = str(base).rstrip("/")
    rows = {}
    for ggn, subdir in CALIBRATIONS:
        for alpha_path in sorted(glob.glob(f"{base}/{subdir}/s*_alpha.npy")):
            seed = _seed(r"s(\d+)_alpha", alpha_path)
            curve = np.load(alpha_path.replace("_alpha", "_curve"))
            rows[rf"SLQ calibration \& {ggn} (s{seed})"] = {
                "alpha": float(np.load(alpha_path)),
                "final loss": float(curve[-1]),
                "epochs": int(len(curve)),
            }
    for metrics_path in sorted(glob.glob(f"{base}/compute_metrics_lanczos/s*_metrics.json")):
        seed = _seed(r"s(\d+)_metrics", metrics_path)
        with open(metrics_path) as fp:
            metrics = json.load(fp)
        for name, vals in metrics.items():
            rows[rf"{name} \& Lanczos (s{seed})"] = dict(vals)
    if not rows:
        msg = f"no artifacts found under {base}"
        raise FileNotFoundError(msg)
    return rows


def columns(rows) -> list:
    return list(dict.fromkeys(key for values in rows.values() for key in values))


def _values(rows):
    cols = columns(rows)
    return cols, [(label, [float(values.get(c, math.nan)) for c in cols]) for label, values in rows.items()]


def to_csv(rows) -> str:
    """The table as pandas' ``to_csv`` writes a float frame: ``repr`` of each
    value, empty where missing, the index's column unnamed."""
    cols, table = _values(rows)
    buffer = io.StringIO()
    writer = csv.writer(buffer, lineterminator="\n")
    writer.writerow(["", *cols])
    for label, values in table:
        writer.writerow([label, *("" if math.isnan(v) else repr(v) for v in values)])
    return buffer.getvalue()


def to_latex(rows) -> str:
    """The booktabs tabular of pandas' ``to_latex(column_format="l" + "c" * columns,
    float_format="%.3f", na_rep="--")``."""
    cols, table = _values(rows)
    lines = [rf"\begin{{tabular}}{{l{'c' * len(cols)}}}", r"\toprule", " & " + " & ".join(cols) + r" \\",
             r"\midrule"]
    for label, values in table:
        cells = ["--" if math.isnan(v) else "%.3f" % v for v in values]  # noqa: UP031
        lines.append(" & ".join([label, *cells]) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines) + "\n"


def write(base, out) -> dict:
    """Collect the rows under ``base`` and write ``dataframe.csv`` and ``table.tex`` to ``out``."""
    rows = collect(base)
    latex = to_latex(rows)
    print()
    print(latex)
    print()
    os.makedirs(out, exist_ok=True)
    with open(f"{out}/dataframe.csv", "w", newline="") as fp:
        fp.write(to_csv(rows))
    with open(f"{out}/table.tex", "w") as fp:
        fp.write(latex)
    print(f"wrote {out}/dataframe.csv and table.tex")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--results", type=str, required=True,
                        help="directory holding callibration/, callibration_diag/ and compute_metrics_lanczos/")
    parser.add_argument("--out", type=str, required=True, help="directory for dataframe.csv and table.tex")
    args = parser.parse_args(argv)
    write(args.results, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
