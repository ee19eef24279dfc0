"""Cells of the benchmark at sizes the CPU holds, for the tests."""

import time
from pathlib import Path

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
GP = "gp-adj400k.train-step"
VJP = "dia-laplace-1024.lanczos-vjp"
SIZES = {
    GP: ({"num_data": 2000, "n_train": 1600, "rank_precon": 128}, {"reference_tile": 512}),
    VJP: ({"grid": 32, "n": 1024, "depth": 20}, {"sample_from_first": 20, "sample": 3}),
}


def cell(name, root=ROOT):
    """``core.find_cell`` of ``name``, cut to the CPU size of ``SIZES``."""
    spec = core.find_cell(root, name)
    config, traffic = SIZES[name]
    spec.config.update(config)
    spec.traffic.update(traffic)
    return spec


def run(spec, *, seed=2**31 + 11, seconds=1.0, root=ROOT):
    """One run on the CPU: ``(result, check_lines)``."""
    return core.run_cell(root, spec.name, seed=seed, seconds=seconds, trace=False,
                         t0=time.perf_counter(), require_card=False, found=spec)
