"""K6's least time (each array once at the HBM rate, ``work.k6_bound_s``)
over its mean device time a launch, in %."""

from portbench.yardstick import work

SYMBOL = "lanczos_forward_kernel"


def read(run):
    seen = run.trace.durations(SYMBOL)
    f = run.facts
    if not seen or "num_diags" not in f:
        return None
    mean = sum(t for _n, t in seen) / len(seen)
    return 100.0 * work.k6_bound_s(f["n"], f["num_diags"], f["depth"]) / mean
