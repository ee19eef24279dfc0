"""K1's least time at the cell's shape (the same bound at every m it runs,
``work.gram_bound_s``) over its mean device time a launch, in %."""

SYMBOL = "gram_matvec_kernel"


def read(run):
    seen = run.trace.durations(SYMBOL)
    if not seen or "k1_bound_s" not in run.facts:
        return None
    mean = sum(t for _n, t in seen) / len(seen)
    return 100.0 * run.facts["k1_bound_s"] / mean
