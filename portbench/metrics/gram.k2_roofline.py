"""K2's least time over its device time, in %, summed over the launches the
profiler saw, each bounded at its own m: the kernel's ``ONE`` template flag
(``true``: m = 1, the solve's VJP; ``false``: m = depth x probes, the
deferred Lanczos VJP) is read from the launch's name."""

SYMBOL = "gram_grads_kernel"


def read(run):
    seen = run.trace.durations(SYMBOL)
    bounds = run.facts.get("k2_bound_s")
    if not seen or bounds is None:
        return None
    total_bound = 0.0
    for name, _t in seen:
        args = name.split("<", 1)[1].split(">", 1)[0] if "<" in name else ""
        flag = args.replace(" ", "").split(",")[-1] if args else ""
        if flag == "true":
            total_bound += bounds["one"]
        elif flag == "false":
            total_bound += bounds["wide"]
        else:
            return None
    return 100.0 * total_bound / sum(t for _n, t in seen)
