"""The GP step's Gram work, bounded as the yardstick bounds each term
(``work.gp_step_bound_s``), over the traced steps' wall time, in %."""


def read(run):
    steps = run.facts.get("steps")
    if not steps:
        return None
    return 100.0 * sum(run.facts["step_bounds_s"]) / sum(s["seconds"] for s in steps)
