"""K1 launches a step, from the port's launch registry (``ops.native``), over the traced steps."""


def read(run):
    steps = run.facts.get("steps")
    if not steps:
        return None
    return sum(s["k1"] for s in steps) / len(steps)
