"""PCG iterations of the training solve a step (the step's info), over the traced steps."""


def read(run):
    steps = run.facts.get("steps")
    if not steps:
        return None
    return sum(s["pcg_steps"] for s in steps) / len(steps)
