"""Device seconds a step in PCG and its implicit derivative (``solvers/cg.py``):
the self time of the ``cg.solve`` and ``cg.solve_adjoint`` spans, their
``gram.vjp`` left out, over the traced steps."""

from portbench import spans


def read(run):
    return spans.per_step(run, ("cg.solve", "cg.solve_adjoint"), "self_device_s")
