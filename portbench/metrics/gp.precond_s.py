"""Device seconds a step in the preconditioner's factor: the ``precond.cholesky``
spans (``precond/low_rank.py``, the port's span store), over the traced steps."""

from portbench import spans


def read(run):
    return spans.per_step(run, ("precond.cholesky",), "device_s")
