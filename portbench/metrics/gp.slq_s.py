"""Device seconds a step in SLQ's blocked Lanczos and its adjoint
(``krylov/lanczos.py`` ``_TridiagBlock``): the self time of the
``slq.lanczos`` and ``slq.adjoint`` spans, their ``gram.vjp`` left out,
over the traced steps."""

from portbench import spans


def read(run):
    return spans.per_step(run, ("slq.lanczos", "slq.adjoint"), "self_device_s")
