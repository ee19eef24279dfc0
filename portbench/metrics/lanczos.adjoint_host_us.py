"""The host's time a call in the fused Lanczos backward wrapper
(``ops/fused_lanczos.py`` ``_FusedLanczos.backward``, K7's launch
included): the median ``lanczos.dia_adjoint`` span, in us."""

import statistics

from portbench import spans


def read(run):
    times = [r.host_s for r in spans.records(("lanczos.dia_adjoint",)) or ()]
    return 1e6 * statistics.median(times) if times else None
