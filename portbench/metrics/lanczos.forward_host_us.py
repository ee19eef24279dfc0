"""The host's time a call in the fused Lanczos forward wrapper
(``ops/fused_lanczos.py`` ``_FusedLanczos.forward``, K6's launch
included): the median ``lanczos.dia_forward`` span, in us."""

import statistics

from portbench import spans


def read(run):
    times = [r.host_s for r in spans.records(("lanczos.dia_forward",)) or ()]
    return 1e6 * statistics.median(times) if times else None
