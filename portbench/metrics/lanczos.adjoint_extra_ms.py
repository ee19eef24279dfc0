"""Device time a request in the fused Lanczos backward wrapper outside K7:
the ``lanczos.dia_adjoint`` spans' device intervals less the K7 launches
counted in them at K7's mean device time in the profile (the cotangents'
``torch.cat``, K7's launch and any wait for the host inside the wrapper),
over the traced requests, in ms a request."""

from portbench import spans

K7, SYMBOL = "lanczos_dia_adjoint", "lanczos_adjoint_kernel"


def read(run):
    records = spans.records(("lanczos.dia_adjoint",))
    requests = run.facts.get("requests")
    if not records or not requests or run.trace is None or any(r.device_s is None for r in records):
        return None
    seen = [t for _n, t in run.trace.durations(SYMBOL)]
    launches = sum(r.launches.get(K7, 0) for r in records)
    if not seen or not launches:
        return None
    return 1e3 * (sum(r.device_s for r in records) - launches * sum(seen) / len(seen)) / requests
