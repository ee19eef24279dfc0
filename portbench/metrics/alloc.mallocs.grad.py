"""``cudaMalloc`` calls a request made while the host was inside one of the
port's spans: the profile's ``cudaMalloc`` host events that start inside a
``lat.*`` host range, over the traced requests."""

from portbench import spans


def read(run):
    t, requests = run.trace, run.facts.get("requests")
    if t is None or not requests:
        return None
    program = spans.program(t)
    if not program:
        return None
    return sum(spans.inside(program, s) for n, s, _e in t.host if n == "cudaMalloc") / requests
