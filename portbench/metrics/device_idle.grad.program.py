"""The share of the traced window in which the device was idle while the host
was inside one of the port's spans (a ``lat.*`` host range of the
profile), in %. The rest of ``device_idle.grad`` is the caller's: autograd,
Python, the benchmark's loop."""

from portbench import spans


def read(run):
    t = run.trace
    if t is None or t.mark is None or t.window_s <= 0:
        return None
    program = spans.clip(spans.program(t), *t.mark)
    if not program:
        return None
    busy = spans.union(spans.clip(((s, e) for _n, s, e in t.device), *t.mark))
    idle_us = sum(e - s for s, e in program) - spans.overlap(program, busy)
    return 100.0 * idle_us / 1e6 / t.window_s
