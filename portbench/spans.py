"""What the per-layer metrics read of the port's spans: the span store's
records (``lanczos_adjoints_tpu_torch.utils.spans``) and the profile's
``lat.*`` host ranges. Each reader returns ``None`` where the program has
no span store or the run no such span."""

import bisect

PREFIX = "lat."


def records(names):
    """The port's closed spans named in ``names``; ``None`` on a program without a span store."""
    try:
        from lanczos_adjoints_tpu_torch.utils import spans
    except ImportError:
        return None
    return [r for r in spans.records() if r.name in names]


def per_step(run, names, field):
    """The sum of each span's ``field`` (``device_s`` or ``self_device_s``)
    over the spans ``names``, over the traced steps."""
    times = [getattr(r, field) for r in records(names) or ()]
    steps = run.facts.get("steps")
    if not steps or not times or None in times:
        return None
    return sum(times) / len(steps)


def union(ranges):
    """Sorted, disjoint ``[start, end]`` pairs covering ``ranges``."""
    merged = []
    for s, e in sorted(ranges):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def clip(ranges, lo, hi):
    return [[max(s, lo), min(e, hi)] for s, e in ranges if e > lo and s < hi]


def overlap(a, b):
    """The length of the intersection of two sorted lists of disjoint ranges."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def program(trace):
    """The union of the profile's ``lat.*`` host ranges (us)."""
    return union((s, e) for n, s, e in trace.host if n.startswith(PREFIX))


def inside(ranges, t):
    """Whether the time ``t`` lies inside one of the sorted, disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, [t, float("inf")]) - 1
    return i >= 0 and t <= ranges[i][1]
