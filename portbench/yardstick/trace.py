"""Reduction of one ``torch.profiler`` window to device time, idle share and the breakdown.

Only aggregates are kept: no Chrome trace is written.
"""

import contextlib
import time

import torch

WINDOW_MARK = "portbench.window"


class Trace:
    """Device and host events of one profiled window, on the profiler's clock (us)."""

    def __init__(self, device_events, host_events, window_s, mark):
        self.device = sorted(device_events, key=lambda e: e[1])
        self.host = host_events
        self.window_s = window_s
        self.mark = mark  # (start, end) of the window's own host range, or None

    def _intervals(self):
        lo, hi = self.mark if self.mark else (float("-inf"), float("inf"))
        return [(max(s, lo), min(e, hi)) for _n, s, e in self.device if e > lo and s < hi]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of the events)."""
        total, end = 0.0, float("-inf")
        for s, e in sorted(self._intervals()):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e6

    def durations(self, symbol: str) -> list:
        """``[(name, seconds)]`` of the device events whose name holds ``symbol``."""
        return [(n, (e - s) / 1e6) for n, s, e in self.device if symbol in n]

    def top_ops(self, k: int = 10) -> list:
        totals = {}
        for n, s, e in self.device:
            short = short_name(n)
            totals[short] = totals.get(short, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps between device events, each named by the
        innermost host range open at its middle (what the host was doing)."""
        gaps, end = [], self.mark[0] if self.mark else None
        for s, e in sorted(self._intervals()):
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        if self.mark and end is not None and self.mark[1] > end:
            gaps.append((self.mark[1] - end, end, self.mark[1]))
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            inner = None
            for n, hs, he in self.host:
                if hs <= mid <= he and n != WINDOW_MARK and (inner is None or he - hs < inner[2] - inner[1]):
                    inner = (n, hs, he)
            out.append([f"host: {inner[0] if inner else 'python'}", length / 1e6])
        return out


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:80]


@contextlib.contextmanager
def profiled():
    """Profile the body on the host and the device; yields a holder whose
    ``.trace`` is set on exit. The body's own range is marked."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"trace": None})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        with record_function(WINDOW_MARK):
            yield holder
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    device, host, mark = [], [], None
    for event in prof.events():
        rng = (event.name, event.time_range.start, event.time_range.end)
        if event.device_type == torch.autograd.DeviceType.CUDA:
            # A host range (``record_function``) is mirrored on the device's
            # timeline as an annotation; it is no operation.
            if event.name != WINDOW_MARK and not getattr(event, "is_user_annotation", False):
                device.append(rng)
        else:
            host.append(rng)
            if event.name == WINDOW_MARK:
                mark = rng[1:]
    holder.trace = Trace(device, host, window_s, mark)
