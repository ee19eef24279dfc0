"""Kernel and call timing on the card: CUDA events and the profiler's kernel times."""

import time

import torch


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs.

    Timed by CUDA events on the current stream: the device's clock from
    the first enqueued run to the end of the last, so it includes any gap
    in which the device waits for the host. Warm ``fn`` up first.
    """
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(fn):
    """Run ``fn()`` once under ``torch.profiler``.

    Returns ``(wall_ms, kernels)``: the host's wall time of the run, ended
    by a synchronise, and ``{name: (count, device_ms)}`` for every kernel,
    copy and fill that the profiler saw on the device. ``kernels`` is
    empty when the profiler records no device activity.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            count, total = kernels.get(event.name, (0, 0.0))
            kernels[event.name] = (count + 1, total + event.time_range.elapsed_us() / 1e3)
    return wall_ms, kernels


def launch_report(kernels, launched, symbols):
    """The profiler's launch counts beside the registry's, by device symbol.

    ``kernels`` is ``device_profile``'s ``{name: (count, device_ms)}``,
    ``launched`` the registry's launches in the same run (``{kernel:
    count}``) and ``symbols`` each kernel's device symbol
    (``ops.native.device_symbols()``). Kernels sharing a symbol (a matvec
    and its transpose) are summed. Returns ``{symbol: (seen, launched)}``
    for every symbol launched or seen, and the symbols where the two
    differ; where the profiler saw fewer, its busy time is a lower bound
    and its idle share an upper bound.
    """
    rows = {}
    for name, symbol in symbols.items():
        if symbol is not None:
            rows[symbol] = rows.get(symbol, 0) + launched.get(name, 0)
    report = {}
    for symbol, count in rows.items():
        seen = sum(c for name, (c, _ms) in kernels.items() if symbol in name)
        if seen or count:
            report[symbol] = (seen, count)
    mismatches = sorted(s for s, (seen, count) in report.items() if seen != count)
    return report, mismatches
