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
