"""Kernel and call timing on the card: CUDA events, the profiler's kernel times, and
the JAX package's ``slope_time``, ``profile_to`` and ``wallclock_time``."""

import contextlib
import os
import time

import numpy as np
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


def median_seconds(fn, *, device, reps: int, outer: int) -> float:
    """Median over ``outer`` runs of the mean seconds of ``reps`` back-to-back calls of ``fn()``.

    CUDA events (``events_ms``) on a card, a host clock elsewhere. Warm
    ``fn`` up first.
    """
    runs = []
    for _ in range(outer):
        if torch.device(device).type == "cuda":
            runs.append(events_ms(fn, reps) / 1e3)
        else:
            start = time.perf_counter()
            for _ in range(reps):
                fn()
            runs.append((time.perf_counter() - start) / reps)
    return float(np.median(runs))


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


# A spin of this many seconds (at the H100's 1.98 GHz top clock; longer on
# a slower clock) holds the stream while the host enqueues a timed run.
HOLD_S = 0.1
_HOLD_CYCLES_PER_S = 1.98e9


def device_seconds(fn, *, reps: int, device) -> tuple:
    """``(seconds per call, clock)`` of ``reps`` back-to-back calls of ``fn()``.

    On a card the device's time: CUDA events around the ``reps`` calls,
    queued behind a spin kernel (``torch.cuda._sleep``) that holds the
    stream for ``HOLD_S`` while the host enqueues them, so the host's
    launch time is hidden and the device's own gaps between kernels count
    (clock ``"events"``). Where the host took longer to enqueue than the
    hold, the reading includes its gaps and is an upper bound (clock
    ``"events, host-bound"``). Not the profiler: it misses launches in
    some windows, and a sum over what it saw then undercounts. ``fn``
    runs exactly ``reps`` times. Elsewhere a host clock (``"host"``).
    Warm ``fn`` up first.
    """
    if torch.device(device).type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) / reps, "host"
    held, begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    held.record()
    torch.cuda._sleep(int(HOLD_S * _HOLD_CYCLES_PER_S))
    begin.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    hold_s = held.elapsed_time(begin) / 1e3
    return begin.elapsed_time(end) / reps / 1e3, "events" if enqueue_s < hold_s else "events, host-bound"


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


def _leaves(tree):
    """The tensors of a tensor, or of a (nested) tuple, list or dict of them, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _sync(*trees):
    """Wait for the card if any tensor of ``trees`` lives on one."""
    if any(leaf.is_cuda for tree in trees for leaf in _leaves(tree)):
        torch.cuda.synchronize()


def slope_time(
    fn,
    *args,
    reps: int = 8,
    outer: int = 5,
    feedback_scale: float = 1e-12,
    min_window: float = 5e-3,
    max_reps: int = 4096,
    budget_s: float = 120.0,
    return_info: bool = False,
):
    """Seconds per evaluation of ``fn(*args)``, from the slope between ``reps`` chained calls and one.

    Counterpart of ``lanczos_adjoints_tpu/utils/timing.py::slope_time``,
    with its escalation, budget and fallback rules: each run of ``reps``
    calls feeds ``feedback_scale`` times its output back into the first
    argument (so no call can be skipped), the device is synchronised
    before each clock reading, and the per-call time is the difference of
    the medians over ``outer`` runs, divided by ``reps - 1``. A window
    below ``min_window`` escalates ``reps`` eightfold while the cost model
    says the next run fits ``budget_s``; if not even two calls fit, one
    call's wall time is returned, flagged ``fallback_wallclock``.
    ``return_info=True`` also returns ``{"resolved", "window_s", "reps",
    "budget_exhausted", "fallback_wallclock"}``.
    """
    import warnings

    first, *rest = args

    def repeated(count):
        x, acc = first, torch.zeros((), dtype=first.dtype, device=first.device)
        for _ in range(count):
            out_flat = torch.cat([leaf.reshape(-1) for leaf in _leaves(fn(x, *rest))])
            feedback = out_flat[: first.numel()]
            feedback = (feedback.reshape(first.shape) if feedback.numel() == first.numel()
                        else torch.zeros_like(first))
            x = x + feedback_scale * feedback
            acc = acc + torch.sum(out_flat)
        return acc

    def timed(count):
        _sync(args)
        t0 = time.perf_counter()
        _sync(repeated(count))
        return time.perf_counter() - t0

    repeated(1)  # warm-up
    t_start = time.perf_counter()
    t_single = max(timed(1), 1e-9)

    def remaining():
        return budget_s - (time.perf_counter() - t_start)

    per_est = t_single

    def affordable(count):
        return (outer + 1) * (t_single + count * per_est) + outer * t_single <= remaining()

    def measure(count):
        repeated(count)
        t_many, t_one = [], []
        for _ in range(outer):
            t_many.append(timed(count))
            t_one.append(timed(1))
        window = float(np.median(t_many)) - float(np.median(t_one))
        return window / (count - 1), window

    budget_exhausted = fallback = False
    if not affordable(2):
        per_iter, window, reps = t_single, 0.0, 1
        budget_exhausted = fallback = True
    else:
        reps = max(2, reps)
        while reps > 2 and not affordable(reps):
            reps //= 2
        per_iter, window = measure(reps)
        per_est = max(per_iter, 1e-9)
        while window < min_window and reps < max_reps:
            next_reps = min(max_reps, reps * 8)
            while next_reps > reps and not affordable(next_reps):
                next_reps //= 2
            if next_reps <= reps:
                budget_exhausted = True
                break
            reps = next_reps
            per_iter, window = measure(reps)
            per_est = max(per_iter, 1e-9)
    if window < min_window:
        why = "budget exhausted" if budget_exhausted else "slope unreliable"
        warnings.warn(f"measurement window {window * 1e3:.2f} ms stayed below {min_window * 1e3:.0f} ms at "
                      f"reps={reps}; {why}", stacklevel=2)
    if return_info:
        return per_iter, {"resolved": bool(window >= min_window), "window_s": float(window), "reps": int(reps),
                          "budget_exhausted": budget_exhausted, "fallback_wallclock": fallback}
    return per_iter


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Trace the block with ``torch.profiler`` (the card's kernels too, where one is
    present) into ``{log_dir}/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def wallclock_time(fn, *args, repeats: int = 5) -> float:
    """Median host seconds of ``fn(*args)`` over ``repeats`` calls after one warm-up,
    each ended by a synchronise where its output lives on the card."""
    _sync(fn(*args))
    times = []
    for _ in range(repeats):
        _sync(args)
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
