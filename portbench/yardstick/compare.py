"""The measures that the comparisons with the plain references read.

Every number is a gap that must stay at or below its limit; a number that
is not finite fails.
"""

import math

import torch


def rel_max(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got = got.detach().to(torch.float64)
    want = want.detach().to(device=got.device, dtype=torch.float64)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else float((got - want).abs().max())


def rel_scalar(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want != 0 else abs(got - want)


def leaf_norm_gaps(got: dict, want: dict, *, floor_share: float = 1e-3) -> tuple:
    """Per leaf, the gap of the norms, ``| |got| - |want| |``, over the larger
    of ``|want|`` and the median leaf's ``|want|``.

    Leaves whose reference norm is under ``floor_share`` of the median
    leaf's are nought to rounding and left out: ``(gaps, left_out)``.
    """
    norms = {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64))) for k, v in want.items()}
    ordered = sorted(norms.values())
    mid = len(ordered) // 2
    median = ordered[mid] if len(ordered) % 2 else 0.5 * (ordered[mid - 1] + ordered[mid])
    gaps, left_out = {}, []
    for k, ref in norms.items():
        if ref < floor_share * median:
            left_out.append(k)
            continue
        ours = float(torch.linalg.vector_norm(got[k].detach().to(torch.float64)))
        gaps[k] = abs(ours - ref) / max(ref, median)
    return gaps, left_out


def verdict(numbers: dict, limits: dict, left_out=()) -> tuple:
    """``(correct, checks)``: every number finite and within its limit;
    ``checks`` maps each name to ``{"value", "limit"}``. A limit with no
    number fails, unless its name is in ``left_out`` (a leaf that the
    reference's gradient puts at nought)."""
    checks, correct = {}, True
    for name, limit in limits.items():
        if name in left_out:
            continue
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        # A number that is not finite is written as text: the line stays JSON.
        shown = value if value is None or math.isfinite(value) else repr(value)
        checks[name] = {"value": shown, "limit": limit}
    return correct, checks
