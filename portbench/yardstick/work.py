"""The least time of each kernel's work, whatever implements it.

Frozen copies of ``chip_smoke.py``'s ``_cell_ops``, ``_gram_bound``,
``_k6_traffic`` and ``_k7_traffic`` (the "each array once" parts). Each
array is counted once, read or written, whatever a kernel reads again.
"""

from portbench.yardstick import peaks


def cell_ops(kernel: str, m: int, d: int = 8) -> tuple:
    """(fp32 operations, contraction operations) per Gram cell.

    Distance 3d and the Matern-3/2 value 5 (K1); value and derivative plus
    the weighted sums 5d + 9 (K2), or the derivative and the moments
    5d + 10 (K3); the contraction 2m. K1, and K2 and K3 for m > 1, contract
    on the tensor cores (3xTF32); K2 and K3 at m = 1 multiply once a cell
    on the fp32 pipes, so their second number is 0 and the first holds it.
    """
    fp32 = {"K1": 3 * d + 5, "K2": 5 * d + 9, "K3": 5 * d + 10}[kernel]
    if kernel == "K1" or m > 1:
        return fp32, 2 * m
    return 2 * m + fp32, 0


def gram_bytes(rows: int, cols: int, m: int, d: int = 8) -> int:
    """A Gram launch's arrays once: both inputs, v (and u) and the output, float32."""
    return 4 * ((rows + cols) * d + 2 * (rows + cols) * m)


def gram_bound_s(kernel: str, rows: int, cols: int, m: int, d: int = 8) -> float:
    """Seconds: the larger of the fp32 operations at the fp32 peak, the
    contraction at the 3xTF32 rate and the bytes at the HBM rate."""
    fp32_ops, mma_ops = cell_ops(kernel, m, d)
    cells = rows * cols
    return max(cells * fp32_ops / peaks.PEAK_FLOPS_FP32,
               cells * mma_ops / peaks.PEAK_FLOPS_3XTF32,
               gram_bytes(rows, cols, m, d) / peaks.PEAK_BYTES)


def k6_bytes(n: int, num_diags: int, depth: int) -> int:
    """K6 (Lanczos forward on DIA): the values, v0 and the K + 1 basis rows, once."""
    return 4 * (num_diags + 1 + depth + 1) * n


def k7_bytes(n: int, num_diags: int, depth: int) -> int:
    """K7 (its adjoint): the basis and its cotangent (K + 1 rows each), the
    values and dvals (D rows each) and dv, once."""
    return 4 * (2 * (depth + 1) + 2 * num_diags + 1) * n


def k6_bound_s(n: int, num_diags: int, depth: int) -> float:
    return k6_bytes(n, num_diags, depth) / peaks.PEAK_BYTES


def k7_bound_s(n: int, num_diags: int, depth: int) -> float:
    return k7_bytes(n, num_diags, depth) / peaks.PEAK_BYTES


def gp_step_bound_s(*, n: int, d: int, depth: int, probes: int, pcg_steps: int, rank: int) -> float:
    """The least time of one GP training step's Gram work, from the algorithm.

    Forward: ``depth`` blocked Lanczos products at m = probes and
    ``pcg_steps`` PCG products at m = 1; the preconditioner's ``rank``
    kernel columns (K1's cell cost, no contraction). Backward: the blocked
    adjoint's ``depth`` products at m = probes, the implicit solve's
    ``pcg_steps`` products at m = 1 (the same adaptive PCG, counted at the
    forward's steps), and the two parameter VJPs (K2) at m = depth x probes
    and m = 1. PCG's start product ``A 0`` is not work the algorithm needs,
    and is not counted.
    """
    k1_wide = gram_bound_s("K1", n, n, probes, d)
    k1_one = gram_bound_s("K1", n, n, 1, d)
    panel = n * rank * cell_ops("K1", 1, d)[0] / peaks.PEAK_FLOPS_FP32
    return (2 * depth * k1_wide + 2 * pcg_steps * k1_one + panel
            + gram_bound_s("K2", n, n, depth * probes, d) + gram_bound_s("K2", n, n, 1, d))
