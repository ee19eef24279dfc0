"""Planning and measurement helpers of the port that need no card.

K1's column split (``fused_gram.column_splits``), the report that holds
a profiler's launch counts to the kernel registry's
(``utils.timing.launch_report``), on a fake profiler table, and the Gram
kernels', K6's, K9's and K11's bounds and traffic as ``chip_smoke.py``
computes them.
"""

import pytest

from lanczos_adjoints_tpu_torch.ops import fused_gram
from lanczos_adjoints_tpu_torch.utils.timing import launch_report

H100_SMS = 132


@pytest.mark.parametrize(("n_rows", "splits"), [(400_000, 1), (100_000, 2), (50_000, 4), (1_000, 8)])
def test_column_splits_fill_the_last_wave(n_rows, splits):
    """400,000 rows give 3,125 blocks of 128, six waves of the card's
    4 x 132 block slots: no split. One of 8 row partitions (50,000 rows,
    391 blocks, three quarters of one wave) splits the columns in four,
    whose 1,564 blocks fill three waves to 99 %."""
    got = fused_gram.column_splits(n_rows, 400_000, H100_SMS)
    assert got == splits
    slots = fused_gram.K1_BLOCKS_PER_SM * H100_SMS
    waves = -(-n_rows // fused_gram.K1_ROWS) * got / slots
    assert got == 1 or waves / -(-waves // 1) > 0.95 or got == 8


def test_column_splits_keep_segments_long():
    assert fused_gram.column_splits(1_000, 4_096, H100_SMS) == 2  # segments of >= 2,048 columns
    assert fused_gram.column_splits(1_000, 1_000, H100_SMS) == 1
    assert fused_gram.column_splits(3_000, 20_000, H100_SMS) == 8


_SYMBOLS = {"dia_matvec": "dia_matvec_kernel", "dia_matvec_transposed": "dia_matvec_kernel",
            "bsr_spmv": "bsr_csr_spmv_kernel", "gram_matvec": "gram_matvec_kernel"}


def test_launch_report_flags_what_the_profiler_missed():
    kernels = {  # device_profile's {name: (count, device ms)}
        "void (anonymous namespace)::bsr_csr_spmv_kernel<8>(float const*, ...)": (179, 1.79),
        "void (anonymous namespace)::dia_matvec_kernel<5>(float const*, ...)": (60, 0.6),
        "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>(...)": (12, 0.1),
    }
    launched = {"bsr_spmv": 180, "dia_matvec": 30, "dia_matvec_transposed": 30, "gram_matvec": 0}
    report, mismatches = launch_report(kernels, launched, _SYMBOLS)
    assert report == {"bsr_csr_spmv_kernel": (179, 180), "dia_matvec_kernel": (60, 60)}
    assert mismatches == ["bsr_csr_spmv_kernel"]


def test_launch_report_is_empty_when_nothing_ran_and_counts_unseen_launches():
    assert launch_report({}, {"bsr_spmv": 0}, _SYMBOLS) == ({}, [])
    report, mismatches = launch_report({}, {"gram_matvec": 2}, _SYMBOLS)
    assert report == {"gram_matvec_kernel": (0, 2)} and mismatches == ["gram_matvec_kernel"]


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports no CUDA at module level)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    ("kernel", "m", "bound_ms", "all_fp32_ms"),
    [
        ("K2", 225, 436.4, 1191.6),  # the contraction at the 3xTF32 rate
        ("K2", 1, 121.8, 121.8),  # one multiply a cell, on the fp32 pipes
        ("K1", 15, 69.3, 140.9),
        ("K1", 1, 69.3, 74.0),
        ("K3", 225, 436.4, 1194.0),  # the contraction at the 3xTF32 rate, as K2's
        ("K3", 1, 124.2, 124.2),
    ],
)
def test_gram_bounds_at_n_400k(kernel, m, bound_ms, all_fp32_ms):
    """The Gram kernels' bounds at N = M = 400,000, d = 8, as ``[timing]``
    computes them: bound by operations, the all-fp32 bound beside it."""
    cs = _chip_smoke()
    n = 400_000
    nbytes = 4 * (2 * n * 8 + 2 * n * m + -(-n // fused_gram._GRADS_BLOCK_ROWS) * 9)
    got, by, all_fp32 = cs._gram_bound(kernel, n * n, m, nbytes)
    assert by == "operations"
    assert round(got, 1) == bound_ms
    assert round(all_fp32, 1) == all_fp32_ms


@pytest.mark.parametrize("plain", ["gram_grads_plain", "gram_dgrads_plain"])
@pytest.mark.parametrize("m", [1, 8, 15, 225])
def test_k2_operands_pad_m_with_zero_columns(m, plain):
    """K2 and K3 take m = 1 or m in multiples of 4: the zero columns that
    the wrapper adds leave the plain totals (K2) and moments (K3) as they
    were."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    xs, ys = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for shape in ((37, 8), (29, 8)))
    v2, u2 = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for shape in ((29, m), (37, m)))
    pv, pu = fused_gram.grads_operands(v2, u2)
    assert pv.shape[1] == pu.shape[1] == (m if m == 1 else -(-m // 4) * 4)
    assert torch.equal(pv[:, :m], v2) and torch.equal(pu[:, :m], u2)
    assert not pv[:, m:].any() and not pu[:, m:].any()
    fn = getattr(fused_gram, plain)
    want = fn("matern32", xs, ys, v2, u2)
    torch.testing.assert_close(fn("matern32", xs, ys, pv, pu), want,
                               rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize(
    ("n", "depth", "reortho", "bound_ms", "by", "streamed_ms", "on_chip"),
    [
        (1_000_000, 90, "full", 0.502, "operations", 14.78, False),  # 49.5 GB: three sweeps of the basis a step
        (1_000_000, 90, "none", 0.258, "operations", 9.895, False),  # two sweeps
        (16_384, 90, "full", 0.0082, "operations", 0.2422, True),
        (16_384, 90, "none", 0.00423, "operations", 0.1621, True),
        (16_384, 250, "full", 0.0620, "operations", 1.846, True),
        (100_489, 90, "full", 0.0505, "operations", 1.49, False),
        (262_144, 250, "full", 0.992, "operations", 29.54, False),
    ],
)
def test_arnoldi_bounds(n, depth, reortho, bound_ms, by, streamed_ms, on_chip):
    """K9's bound as ``[timing-arnoldi]`` computes it, each array once, and
    beside it the traffic of the streamed schedule (three reads of Q[:i+1]
    a step with re-orthogonalisation, two without), which the card needs
    only where the (K, n) basis exceeds its 132 x 227 KB of shared memory."""
    cs = _chip_smoke()
    got = cs._arnoldi_bounds(n, depth, reortho)
    assert got["basis_on_chip"] is on_chip
    assert got["bound_by"] == by
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=5e-3)
    assert got["bound_ms_streamed"] == pytest.approx(streamed_ms, rel=5e-3)
    assert got["bound_ms"] <= got["bound_ms_streamed"]
    reads = 3 if reortho == "full" else 2
    assert got["bytes_streamed"] - got["bound_bytes"] == 4 * reads * n * depth * (depth + 1) // 2


@pytest.mark.parametrize(
    ("n", "num_diags", "once_ms", "parent_ms", "per_step"),
    [
        (1 << 20, 5, 0.1214, 1.465, 3),  # all of the values on chip: r, its shifted reads, the basis row
        (1 << 20, 65, 0.1966, 8.226, 61),  # 58 diagonals of the values read each step
        (16_384, 5, 0.0019, 0.0229, 1),  # the cluster path: r in shared memory
    ],
)
def test_k6_traffic(n, num_diags, once_ms, parent_ms, per_step):
    """K6's bytes as ``[timing-sparse]`` prints them at K = 90: each array
    once (the bound; 121.4 us at (2^20, 5)), the parent's (D + 8) vectors
    a step, and this schedule's 3 (grid) or 1 (cluster) a step, one more
    for each diagonal of the values not in shared memory."""
    from lanczos_adjoints_tpu_torch.ops import fused_lanczos

    cs = _chip_smoke()
    band = tuple(range(-(num_diags // 2), num_diags - num_diags // 2))
    plan = fused_lanczos.forward_plan(n, 90, H100_SMS, 232_448, offsets=band)
    got = cs._k6_traffic(n, num_diags, 90, plan)
    ms = {key: 1e3 * v / cs.PEAK_BYTES for key, v in got.items()}
    assert ms["bytes_once"] == pytest.approx(once_ms, rel=5e-3)
    assert ms["bytes_parent_schedule"] == pytest.approx(parent_ms, rel=5e-3)
    assert got["bytes_parent_schedule"] == 4 * 90 * (num_diags + 8) * n
    assert got["bytes_schedule"] == 4 * (90 * per_step + plan.resident_diags + 2) * n
    assert got["bytes_once"] <= got["bytes_schedule"] < got["bytes_parent_schedule"]


@pytest.mark.parametrize("n_partitions", [1, 2, 4, 8])
def test_k11_bound_and_traffic(n_partitions):
    """K11 at the slice's shape (n = 2^20, D = 5, halo 1,024), as
    ``[timing-halo]`` computes it: bound by bytes, each array once (the
    values, v and the output: 8.76 us); this schedule reads the 2 P halo
    floats of the neighbours once more, the parent's also wrote them into
    receive buffers and read them back."""
    cs = _chip_smoke()
    n, num_diags, halo = 1 << 20, 5, 1024
    got = cs._k11_traffic(n, num_diags, n_partitions, halo)
    bound_ms, by = cs._bound(got["bytes_once"], 2 * num_diags * n)
    assert by == "bytes" and bound_ms == pytest.approx(8.764e-3, rel=1e-3)
    halos = 4 * 2 * n_partitions * halo
    assert got["bytes_once"] == 4 * 7 * n
    assert got["bytes_schedule"] - got["bytes_once"] == halos
    assert got["bytes_parent_schedule"] - got["bytes_once"] == 3 * halos
