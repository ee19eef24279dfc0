"""Planning and measurement helpers of the port that need no card.

K1's column split (``fused_gram.column_splits``) and the report that
holds a profiler's launch counts to the kernel registry's
(``utils.timing.launch_report``), on a fake profiler table.
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
