"""The frozen work-and-bytes functions reproduce the bounds of the port's kernel table."""

import pytest

from portbench.yardstick import work

N = 400_000


@pytest.mark.parametrize(("kernel", "m", "ms"), [("K1", 1, 69.3), ("K1", 15, 69.3), ("K2", 1, 121.8),
                                                   ("K2", 225, 436.4)])
def test_gram_bounds(kernel, m, ms):
    assert work.gram_bound_s(kernel, N, N, m) * 1e3 == pytest.approx(ms, abs=0.05)


@pytest.mark.parametrize(("fn", "us"), [(work.k6_bound_s, 121.4), (work.k7_bound_s, 241.6)])
def test_lanczos_bounds(fn, us):
    assert fn(1 << 20, 5, 90) * 1e6 == pytest.approx(us, abs=0.05)


def test_cell_ops_count_the_contraction_once():
    assert work.cell_ops("K1", 15) == (29, 30)
    assert work.cell_ops("K2", 1) == (51, 0)
    assert work.cell_ops("K2", 225) == (49, 450)


def test_gp_step_bound_sums_its_terms():
    bound = work.gp_step_bound_s(n=N, d=8, depth=15, probes=15, pcg_steps=10, rank=448)
    gram = (30 + 20) * work.gram_bound_s("K1", N, N, 15) + work.gram_bound_s("K2", N, N, 225) \
        + work.gram_bound_s("K2", N, N, 1)
    assert gram < bound < gram * 1.001
    assert bound == pytest.approx(4.02, abs=0.01)
