"""Both cells on the card at the CPU tests' sizes, traced, through the
port's CUDA kernels. Run on a machine with a card:
``python3 -m pytest portbench/tests -m card``."""

import time

import pytest
import torch

from portbench import core
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("name", [tiny.GP, tiny.VJP])
def test_cell_on_the_card_traced(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tiny.cell(name)
    result, lines = core.run_cell(tiny.ROOT, name, seed=2**31 + 3, seconds=1.0, trace=True,
                                  t0=time.perf_counter(), found=spec)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["metrics"], result
    for metric, value in result["metrics"].items():
        if metric.endswith("_roofline") or "mfu" in metric:
            assert 0 < value["value"] <= 105, (metric, value)


@pytest.mark.card
def test_fused_matern_matches_its_separate_operations():
    """The GP reference's elementwise expressions on the card against the
    same arithmetic in separate operations on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.reference import gp_train_step as gp_ref

    gen = torch.Generator().manual_seed(1)
    r = torch.rand(300, 200, generator=gen) * 30 - 1e-3
    m = torch.randn(300, 200, generator=gen)
    pairs = [(gp_ref.matern(r.cuda()), gp_ref.matern(r))]
    pairs += list(zip(gp_ref.matern_parts(m.cuda(), r.cuda()), gp_ref.matern_parts(m, r)))
    for fused, plain in pairs:
        assert torch.allclose(fused.cpu(), plain, rtol=1e-6, atol=1e-7)
