"""The per-layer metrics that read the port's spans, from a synthetic profile and
span store with known busy, idle and span intervals; each reads nothing
(``None``) where its spans are missing, as on a program without them."""

import sys
from types import SimpleNamespace

import pytest

from portbench import core
from portbench.tests import tiny
from portbench.yardstick.trace import WINDOW_MARK, Trace
from lanczos_adjoints_tpu_torch import utils
from lanczos_adjoints_tpu_torch.utils import spans

GP_METRICS = ("gp.precond_s", "gp.slq_s", "gp.solve_s", "gp.k2_vjp_s")
VJP_SPAN_METRICS = ("lanczos.forward_host_us", "lanczos.adjoint_host_us", "lanczos.adjoint_extra_ms")
VJP_TRACE_METRICS = ("device_idle.grad.program", "alloc.mallocs.grad")
K7 = "lanczos_dia_adjoint"


def metric(name):
    return core.load_module(tiny.ROOT / "portbench" / "metrics" / f"{name}.py", name).read


def record(name, parent=None, *, host_us=0.0, device_s=None, self_s=None, launches=None):
    return spans.Record(name, parent, 0, int(1e3 * host_us), device_s, self_s, launches or {})


# Two GP steps: per step, the factor 0.25 s; the Lanczos 3 s and its adjoint
# 4 s, of which a Gram VJP takes 1; PCG 2 s and its derivative 2.5, of
# which a Gram VJP takes 0.5.
GP_STEP = [
    record("gp.loss", device_s=5.25, self_s=0.0),
    record("precond.cholesky", 0, device_s=0.25, self_s=0.25),
    record("slq.lanczos", 0, device_s=3.0, self_s=3.0),
    record("cg.solve", 0, device_s=2.0, self_s=2.0),
    record("gp.backward", device_s=6.5, self_s=0.0),
    record("slq.adjoint", 4, device_s=4.0, self_s=3.0),
    record("gram.vjp", 5, device_s=1.0, self_s=1.0),
    record("cg.solve_adjoint", 4, device_s=2.5, self_s=2.0),
    record("gram.vjp", 7, device_s=0.5, self_s=0.5),
    record("gp.optimizer", device_s=0.01, self_s=0.01),
]
GP_EXPECTED = {"gp.precond_s": 0.25, "gp.slq_s": 6.0, "gp.solve_s": 4.0, "gp.k2_vjp_s": 1.5}

# Four requests: the forward wrapper 100, 120, 140, 1000 us on the host;
# the backward wrapper 200-500 us, its device interval 2.5 ms around one
# K7 launch, which the profile shows at 2.1 and 2.3 ms (two of four seen).
VJP_REQUESTS = [
    r
    for fwd, adj in ((100, 200), (120, 300), (140, 400), (1000, 500))
    for r in (record("lanczos.dia_forward", host_us=fwd, device_s=1.2e-3, self_s=1.2e-3),
              record("lanczos.dia_adjoint", host_us=adj, device_s=2.5e-3, self_s=2.5e-3,
                     launches={K7: 1}))
]
K7_SEEN = Trace([("lanczos_adjoint_kernel<false, 16>", 0.0, 2100.0),
                 ("lanczos_adjoint_kernel<false, 16>", 5000.0, 7300.0)], [], 1e-2, None)
VJP_EXPECTED = {"lanczos.forward_host_us": 130.0, "lanczos.adjoint_host_us": 350.0,
                "lanczos.adjoint_extra_ms": 0.3}


def synthetic_trace():
    """A 1,000 us window: the device busy over [100, 300] and [500, 600] us,
    the port's spans over [50, 150], [250, 550] (nested in it [260, 270])
    and [900, 950] us, so the device idles 300 us (30 %) inside them and
    400 us outside; two ``cudaMalloc`` inside the spans and one outside."""
    device = [("k7", 100.0, 300.0), ("cat", 500.0, 600.0)]
    host = [(WINDOW_MARK, 0.0, 1000.0), ("lat.lanczos.dia_forward", 50.0, 150.0),
            ("lat.lanczos.dia_adjoint", 250.0, 550.0), ("lat.inner", 260.0, 270.0),
            ("lat.lanczos.dia_forward", 900.0, 950.0), ("cudaMalloc", 60.0, 61.0),
            ("cudaMalloc", 400.0, 401.0), ("cudaMalloc", 700.0, 701.0), ("aten::cat", 580.0, 590.0)]
    return Trace(device, host, 1e-3, (0.0, 1000.0))


def run_of(trace=None, **facts):
    return SimpleNamespace(config={}, traffic={}, trace=trace, facts=facts)


@pytest.fixture
def store(monkeypatch):
    """The span store's ``records()``, as the test sets it."""
    held = {"records": []}
    monkeypatch.setattr(spans, "records", lambda: list(held["records"]))
    return held


@pytest.mark.parametrize("name", GP_METRICS)
def test_gp_phase_metrics(store, name):
    store["records"] = GP_STEP * 2
    run = run_of(steps=[{}, {}])
    assert metric(name)(run) == pytest.approx(GP_EXPECTED[name])
    store["records"] = [r for r in GP_STEP if r.name == "gp.loss"]
    assert metric(name)(run) is None


@pytest.mark.parametrize("name", VJP_SPAN_METRICS)
def test_vjp_span_metrics(store, name):
    store["records"] = VJP_REQUESTS
    run = run_of(K7_SEEN, requests=4)
    assert metric(name)(run) == pytest.approx(VJP_EXPECTED[name])
    store["records"] = []
    assert metric(name)(run) is None


def test_device_idle_inside_the_program():
    trace = synthetic_trace()
    program = metric("device_idle.grad.program")(run_of(trace, requests=2))
    assert program == pytest.approx(30.0)
    assert program <= metric("device_idle.grad")(run_of(trace)) == pytest.approx(70.0)


def test_mallocs_inside_the_program():
    assert metric("alloc.mallocs.grad")(run_of(synthetic_trace(), requests=2)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", VJP_TRACE_METRICS)
def test_trace_metrics_without_spans(name):
    trace = synthetic_trace()
    trace.host = [e for e in trace.host if not e[0].startswith("lat.")]
    assert metric(name)(run_of(trace, requests=2)) is None


@pytest.mark.parametrize("name", GP_METRICS + VJP_SPAN_METRICS)
def test_span_metrics_on_a_program_without_a_span_store(monkeypatch, name):
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "lanczos_adjoints_tpu_torch.utils.spans", None)
    assert metric(name)(run_of(steps=[{}], requests=1)) is None
