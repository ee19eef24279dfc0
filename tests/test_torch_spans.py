"""The port's span store (``utils.spans``) and the launch registry's report to it, on the CPU.

- With no profiler recording, a span is one shared object that does
  nothing: no record, no ``record_function``, no CUDA event.
- Nesting, parents and self time, including a span opened in an autograd
  backward and one opened on another thread while a top-level span is
  open (the autograd engine's device thread on a card).
- ``ops.native.Kernel.launch`` counts each accepted launch in the
  innermost open span, and makes no CUDA event for it.
- Each span's host start and end lie within 200 us of the profiler's
  ``lat.<name>`` range.
- One ``train.gp.train_step`` gives the span tree of the GP step, each
  top-level span once a step; ``fused_lanczos.tridiag_dia_fused`` on its
  plain path gives one ``lanczos.dia_forward`` and one
  ``lanczos.dia_adjoint`` a VJP.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lanczos_adjoints_tpu_torch.ops import fused_dia, fused_lanczos, gram, native, sparse
from lanczos_adjoints_tpu_torch.train import gp as train_gp
from lanczos_adjoints_tpu_torch.utils import spans
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP step's many small operations slow down
    sharply when their threads compete with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_store(monkeypatch):
    """float32 as the port requires it, no card (these tests run on the CPU
    wherever they run), and a store that the next recording clears (a test
    that failed inside a recording leaves its store live)."""
    pin_float32()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spans.tracing()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def host_events(monkeypatch):
    """Event pairs on the host's clock, as if a card were present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(spans, "_stream", lambda: None)


def test_off_records_nothing_and_makes_no_events(monkeypatch):
    with _recording():
        with spans.span("before"):
            pass
    before = spans.records()
    assert [r.name for r in before] == ["before"]

    def refuse(*_args, **_kwargs):
        raise AssertionError("made while no profiler records")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    assert not spans.tracing()
    null = spans.span("a")
    assert null is spans.span("b")
    with null as inner:
        assert inner is None
        spans.launched("k")
    assert spans.records() == before


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    @spans.spanned("twice.backward")
    def backward(ctx, g):
        with spans.span("twice.inner"):
            return 2 * g


def test_nesting_parents_and_self_time(host_events):
    def worker():
        with spans.span("worker"):
            time.sleep(0.002)

    with _recording():
        with spans.span("root"):
            time.sleep(0.002)
            with spans.span("child"):
                time.sleep(0.003)
                with spans.span("grandchild"):
                    time.sleep(0.002)
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=60)
            assert not thread.is_alive()
        x = torch.ones(3, requires_grad=True)
        with spans.span("backward"):
            _Twice.apply(x).sum().backward()
        with spans.span("second"):
            pass
    rec = spans.records()
    names = [r.name for r in rec]
    assert names == ["root", "child", "grandchild", "worker", "backward", "twice.backward", "twice.inner",
                     "second"]
    parents = {r.name: (None if r.parent is None else rec[r.parent].name) for r in rec}
    assert parents == {"root": None, "child": "root", "grandchild": "child", "worker": "root",
                       "backward": None, "twice.backward": "backward", "twice.inner": "twice.backward",
                       "second": None}
    for i, r in enumerate(rec):
        children = [c for c in rec if c.parent == i]
        assert r.self_device_s == pytest.approx(r.device_s - sum(c.device_s for c in children), abs=1e-12)
        assert r.host_s >= 0 and r.device_s >= 0
    assert rec[0].device_s >= 0.009 and rec[0].self_device_s >= 0.002
    assert rec[1].self_device_s >= 0.003 and rec[2].self_device_s >= 0.002
    assert rec[0].host_s >= rec[1].host_s + rec[3].host_s


def test_a_new_recording_clears_the_store():
    with _recording():
        with spans.span("first"):
            pass
    with spans.span("off"):
        pass
    with _recording():
        with spans.span("second"):
            pass
    assert [r.name for r in spans.records()] == ["second"]


@pytest.mark.parametrize("card", [False, True])
def test_the_registry_counts_each_launch_in_the_innermost_span(monkeypatch, request, card):
    made = []
    if card:
        request.getfixturevalue("host_events")

        class _Counted(_HostEvent):
            def __init__(self, enable_timing=False):
                super().__init__(enable_timing)
                made.append(self)

        monkeypatch.setattr(torch.cuda, "Event", _Counted)
    kernel = fused_dia.DIA_MATVEC
    monkeypatch.setattr(kernel, "launches", kernel.launches)
    status = {"value": 0}

    class _Library:
        @staticmethod
        def lat_dia_matvec(*_args):
            return status["value"]

    monkeypatch.setattr(native, "library", lambda _name: _Library)
    before = kernel.launches
    with _recording():
        kernel.launch()
        with spans.span("outer"):
            kernel.launch()
            with spans.span("inner"):
                kernel.launch()
                kernel.launch()
            status["value"] = 700
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                kernel.launch()
            status["value"] = 0
    rec = {r.name: r for r in spans.records()}
    assert {name: r.launches for name, r in rec.items()} == {"outer": {kernel.name: 1}, "inner": {kernel.name: 2}}
    assert kernel.launches - before == 4
    # Event pairs for the two spans where a card is present, none for a launch.
    assert len(made) == (4 if card else 0)


def test_host_times_lie_within_the_profiler_ranges():
    with _recording() as prof:
        for i in range(3):
            with spans.span(f"outer{i}"):
                time.sleep(0.001)
                with spans.span(f"inner{i}"):
                    time.sleep(0.002)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name[len(spans.PREFIX):]: (start_ns + 1e3 * e.time_range.start, start_ns + 1e3 * e.time_range.end)
              for e in prof.events() if e.name.startswith(spans.PREFIX)}
    rec = spans.records()
    assert sorted(ranges) == sorted(r.name for r in rec)
    for r in rec:
        lo, hi = ranges[r.name]
        assert abs(r.start_ns - lo) <= 200e3 and abs(r.end_ns - hi) <= 200e3, (r.name, r.start_ns - lo, hi - r.end_ns)


N_TRAIN, STEPS = 256, 2


def test_gp_train_step_span_tree():
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.standard_normal((N_TRAIN, 8)), dtype=torch.float32)
    y = torch.sin(X[:, 0]) + 0.1 * torch.tensor(rng.standard_normal(N_TRAIN), dtype=torch.float32)
    stack = train_gp.assemble(n_train=N_TRAIN, ndim=8, num_matvecs=5, num_samples=3, rank_precon=32,
                              precon_block=16, matvec=gram.gram_matvec_fused(), device="cpu",
                              sample=lambda probes: probes)
    opt = train_gp.AdamIfFinite(torch.tensor(train_gp.ADJ400K_INIT, dtype=torch.float32).requires_grad_(),
                                lr=0.05)
    gen = torch.Generator().manual_seed(5)
    with _recording():
        for _ in range(STEPS):
            probes = torch.where(torch.rand((3, N_TRAIN), generator=gen) < 0.5, -1.0, 1.0)
            train_gp.train_step(stack, opt, probes, X, y)
    rec = spans.records()

    def tree(i):
        return (rec[i].name, [tree(j) for j, r in enumerate(rec) if r.parent == i])

    roots = [tree(i) for i, r in enumerate(rec) if r.parent is None]
    assert [name for name, _ in roots] == ["gp.loss", "gp.backward", "gp.optimizer"] * STEPS
    loss, backward, optimizer = roots[:3]
    assert loss == ("gp.loss", [("precond.cholesky", []), ("slq.lanczos", []), ("cg.solve", [])])
    assert sorted(backward[1]) == [("cg.solve_adjoint", [("gram.vjp", [])]),
                                   ("slq.adjoint", [("gram.vjp", [])])]
    assert optimizer == ("gp.optimizer", [])
    assert roots[3:] == roots[:3]


def test_fused_lanczos_plain_path_spans_a_vjp():
    n, depth = 256, 6
    dia = sparse.DIAData(offsets=(-1, 0, 1), shape=(n, n), nnz=3 * n, diag_of_entry=np.empty(0),
                         pos_of_entry=np.empty(0))
    gen = torch.Generator().manual_seed(2)
    vals = (torch.rand((3, n), generator=gen) + torch.tensor([[0.0], [4.0], [0.0]])).requires_grad_()
    estimate = fused_lanczos.tridiag_dia_fused(dia, depth)
    with _recording():
        for _ in range(2):
            v0 = torch.randn(n, generator=gen).requires_grad_()
            (xs, (alphas, betas)), (x_res, beta_res) = estimate(v0, vals)
            loss = xs.sum() + alphas.sum() + betas.sum() + x_res.sum() + beta_res
            torch.autograd.grad(loss, [v0, vals])
    rec = spans.records()
    assert [(r.name, r.parent) for r in rec] == [("lanczos.dia_forward", None), ("lanczos.dia_adjoint", None)] * 2
    assert all(r.launches == {} and r.device_s is None for r in rec)
