"""K1's product route on the CPU: its rule, its arithmetic and its counter.

The CUDA kernel (``csrc/gram_matvec.cu``, ``gram_matvec_kernel_mma``)
cannot run here, so its arithmetic is emulated bit by bit in float64 and
held to the plain version, which takes direct differences:

- x and y centred on y's mean, as the wrapper does;
- each operand split into a TF32 ``hi`` and a TF32 ``lo`` (round to
  nearest, ties away: ``cvt.rna.tf32``), y's with -2 folded in;
- ``x . (-2 y)`` from three ``mma.sync`` m16n8k8 TF32 products a k-step
  (``lo hi``, ``hi lo``, ``hi hi``) from 0, each modelled as the card's
  tensor cores measured (``chip_smoke.py``'s tails read what this model
  gives): exact products, every addend cut toward zero to 24 bits below
  the largest one, the sum cut toward zero to float32;
- each norm ``-(z . (-2 z)) / 2`` by the same products, eps added to the
  x norms for the Matern families;
- ``p = (|x|^2 + |y|^2) + x . (-2 y)`` in float32, clamped at 0 (at eps),
  then the family's value.
"""

import pytest
import torch

from lanczos_adjoints_tpu_torch.ops import fused_gram, native

TOL_K1 = 1e-4  # chip_smoke.py's gate of K1 against the plain version


def _tf32_rna(a):
    """float32 rounded to TF32 (10 mantissa bits), ties away from zero."""
    bits = a.to(torch.float32).view(torch.int32).to(torch.int64)
    sign, mag = bits & ~0x7FFFFFFF, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~0x1FFF
    return (sign | mag).to(torch.int32).view(torch.float32)


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_rna(a - hi)


def _f32(a):
    return a.to(torch.float32).to(torch.float64)


def _cut_f32(a):
    """float64 to float32 toward zero."""
    f = a.to(torch.float32)
    over = f.to(torch.float64).abs() > a.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).to(torch.float64)


def _mma(c, a, b):
    """``c + a @ b`` of one m16n8k8 TF32 product: ``a`` (rows, 8), ``b``
    (8, cols) TF32 values, ``c`` (rows, cols) float32 values."""
    terms = torch.cat([c[:, None, :], a[:, :, None] * b[None, :, :]], dim=1)
    top = terms.abs().amax(dim=1, keepdim=True)
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(top > 0, top, 1.0))) - 23)
    return _cut_f32(torch.sum(torch.trunc(terms / quantum) * quantum, dim=1))


def _self_products(z):
    """``z . (-2 z)`` of each row by the same three products, C from 0."""
    hi, lo = (t.to(torch.float64) for t in _split(z))
    bh, bl = -2.0 * hi, -2.0 * lo
    c = torch.zeros(z.shape[0], dtype=torch.float64)
    for k in range(0, z.shape[1], 8):
        cols = slice(k, k + 8)
        for a, b in ((lo, bh), (hi, bl), (hi, bh)):
            c = _mma_rows(c, a[:, cols], b[:, cols])
    return c


def _mma_rows(c, a, b):
    """``c_i + a_i . b_i`` of one product's diagonal: the same model as ``_mma``."""
    terms = torch.cat([c[:, None], a * b], dim=1)
    top = terms.abs().amax(dim=1, keepdim=True)
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(top > 0, top, 1.0))) - 23)
    return _cut_f32(torch.sum(torch.trunc(terms / quantum) * quantum, dim=1))


def product_p(kind, xs, ys, *, centre=True):
    """The pre-scaled squared distances as the product route forms them,
    plus eps for the Matern families, before the clamp. ``centre=False``:
    on rows the wrapper has not centred."""
    if centre:
        shift = ys.mean(dim=0)
        xs, ys = xs - shift, ys - shift
    eps = 0.0 if kind == "rbf" else float(torch.finfo(torch.float32).eps)
    xh, xl = (t.to(torch.float64) for t in _split(xs))
    yh, yl = (t.to(torch.float64).T for t in _split(-2.0 * ys))
    c = torch.zeros((xs.shape[0], ys.shape[0]), dtype=torch.float64)
    for k in range(0, xs.shape[1], 8):
        cols = slice(k, k + 8)
        c = _mma(c, xl[:, cols], yh[cols])
        c = _mma(c, xh[:, cols], yl[cols])
        c = _mma(c, xh[:, cols], yh[cols])
    xn = _f32(-0.5 * _self_products(xs) + eps)
    yn = -0.5 * _self_products(ys)
    return _f32(_f32(xn[:, None] + yn[None, :]) + c)


def product_values(kind, xs, ys, *, centre=True):
    """The Gram values ``g(xs, ys)`` as the product route forms them (the
    clamp at eps: max(p + eps, eps) is max(p, 0) + eps)."""
    eps = 0.0 if kind == "rbf" else float(torch.finfo(torch.float32).eps)
    p = torch.clamp(product_p(kind, xs, ys, centre=centre), min=eps).to(torch.float32)
    if kind == "rbf":
        return torch.exp(-p)
    dist = torch.sqrt(p)
    e = torch.exp(-dist)
    return e if kind == "matern12" else (1.0 + dist) * e


def _tails_rows(width):
    """``chip_smoke.py``'s tails data: columns from distance 0 to 30 along
    one axis, rows at every distance from every column (p = 0 on the
    diagonal) and off the axis by up to 3, zero-padded to ``width``."""
    n_cols = 16
    y = torch.zeros((n_cols, width))
    y[:, 0] = torch.linspace(0.0, 30.0, n_cols)
    x = y.repeat(4, 1)
    x[n_cols:, 1] = torch.linspace(1e-4, 3.0, 3 * n_cols)
    return x, y


def _entrywise(got, want):
    live = want > 1e-30
    return float(((got - want).abs()[live] / want[live]).max())


@pytest.mark.parametrize(("kind", "width", "route"), [
    ("matern32", 8, "product"), ("matern32", 16, "product"), ("rbf", 8, "product"), ("rbf", 16, "product"),
    ("matern12", 8, "direct"), ("matern12", 16, "direct"),
    ("matern32", 32, "direct"), ("rbf", 64, "direct"), ("matern32", 128, "direct"), ("matern12", 192, "direct"),
])
def test_route_rule(kind, width, route):
    """matern32 and rbf at width 8 and 16 take the product; matern12, and
    every width of 32 and more, take direct differences."""
    assert fused_gram.k1_route(kind, width) == route


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("kind", ["matern32", "rbf"])
def test_product_arithmetic_holds_the_tails_gate(kind, width):
    """On the tails data, entry by entry against ``gram_matvec_plain`` (v =
    the identity), as ``chip_smoke.py`` holds the kernel: inside TOL_K1 once
    the rows are centred; matern32 misses it on the rows as given."""
    x, y = _tails_rows(width)
    xs, ys = (fused_gram.kernel_rows(a, torch.tensor(1.0), kind) for a in (x, y))
    want = fused_gram.gram_matvec_plain(kind, xs, ys, torch.eye(ys.shape[0]))
    assert _entrywise(product_values(kind, xs, ys), want) <= TOL_K1 / 2
    if kind == "matern32":
        assert _entrywise(product_values(kind, xs, ys, centre=False), want) > TOL_K1


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("kind", ["matern32", "rbf"])
def test_equal_rows_cancel_exactly(kind, width):
    """Where a row equals a column, p is exactly 0 (plus eps), as in the
    plain version: the norms come from the distance product itself, so
    the three terms cancel whatever the tensor cores' rounding."""
    g = torch.Generator().manual_seed(4)
    ell = 0.3 + torch.rand(width, generator=g)
    x = fused_gram.kernel_rows(3.0 * torch.randn((48, width), generator=g), ell, kind)
    eps = 0.0 if kind == "rbf" else float(torch.finfo(torch.float32).eps)
    p = product_p(kind, x, x)
    assert float(p.diagonal().abs().max()) <= eps  # 0, or eps where the norms are small
    assert torch.equal(torch.clamp(p.diagonal(), min=eps), torch.full((48,), eps, dtype=torch.float64))
    assert float(p.abs().max()) > 1e3  # large norms: the rounding they would bring is real


def _near_pairs(width, offset, seed=0):
    """16 normal columns, and rows ``offset`` from each (0: equal to it)."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((16, width), generator=g)
    return y + offset * torch.randn((16, width), generator=g), y


@pytest.mark.parametrize("width", [8, 16])
def test_matern12_misses_the_gate_near_distance_zero(width):
    """The same arithmetic at pairs ~1e-3 apart: matern32 and rbf stay
    inside TOL_K1, matern12 (slope 1 / (2 sqrt(eps)) at distance 0) is over
    it, which is why it keeps direct differences."""
    x, y = _near_pairs(width, 1e-3)
    errors = {}
    for kind in ("matern12", "matern32", "rbf"):
        xs, ys = (fused_gram.kernel_rows(a, torch.tensor(1.0), kind) for a in (x, y))
        want = fused_gram.gram_matvec_plain(kind, xs, ys, torch.eye(ys.shape[0]))
        errors[kind] = _entrywise(product_values(kind, xs, ys), want)
    assert errors["matern32"] <= TOL_K1 and errors["rbf"] <= TOL_K1
    assert errors["matern12"] > TOL_K1


@pytest.mark.parametrize("m", [1, 15])
def test_product_arithmetic_matches_plain_matvec(m):
    """K1's use at parity-like data (normal rows, ARD lengthscales 0.5-2,
    d = 8): the emulated values times v against ``gram_matvec_plain``,
    max error over max |plain|, as ``chip_smoke.py``'s [parity]."""
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn((96, 8), generator=g), torch.randn((80, 8), generator=g)
    ell = 0.5 + 1.5 * torch.rand(8, generator=g)
    v = torch.randn((80, m), generator=g)
    xs, ys = (fused_gram.kernel_rows(a, ell, "matern32") for a in (x, y))
    want = fused_gram.gram_matvec_plain("matern32", xs, ys, v)
    got = product_values("matern32", xs, ys).double() @ v.double()
    assert float((got - want).abs().max() / want.abs().max()) <= TOL_K1


class _Library:
    """A stand-in for the built ``gram_matvec`` library: records the route
    each launch asked for and returns ``status``."""

    def __init__(self, status=0):
        self.status, self.routes = status, []

    def lat_gram_matvec(self, kind, route, *_args):
        self.routes.append(route)
        return self.status


def test_route_counts_add_up_to_the_registry(monkeypatch):
    """Each accepted K1 launch counts once in the registry and once under
    its route; a launch the C entry refuses counts in neither."""
    lib = _Library()
    monkeypatch.setattr(native, "library", lambda _name: lib)
    native.reset_launches()
    cases = [("matern32", 8), ("matern32", 16), ("rbf", 8), ("matern12", 8), ("matern32", 64), ("rbf", 128)]
    for kind, width in cases:
        route = fused_gram.k1_route(kind, width)
        fused_gram.GRAM_MATVEC.launch(fused_gram._KIND_ID[kind], fused_gram.K1_ROUTES.index(route),
                                      *[0] * 12, route=route)
    counts = fused_gram.k1_route_counts()
    assert counts == {"direct": 3, "product": 3}
    assert sum(counts.values()) == native.launch_counts()["gram_matvec"] == len(cases)
    assert lib.routes == [1, 1, 1, 0, 0, 0]
    lib.status = 1
    with pytest.raises(RuntimeError):
        fused_gram.GRAM_MATVEC.launch(0, 1, *[0] * 12, route="product")
    assert fused_gram.k1_route_counts() == counts and native.launch_counts()["gram_matvec"] == len(cases)
    native.reset_launches()
    assert fused_gram.k1_route_counts() == {"direct": 0, "product": 0}
