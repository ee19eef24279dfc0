"""Each mix at a CPU size through the port's CPU path against its frozen
reference; each fault the cells can have, planted under the timed path,
turns ``correct`` false; each control fails its cell's numbers."""

import math

import pytest
import torch

from portbench.reference import gp_train_step as gp_ref
from portbench.reference import lanczos_vjp as vjp_ref
from portbench.tests import tiny


@pytest.mark.parametrize("name", [tiny.GP, tiny.VJP])
def test_mix_agrees_with_its_reference(name):
    result, lines = tiny.run(tiny.cell(name))
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(math.isfinite(v["value"]) for v in result["checks"].values())


def _unchanged_state(monkeypatch):
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    def step(self):
        self.adam.zero_grad()
        return True

    monkeypatch.setattr(train_gp.AdamIfFinite, "step", step)


def _half_the_probes(monkeypatch):
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    assemble = train_gp.assemble

    def halved(**kwargs):
        kwargs["sample"] = lambda probes: probes[: len(probes) // 2]
        return assemble(**kwargs)

    monkeypatch.setattr(train_gp, "assemble", halved)


def _altered_answer(monkeypatch):
    from lanczos_adjoints_tpu_torch.krylov import lanczos

    tridiag = lanczos.tridiag

    def altered(*args, **kwargs):
        estimate = tridiag(*args, **kwargs)

        def wrong(v0, vals):
            (xs, (alphas, betas)), rest = estimate(v0, vals)
            return (xs, (alphas * (1 + 1e-2), betas)), rest

        return wrong

    monkeypatch.setattr(lanczos, "tridiag", altered)


@pytest.mark.parametrize(("name", "fault"), [
    (tiny.GP, _unchanged_state),
    (tiny.GP, _half_the_probes),
    (tiny.VJP, _altered_answer),
])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result, lines = tiny.run(tiny.cell(name))
    assert not result["correct"], lines


def test_gp_control_fails():
    """The reference in TF32 in the program's place, against the reference."""
    spec = tiny.cell(tiny.GP)
    c, t = spec.config, spec.traffic
    X, y, params0, probes = _gp_inputs(c)
    ref = gp_ref.follow(X, y, params0, probes, c, tile=t["reference_tile"])
    ctl = gp_ref.follow(X, y, params0, probes, c, precision="tf32", tile=t["reference_tile"])
    numbers, _left_out = gp_ref.numbers_against(ctl, ref, params0, c["ndim"])
    assert any(numbers[k] > limit for k, limit in spec.limits.items() if k in numbers), numbers


def test_vjp_control_fails():
    """The reference in bfloat16 in the program's place, against the reference in float64."""
    spec = tiny.cell(tiny.VJP)
    c = spec.config
    offsets, vals = vjp_ref.operator(c, "cpu")
    gen = torch.Generator().manual_seed(5)
    n, k = c["grid"] ** 2, c["depth"]
    v0 = torch.randn(n, generator=gen)
    cot = [torch.randn(k, n, generator=gen), torch.randn(k, generator=gen), torch.randn(k - 1, generator=gen),
           torch.randn(n, generator=gen), torch.randn((), generator=gen)]
    ref = vjp_ref.vjp(offsets, vals, v0, cot, k, torch.float64)
    ctl = vjp_ref.vjp(offsets, vals, v0, cot, k, torch.bfloat16)
    numbers = vjp_ref.gaps(*ctl, *ref)
    assert any(numbers[name] > limit for name, limit in spec.limits.items()), numbers


def _gp_inputs(c, seed=7):
    from portbench.yardstick import data

    X, y = data.synthetic_gp(seed, num_data=c["num_data"], ndim=c["ndim"], train_fraction=c["train_fraction"])
    gen = torch.Generator().manual_seed(seed)
    probes = [data.rademacher(gen, (c["num_samples"], c["n_train"]), device="cpu") for _ in range(2)]
    return torch.tensor(X), torch.tensor(y), torch.tensor(c["init_params"]), probes


def test_gp_reference_parameter_pass_takes_the_squared_differences_exactly():
    """``Gram.param_grads`` (tiles, one float64 product a tile) against the
    direct double sum over every pair, in float64."""
    gen = torch.Generator().manual_seed(3)
    n, d, pairs = 300, 4, 3
    X = torch.randn(n, d, generator=gen)
    ell, s = torch.rand(d, generator=gen) + 0.5, torch.tensor(1.3)
    gram = gp_ref.Gram(X, tile=70, prec=gp_ref.Precision("float32"))
    gram.set_params(ell, s)
    U, W = torch.randn(n, pairs, generator=gen), torch.randn(n, pairs, generator=gen)
    gram.pairs = [(U, W)]
    g_ell, g_s = gram.param_grads()

    x, l64 = X.double(), ell.double()
    diff = x[:, None, :] - x[None, :, :]
    dist = torch.sqrt(((math.sqrt(3.0) * diff / l64) ** 2).sum(-1) + gp_ref.EPS32)
    e = torch.exp(-dist)
    M = U.double() @ W.double().T
    want_s = (M * (1 + dist) * e).sum()
    want_ell = 3.0 * float(s) * torch.einsum("ij,ijc->c", M * e, diff**2) / l64**3
    assert abs(float(g_s) - float(want_s)) <= 1e-5 * abs(float(want_s))
    assert torch.allclose(g_ell.double(), want_ell, rtol=1e-5, atol=0)
