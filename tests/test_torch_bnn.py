"""The port's BNN / GGN / linearised-Laplace modules against the JAX package's, on the CPU.

The same numpy inputs, and JAX's own probes and draws, go to
``lanczos_adjoints_tpu.models.bnn`` / ``bnn_baselines`` and their
counterparts in ``lanczos_adjoints_tpu_torch``, at the JAX tests' MLP (8
points, 3 inputs, 2 classes, hidden (50, 50, 5, 5): 3,047 parameters) or,
where a Jacobian is materialised, a narrower one. Algorithmic parity is checked in float64 under a scoped
``jax.enable_x64(True)`` at rtol 1e-9; float32 paths at the JAX tests'
own tolerances (1e-4 between GGN variants, 1e-3 against the materialised
GGN, ``tests/test_models/test_bnn.py``).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lanczos_adjoints_tpu.models import bnn as jbnn  # noqa: E402
from lanczos_adjoints_tpu.models import bnn_baselines as jbase  # noqa: E402
from lanczos_adjoints_tpu.solvers import cg as jcg  # noqa: E402
from lanczos_adjoints_tpu_torch.models import bnn, bnn_baselines  # noqa: E402
from lanczos_adjoints_tpu_torch.models._flat import ravel  # noqa: E402
from lanczos_adjoints_tpu_torch.solvers import cg  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

RTOL64 = 1e-9


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rtol, atol=0.0):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


class _Net:
    """One MLP on both sides: JAX's flax init, carried across by ``params_from_jax``."""

    def __init__(self, dtype, num, dim, classes, hidden, seed):
        rng = np.random.default_rng(seed)
        self.np_dtype = np.float64 if dtype == "float64" else np.float32
        self.x_np = rng.standard_normal((num, dim)).astype(self.np_dtype)
        self.y_np = np.eye(classes, dtype=self.np_dtype)[np.arange(num) % classes]
        init_j, self.apply_j = jbnn.model_mlp(out_dims=classes, activation=jnp.tanh, hidden=hidden)
        variables = init_j(jax.random.PRNGKey(1), jnp.asarray(self.x_np, jnp.float32))
        self.variables = jax.tree_util.tree_map(lambda a: np.asarray(a, self.np_dtype), variables)
        self.p_j, self.unflat_j, _ = jbnn.vectorize_nn(self.apply_j, self.jx(self.variables))
        init_t, self.apply = bnn.model_mlp(out_dims=classes, activation=torch.tanh, hidden=hidden)
        self.x, self.y = torch.tensor(self.x_np), torch.tensor(self.y_np)
        _, self.unflat, _ = bnn.vectorize_nn(self.apply, init_t(torch.Generator().manual_seed(0), self.x))
        self.p = bnn.params_from_jax(self.variables, device="cpu")

    def jx(self, a):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t), a)

    def kwargs_j(self, loss=jbnn.loss_training_cross_entropy_single):
        return {"loss_single": loss, "model_fun": self.apply_j, "param_unflatten": self.unflat_j}

    def kwargs(self, loss=bnn.loss_training_cross_entropy_single):
        return {"loss_single": loss, "model_fun": self.apply, "param_unflatten": self.unflat}


@functools.lru_cache(maxsize=None)
def _net(dtype, num, dim, classes, hidden, seed):
    with jax.enable_x64(dtype == "float64"):
        return _Net(dtype, num, dim, classes, hidden, seed)


def Net(dtype, *, num=8, dim=3, classes=2, hidden=(50, 50, 5, 5), seed=0):  # noqa: N802
    """The MLP of these arguments, built once a module."""
    return _net(dtype, num, dim, classes, tuple(hidden), seed)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture
def net64(x64):
    """A narrower MLP (357 parameters) for the operators that materialise Jacobians."""
    return Net("float64", hidden=(20, 10, 5))


@pytest.fixture
def wide64(x64):
    """The JAX tests' MLP (3,047 parameters)."""
    return Net("float64")


def _squared_error_single(preds, y):
    return torch.sum((preds - y) ** 2)


def _squared_error_single_j(preds, y):
    return jnp.sum((preds - y) ** 2)


# ---------------------------------------------------------------------------
# Model and layout
# ---------------------------------------------------------------------------


def test_flat_layout_is_flax_ravel_order():
    net = Net("float32")
    p_j = np.asarray(net.p_j)
    np.testing.assert_array_equal(net.p.numpy(), p_j)
    dense = net.variables["params"]
    # Dense_0's bias comes first, then its (in, out) kernel row-major.
    np.testing.assert_array_equal(p_j[:50], dense["Dense_0"]["bias"])
    np.testing.assert_array_equal(p_j[50:200], dense["Dense_0"]["kernel"].ravel())
    # The port's dict of the same weights flattens to the same vector.
    params = {f"layers.{i}.{leaf}": torch.tensor(dense[f"Dense_{i}"][src].T if leaf == "weight"
                                                  else dense[f"Dense_{i}"][src])
              for i in range(5) for leaf, src in (("weight", "kernel"), ("bias", "bias"))}
    flat, unflatten = bnn.vectorize_nn(net.apply, params)[:2]
    np.testing.assert_array_equal(flat.numpy(), p_j)
    for name, t in unflatten(flat).items():
        np.testing.assert_array_equal(t.numpy(), params[name].numpy())
    _close(net.apply(net.unflat(net.p), net.x), net.apply_j(net.unflat_j(net.p_j), net.jx(net.x_np)), 1e-5, 1e-6)
    assert bnn.params_from_jax(p_j, device="cpu").shape == (3047,)


def test_flat_layout_sorts_as_flax_paths():
    """``Dense_10`` sorts before ``Dense_2``, in flax's paths and in the port's layout."""
    names = [f"layers.{i}.{leaf}" for i in range(12) for leaf in ("weight", "bias")]
    params = {name: torch.full((2, 2) if name.endswith("weight") else (2,), float(i))
              for i, name in enumerate(names)}
    flat, _ = ravel(params)
    tree = {f"Dense_{i}": {"bias": np.full(2, 2.0 * i + 1), "kernel": np.full((2, 2), 2.0 * i)}
            for i in range(12)}
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax.flatten_util.ravel_pytree(tree)[0]))


@pytest.mark.parametrize(("hidden", "dim", "classes", "count"),
                         [((50, 50, 5, 5), 16, 4, 3709), ((2048, 1536), 256, 10, 3_688_970)])
def test_init_is_flax_lecun_normal(hidden, dim, classes, count):
    init, apply = bnn.model_mlp(out_dims=classes, activation=torch.tanh, hidden=hidden)
    x = torch.zeros((2, dim))
    params = init(torch.Generator().manual_seed(1), x)
    flat, _unflatten, _ = bnn.vectorize_nn(apply, params)
    assert flat.shape == (count,)
    widths = [dim, *hidden, classes]
    for i, fan_in in enumerate(widths[:-1]):
        kernel = params[f"layers.{i}.weight"]
        std = (1.0 / fan_in) ** 0.5
        assert kernel.shape == (widths[i + 1], fan_in)
        assert float(kernel.abs().max()) <= 2.0 * std / bnn.TRUNCATED_NORMAL_STDDEV
        if kernel.numel() > 10_000:
            assert abs(float(kernel.std()) / std - 1.0) < 0.02
        assert not params[f"layers.{i}.bias"].any()
    assert apply(params, x).shape == (2, classes)


# ---------------------------------------------------------------------------
# Metrics and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_metrics_match_jax(dtype):
    rng = np.random.default_rng(3)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    logits = rng.standard_normal((40, 5)).astype(np_dtype) * 3
    labels = np.eye(5, dtype=np_dtype)[rng.integers(0, 5, 40)]

    def jax_side(lj, yj):
        probs_j = jax.nn.softmax(lj, axis=-1)
        eces = [jbnn.metric_ece(probs=probs_j, labels_hot=yj, num_bins=bins) for bins in (5, 10, 15)]
        return probs_j, {
            "accuracy": jbnn.metric_accuracy(probs=probs_j, labels_hot=yj),
            "nll_sum": jbnn.metric_nll(logits=lj, labels_hot=yj),
            "nll_mean": jbnn.metric_nll(logits=lj, labels_hot=yj, sum_or_mean_fun=jnp.mean),
            "confidence": jbnn.metric_confidence(probs=probs_j),
            "ece": jnp.stack([jnp.stack(e) for e in eces]),
            "ce": jbnn.loss_training_cross_entropy(lj, yj),
            "ce_single": jbnn.loss_training_cross_entropy_single(lj, yj),
        }

    with jax.enable_x64(dtype == "float64"):
        probs_j, want = jax.jit(jax_side)(jnp.asarray(logits), jnp.asarray(labels))
    probs = torch.tensor(np.asarray(probs_j))
    lt, yt = torch.tensor(logits), torch.tensor(labels)
    got = {
        "accuracy": bnn.metric_accuracy(probs=probs, labels_hot=yt),
        "nll_sum": bnn.metric_nll(logits=lt, labels_hot=yt),
        "nll_mean": bnn.metric_nll(logits=lt, labels_hot=yt, sum_or_mean_fun=torch.mean),
        "confidence": bnn.metric_confidence(probs=probs),
        "ece": torch.stack([torch.stack(bnn.metric_ece(probs=probs, labels_hot=yt, num_bins=bins))
                            for bins in (5, 10, 15)]),
        "ce": bnn.loss_training_cross_entropy(lt, yt),
        "ce_single": bnn.loss_training_cross_entropy_single(lt, yt),
    }
    rtol = RTOL64 if dtype == "float64" else 1e-5
    for name, value in got.items():
        _close(value, want[name], 1e-7 if name == "accuracy" else rtol, 1e-7 if name == "ece" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num_bins", [7, 10])
def test_ece_on_bin_edges_and_at_one(dtype, num_bins):
    """Confidences exactly on JAX's bin edges, at 1.0 and just below: the same bins."""
    np_dtype = np.float64 if dtype == "float64" else np.float32
    with jax.enable_x64(dtype == "float64"):
        edges = np.asarray(jax.jit(lambda z: jnp.histogram(z, bins=num_bins, range=(0, 1))[1])(
            jnp.zeros(3, np_dtype)))
        np.testing.assert_array_equal(bnn._bin_edges(num_bins, torch.float64 if dtype == "float64"
                                                      else torch.float32, "cpu").numpy(), edges)
        confs = np.concatenate([edges[1:], np.nextafter(edges[1:], 0), [1.0, 0.55]]).astype(np_dtype)
        confs = np.clip(confs, 0.5, 1.0)  # the top-class probability of two classes
        probs = np.stack([confs, 1 - confs], axis=1).astype(np_dtype)
        labels = np.eye(2, dtype=np_dtype)[np.arange(len(confs)) % 2]
        got = bnn.metric_ece(probs=torch.tensor(probs), labels_hot=torch.tensor(labels), num_bins=num_bins)
        want = jax.jit(lambda p, lab: jbnn.metric_ece(probs=p, labels_hot=lab, num_bins=num_bins))(
            jnp.asarray(probs), jnp.asarray(labels))
        # The same bins on both sides; the sums over them may round differently.
        for a, b in zip(got, want):
            _close(a, b, 1e-12 if dtype == "float64" else 1e-6)


def test_calibration_helper_losses_match_jax(net64):
    net = net64
    ggn_j = jbnn.ggn_full(**net.kwargs_j())
    ggn_t = bnn.ggn_full(**net.kwargs())
    for make_j, make_t in ((jbnn.loss_calibration, bnn.loss_calibration),
                           (jbnn.loss_log_prob_like_in_redux, bnn.loss_log_prob_like_in_redux)):
        loss_j = make_j(ggn_fun=ggn_j, hyperparam_unconstrain=jnp.exp, logdet_fun=jbnn.solver_logdet_dense())
        loss_t = make_t(ggn_fun=ggn_t, hyperparam_unconstrain=torch.exp, logdet_fun=bnn.solver_logdet_dense())
        value_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(0.3), net.p_j, net.jx(net.x_np),
                                                             net.jx(net.y_np))
        a = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
        value = loss_t(a, net.p, net.x, net.y)
        value.backward()
        _close(value, value_j, RTOL64)
        _close(a.grad, grad_j, 1e-8)


# ---------------------------------------------------------------------------
# GGN operators
# ---------------------------------------------------------------------------


def test_ggn_operators_match_jax(net64):
    net = net64
    v_np = np.random.default_rng(2).standard_normal(net.p.shape[0])
    xj, yj, v = net.jx(net.x_np), net.jx(net.y_np), torch.tensor(v_np)
    want = np.asarray(jax.jit(jbnn.ggn_vp(**net.kwargs_j()))(jnp.asarray(v_np), net.p_j, xj, yj))
    _close(bnn.ggn_vp(**net.kwargs())(v, net.p, net.x, net.y), want, RTOL64, 1e-14)
    assert bnn.ggn_vp_parallel is bnn.ggn_vp
    for chunk in (1, 3):
        got = bnn.ggn_vp_running(**net.kwargs(), chunk_size=chunk)(v, net.p, net.x, net.y)
        _close(got, jax.jit(jbnn.ggn_vp_running(**net.kwargs_j(), chunk_size=chunk))(jnp.asarray(v_np), net.p_j, xj, yj),
               RTOL64, 1e-14)
    full = bnn.ggn_full(**net.kwargs())(0.7, net.p, net.x, net.y)
    full_j = np.asarray(jax.jit(jbnn.ggn_full(**net.kwargs_j()))(0.7, net.p_j, xj, yj))
    _close(full, full_j, RTOL64, 1e-14)
    _close(full @ v - 0.7 * v, want, 1e-8, 1e-13)
    _close(bnn.ggn_diag(**net.kwargs())(0.7, net.p, net.x, net.y), np.diag(np.diag(full_j)), RTOL64, 1e-14)
    cov = bnn.predictive_cov(ggn_fun=bnn.ggn_full(**net.kwargs()), model_fun=net.apply, param_unflatten=net.unflat,
                             hyperparam_unconstrain=torch.exp)(torch.tensor(0.1, dtype=torch.float64),
                                                               net.p, net.x, net.y, net.x[:3])
    cov_j = jax.jit(jbnn.predictive_cov(ggn_fun=jbnn.ggn_full(**net.kwargs_j()), model_fun=net.apply_j,
                                        param_unflatten=net.unflat_j, hyperparam_unconstrain=jnp.exp))(
        jnp.asarray(0.1), net.p_j, xj, yj, xj[:3])
    _close(cov, cov_j, 1e-8, 1e-12)


def test_ggn_variants_agree_in_float32():
    """The JAX test's own float32 check: running vs batched 1e-4, the materialised GGN 1e-3."""
    net = Net("float32")
    v = torch.tensor(np.random.default_rng(2).standard_normal(net.p.shape[0]).astype(np.float32))
    par = bnn.ggn_vp_parallel(**net.kwargs())(v, net.p, net.x, net.y)
    run = bnn.ggn_vp_running(**net.kwargs())(v, net.p, net.x, net.y)
    assert torch.allclose(par, run, atol=1e-4, rtol=1e-4)
    ggn = bnn.ggn_full(**net.kwargs())(0.0, net.p, net.x, net.y)
    assert torch.allclose(ggn @ v, par, atol=1e-3, rtol=1e-3)
    want = jbnn.ggn_vp(**net.kwargs_j())(net.jx(v.numpy()), net.p_j, net.jx(net.x_np), net.jx(net.y_np))
    _close(par, want, 1e-4, 1e-5)


def test_loss_hessian_closed_form_is_torch_func_hessian(net64):
    preds = net64.apply(net64.unflat(net64.p), net64.x)
    closed = bnn._loss_hessians(bnn.loss_training_cross_entropy_single, preds, net64.y)
    by_ad = torch.func.vmap(torch.func.hessian(bnn.loss_training_cross_entropy_single))(preds, net64.y)
    _close(closed, by_ad.detach(), RTOL64, 1e-15)
    _close(bnn._loss_hessians(_squared_error_single, preds, net64.y), 2 * np.eye(2)[None].repeat(8, 0), 0)


def test_kernel_vp_matches_jax_on_squared_error(net64):
    net = net64
    rng = np.random.default_rng(4)
    v_outs, v_one = rng.standard_normal((8, 2)), rng.standard_normal(2)
    xj, yj = net.jx(net.x_np), net.jx(net.y_np)
    kv = bnn.kernel_vp(**net.kwargs(_squared_error_single))(torch.tensor(v_outs), net.p, net.x, net.y)
    kv_j = jax.jit(jbnn.kernel_vp(**net.kwargs_j(_squared_error_single_j)))(jnp.asarray(v_outs), net.p_j, xj, yj)
    _close(kv, kv_j, RTOL64, 1e-13)
    kp = bnn.kernel_vp_parallel(**net.kwargs(_squared_error_single))(torch.tensor(v_one), net.p, net.x, net.y)
    kp_j = jax.jit(jbnn.kernel_vp_parallel(**net.kwargs_j(_squared_error_single_j)))(jnp.asarray(v_one), net.p_j,
                                                                                   xj, yj)
    _close(kp, kp_j, RTOL64, 1e-13)


def test_kernel_vp_cross_entropy_is_nan_on_both_sides():
    """The float32 cross-entropy Hessian is singular: its Cholesky factor is NaN in JAX,
    and the port returns NaN where ``torch.linalg.cholesky`` would raise."""
    net = Net("float32")
    xj, yj = net.jx(net.x_np), net.jx(net.y_np)
    v_outs, v_one = np.ones((8, 2), np.float32), np.ones(2, np.float32)
    for make, make_j, v in ((bnn.kernel_vp, jbnn.kernel_vp, v_outs), (bnn.kernel_vp_parallel,
                                                                      jbnn.kernel_vp_parallel, v_one)):
        got = make(**net.kwargs())(torch.tensor(v), net.p, net.x, net.y)
        want = jax.jit(make_j(**net.kwargs_j()))(jnp.asarray(v), net.p_j, xj, yj)
        assert not np.isfinite(np.asarray(want)).any()
        assert not torch.isfinite(got).any()


def test_ggn_vp_dataloader_matches_the_batched_operator(net64):
    net = net64
    loader = [{"image": net.x_np[i:i + 3], "label": net.y_np[i:i + 3]} for i in range(0, 8, 3)]
    v = torch.tensor(np.random.default_rng(5).standard_normal(net.p.shape[0]))
    for sum_type in ("parallel", "running"):
        streamed = bnn.ggn_vp_dataloader(net.p, bnn.loss_training_cross_entropy_single, net.apply, net.unflat,
                                         loader, sum_type=sum_type)(v)
        _close(streamed, bnn.ggn_vp(**net.kwargs())(v, net.p, net.x, net.y), 1e-10, 1e-14)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def test_exact_and_last_layer_ggn_match_jax(net64):
    net = net64
    xj, yj = net.jx(net.x_np), net.jx(net.y_np)
    diag = bnn_baselines.exact_diagonal(net.apply, net.unflat(net.p), 2, net.x)
    diag_j = jax.jit(lambda p, x: jbase.exact_diagonal(net.apply_j, net.unflat_j(p), 2, x))(net.p_j, xj)
    _close(ravel(diag)[0], jax.flatten_util.ravel_pytree(diag_j)[0], RTOL64, 1e-15)
    reg = bnn_baselines.exact_diagonal(net.apply, net.unflat(net.p), 2, net.x[:3], likelihood="regression")
    reg_j = jax.jit(lambda p, x: jbase.exact_diagonal(net.apply_j, net.unflat_j(p), 2, x, likelihood="regression"))(
        net.p_j, xj[:3])
    _close(ravel(reg)[0], jax.flatten_util.ravel_pytree(reg_j)[0], RTOL64, 1e-15)
    full = bnn.ggn_full(**net.kwargs())(0.0, net.p, net.x, net.y)
    _close(ravel(diag)[0], torch.diag(full), 1e-9, 1e-15)
    # JAX keys the last layer by the flax name: hand it the module dict itself.
    for likelihood in ("classification", "regression"):
        ggn, idx = bnn_baselines.last_layer_ggn(net.apply, net.unflat(net.p), net.x, likelihood=likelihood)
        ggn_j, idx_j = jbase.last_layer_ggn(
            jax.jit(lambda p, x: net.apply_j({"params": p}, x)), net.unflat_j(net.p_j)["params"], xj,
            likelihood=likelihood)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j) + 0)
        _close(ggn, ggn_j, RTOL64, 1e-15)
    assert idx.tolist() == list(range(net.p.shape[0] - 12, net.p.shape[0]))  # Dense_3: 5 x 2 + 2
    with pytest.raises(ValueError, match="unsupported"):
        bnn_baselines.last_layer_ggn(net.apply, net.unflat(net.p), net.x, likelihood="poisson")


def _jax_level_probes(key, levels, samples, n, dtype):
    return np.stack([np.stack([np.asarray(jax.random.rademacher(k, (n,), dtype=dtype))
                               for k in jax.random.split(level, samples)])
                     for level in jax.random.split(key, levels)])


@pytest.mark.parametrize("computation_type", ["serial", "parallel"])
def test_hutchinson_diagonal_matches_jax(net64, computation_type):
    net = net64
    xj, yj = net.jx(net.x_np), net.jx(net.y_np)
    gvp_j = jbnn.ggn_vp(**net.kwargs_j())
    gvp = bnn.ggn_vp(**net.kwargs())
    key = jax.random.PRNGKey(7)
    diag_j = jax.jit(lambda k: jbase.hutchinson_diagonal(lambda v: gvp_j(v, net.p_j, xj, yj), net.unflat_j(net.p_j),
                                                         6, k, num_levels=2, computation_type=computation_type))(key)
    probes = torch.tensor(_jax_level_probes(key, 2, 6, net.p.shape[0], jnp.float64))
    diag = bnn_baselines.hutchinson_diagonal(lambda v: gvp(v, net.p, net.x, net.y), net.unflat(net.p), 6, probes,
                                             num_levels=2, computation_type=computation_type)
    _close(ravel(diag)[0], jax.flatten_util.ravel_pytree(diag_j)[0], RTOL64, 1e-15)
    with pytest.raises(ValueError, match="unsupported"):
        bnn_baselines.hutchinson_diagonal(lambda v: v, net.p, 2, probes[:, :2], num_levels=2,
                                          computation_type="junk")


def test_tree_random_like_draws_from_the_generator():
    tree = {"layers.0.weight": torch.zeros(3, 2), "layers.0.bias": torch.zeros(3)}
    a = bnn_baselines.tree_random_normal_like(torch.Generator().manual_seed(3), tree)
    b = bnn_baselines.tree_random_normal_like(torch.Generator().manual_seed(3), tree)
    assert all(torch.equal(a[k], b[k]) and a[k].shape == tree[k].shape for k in tree)
    signs = bnn_baselines.tree_random_rademacher_like(torch.Generator().manual_seed(3), tree)
    assert set(torch.cat([t.reshape(-1) for t in signs.values()]).tolist()) <= {-1.0, 1.0}
    given = torch.arange(9.0)
    assert torch.equal(ravel(bnn_baselines.tree_random_normal_like(given, tree))[0], given)


# ---------------------------------------------------------------------------
# Logdet solvers and calibration losses
# ---------------------------------------------------------------------------


def _jax_probes(key, num_batches, per_batch, n, dtype):
    keys = [key] if num_batches == 1 else list(jax.random.split(key, num_batches))
    return np.concatenate([np.asarray(jax.random.rademacher(k, (per_batch, n), dtype=dtype)) for k in keys])


@pytest.mark.parametrize("num_batches", [1, 2])
def test_logdet_solvers_match_jax(x64, num_batches):
    rng = np.random.default_rng(8)
    W = rng.standard_normal((12, 12))
    M = W @ W.T / 12 + np.eye(12)
    key = jax.random.PRNGKey(1)
    want = jax.jit(jbnn.solver_logdet_slq(lanczos_rank=6, slq_num_samples=4, slq_num_batches=num_batches))(
        jnp.asarray(M), key)
    Mt = torch.tensor(M, requires_grad=True)
    probes = torch.tensor(_jax_probes(key, num_batches, 4 // num_batches, 12, jnp.float64))
    got = bnn.solver_logdet_slq(lanczos_rank=6, slq_num_samples=4, slq_num_batches=num_batches)(Mt, probes)
    _close(got, want, RTOL64)
    got.backward()
    grad_j = jax.jit(jax.grad(lambda m: jbnn.solver_logdet_slq(lanczos_rank=6, slq_num_samples=4,
                                                               slq_num_batches=num_batches)(m, key)))(jnp.asarray(M))
    _close(Mt.grad, grad_j, 1e-8, 1e-12)
    _close(bnn.solver_logdet_dense()(torch.tensor(M)), jbnn.solver_logdet_dense()(jnp.asarray(M)), RTOL64)
    # The clipped-mass diagnostic on a matrix with a null space.
    A = np.diag(np.r_[np.zeros(3), np.linspace(1.0, 2.0, 9)])
    mass_j = jax.jit(lambda k, a: jbnn.solver_clipped_mass_slq(
        lanczos_rank=12, slq_num_samples=4, slq_num_batches=num_batches, N=12)(lambda v, a: a @ v, k, a))(
        key, jnp.asarray(A))
    mass = bnn.solver_clipped_mass_slq(lanczos_rank=12, slq_num_samples=4, slq_num_batches=num_batches, N=12)(
        lambda v, a: a @ v, probes, torch.tensor(A))
    _close(mass, mass_j, RTOL64, 1e-12)


def test_split_batches_divides_and_warns_once(monkeypatch):
    monkeypatch.setattr(bnn, "_WARNED_BATCH_SEMANTICS", False)
    with pytest.raises(ValueError, match="divisible"):
        bnn._split_batches(10, 3)
    with pytest.warns(UserWarning, match="DIVIDES"):
        assert bnn._split_batches(8, 2) == 4
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert bnn._split_batches(8, 2) == 4


@pytest.mark.parametrize("num_batches", [1, 2])
def test_calibration_loss_and_gradient_match_jax(wide64, num_batches):
    net = wide64
    n, key = net.p.shape[0], jax.random.PRNGKey(3)
    loss_j = jbnn.callibration_loss(net.apply_j, net.unflat_j, jnp.exp, n, lanczos_rank=8, slq_num_samples=4,
                                    slq_num_batches=num_batches)
    value_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(0.3), net.p_j, net.jx(net.x_np),
                                                          net.jx(net.y_np), key)
    probes = torch.tensor(_jax_probes(key, num_batches, 4 // num_batches, n, jnp.float64))
    loss = bnn.callibration_loss(net.apply, net.unflat, torch.exp, n, lanczos_rank=8, slq_num_samples=4,
                                 slq_num_batches=num_batches)
    log_alpha = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    value = loss(log_alpha, net.p, net.x, net.y, probes)
    value.backward()
    _close(value, value_j, RTOL64)
    _close(log_alpha.grad, grad_j, RTOL64)


def test_calibration_gradient_costs_three_products_a_step(net64, monkeypatch):
    """One ``value_and_grad`` in ``log alpha``: S probes x K steps GGN products forward,
    two a step backward (the re-projected adjoint's operator application and its
    VJP), none in the parameters, inputs or labels."""
    net = net64
    calls = {"linearize": 0}
    linearize = bnn._linearize_batched

    def counted(*args):
        calls["linearize"] += 1
        return linearize(*args)

    monkeypatch.setattr(bnn, "_linearize_batched", counted)
    S, K = 3, 5
    loss = bnn.callibration_loss(net.apply, net.unflat, torch.exp, net.p.shape[0], lanczos_rank=K,
                                 slq_num_samples=S)
    log_alpha = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    value = loss(log_alpha, net.p, net.x, net.y, torch.Generator().manual_seed(0))
    assert calls["linearize"] == S * K
    (grad,) = torch.autograd.grad(value, log_alpha)
    assert calls["linearize"] == 3 * S * K
    assert torch.isfinite(grad)
    # The parameters get their (second-order) gradient only when they ask for one.
    params = net.p.clone().requires_grad_()
    value = loss(log_alpha, params, net.x, net.y, torch.Generator().manual_seed(0))
    g_alpha, g_params = torch.autograd.grad(value, [log_alpha, params])
    assert torch.isfinite(g_params).all() and torch.allclose(g_alpha, grad, rtol=0.5)


def test_damped_ggn_parameter_gradient_is_autograd_through_the_product(net64):
    net = net64
    gvp = bnn.ggn_vp(**net.kwargs())
    matvec = bnn._damped_ggn_matvec(net.apply, net.unflat)
    rng = np.random.default_rng(9)
    v, g = (torch.tensor(rng.standard_normal(net.p.shape[0])) for _ in range(2))
    alpha = torch.tensor(0.4, dtype=torch.float64)
    p1, p2 = net.p.clone().requires_grad_(), net.p.clone().requires_grad_()
    (want,) = torch.autograd.grad(gvp(v, p1, net.x, net.y) + alpha * v, p1, g)
    (got,) = torch.autograd.grad(matvec(v, alpha, p2, net.x, net.y), p2, g)
    _close(got, want, 1e-12, 1e-15)


def test_calibration_loss_diagonal_matches_jax(net64):
    net = net64
    n = net.p.shape[0]
    loss_j = jbnn.callibration_loss_diagonal(net.apply_j, net.unflat_j, jnp.exp, 5, 2, n)
    value_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(0.2), net.p_j, net.jx(net.x_np),
                                                          net.jx(net.y_np))
    probes = torch.tensor(_jax_level_probes(jax.random.PRNGKey(0), 2, 5, n, jnp.float64))
    loss = bnn.callibration_loss_diagonal(net.apply, net.unflat, torch.exp, 5, 2, n, key=probes)
    log_alpha = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    value = loss(log_alpha, net.p, net.x, net.y)
    value.backward()
    _close(value, value_j, RTOL64)
    _close(log_alpha.grad, grad_j, RTOL64)
    # The default probes are fixed: the same at every call.
    fixed = bnn.callibration_loss_diagonal(net.apply, net.unflat, torch.exp, 5, 2, n)
    a = torch.tensor(0.2, dtype=torch.float64)
    assert torch.equal(fixed(a, net.p, net.x, net.y), fixed(a, net.p, net.x, net.y))
    assert bnn.calibration_loss_diagonal is bnn.callibration_loss_diagonal
    assert bnn.calibration_loss is bnn.callibration_loss


# ---------------------------------------------------------------------------
# Samplers, Jacobians, log-pdfs and predictives
# ---------------------------------------------------------------------------


def test_samplers_match_jax_with_jax_draws(x64):
    small = Net("float64", hidden=(6, 4))
    xj, yj = small.jx(small.x_np), small.jx(small.y_np)
    n = small.p.shape[0]
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (4, n), dtype=jnp.float64))
    ggn_j, ggn_t = jbnn.ggn_full(**small.kwargs_j()), bnn.ggn_full(**small.kwargs())
    alpha = 1.0
    got = bnn.sampler_cholesky(ggn_fun=ggn_t, num=4)(torch.tensor(eps), alpha, small.p, small.x, small.y)
    _close(got, jax.jit(jbnn.sampler_cholesky(ggn_fun=ggn_j, num=4))(key, alpha, small.p_j, xj, yj), 1e-8, 1e-12)
    got = bnn.sampler_lanczos(ggn_fun=ggn_t, num=4, lanczos_rank=10)(torch.tensor(eps), alpha, small.p,
                                                                     small.x, small.y)
    want = jax.jit(jbnn.sampler_lanczos(ggn_fun=ggn_j, num=4, lanczos_rank=10))(key, alpha, small.p_j, xj, yj)
    _close(got, want, 1e-8, 1e-11)
    # lanczos_sampler at the JAX tests' widths, on 32 points of 3 classes: a GGN of
    # rank 64, so that the Krylov space of depth 12 does not run out (where it
    # does, whether a residual of ~1e-13 is truncated is a matter of rounding).
    net = Net("float64", num=32, classes=3)
    n = net.p.shape[0]
    eps = np.asarray(jax.random.normal(key, (3, n), dtype=jnp.float64))
    gvp_j, gvp = jbnn.ggn_vp(**net.kwargs_j()), bnn.ggn_vp(**net.kwargs())
    want = jax.jit(lambda k: jbnn.lanczos_sampler(
        ggn_vp=lambda v: gvp_j(v, net.p_j, net.jx(net.x_np), net.jx(net.y_np)) + v, num_samples=3,
        lanczos_rank=12, key=k, params_vec=net.p_j))(key)
    got = bnn.lanczos_sampler(ggn_vp=lambda v: gvp(v, net.p, net.x, net.y) + v, num_samples=3, lanczos_rank=12,
                              key=torch.tensor(eps), params_vec=net.p)
    # Each sample moves along the Ritz vectors by sqrt(1/w) times the leading draws,
    # so it depends on eigh's arbitrary choice of eigenvectors (their signs, and a
    # basis of each repeated eigenvalue's space), which differs between LAPACK
    # builds; the port fixes the signs. Held blind to that choice: the same length
    # of move within every eigenspace of JAX's tridiagonal matrix, and in all.
    factorise = jax.jit(lambda v: jbnn.lanczos.tridiag(
        lambda u: gvp_j(u, net.p_j, net.jx(net.x_np), net.jx(net.y_np)) + u, 12, reortho="full")(v))
    for draw, sample, sample_j in zip(eps, got, np.asarray(want)):
        (Q, (d, o)), _ = factorise(jnp.asarray(draw))
        w, V = np.linalg.eigh(np.asarray(jbnn._dense_tridiag(d, o)))
        ritz = np.asarray(Q).T @ V
        move, move_j = sample.numpy() - net.p.numpy(), sample_j - np.asarray(net.p_j)
        spaces = np.cumsum(np.r_[True, np.diff(w) > 1e-6 * np.abs(w).max()])
        for space in np.unique(spaces):
            cols = ritz[:, spaces == space]
            np.testing.assert_allclose(np.linalg.norm(cols.T @ move), np.linalg.norm(cols.T @ move_j),
                                       rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(np.linalg.norm(move), np.linalg.norm(move_j), rtol=1e-9)


def test_jacfwd_map_and_logpdfs_match_jax(x64):
    rng = np.random.default_rng(10)
    W = rng.standard_normal((6, 6))
    A = W @ W.T / 6 + 0.5 * np.eye(6)
    y, mean = rng.standard_normal(6), rng.standard_normal(6)

    def fun_j(x):
        return jnp.stack([jnp.sum(x**2), x[0] * x[1], jnp.sin(x[2])])

    def fun(x):
        return torch.stack([torch.sum(x**2), x[0] * x[1], torch.sin(x[2])])

    x = np.asarray([1.0, 2.0, 3.0])
    _close(bnn.jacfwd_map(fun)(torch.tensor(x)), jax.jacfwd(fun_j)(jnp.asarray(x)), RTOL64)
    _close(bnn.jacfwd_map(fun)(torch.tensor(x)), jbnn.jacfwd_map(fun_j)(jnp.asarray(x)), RTOL64)
    At = torch.tensor(A)
    for make, make_j in ((bnn.logpdf_cholesky, jbnn.logpdf_cholesky), (bnn.logpdf_eigh, jbnn.logpdf_eigh)):
        got, _ = make()(torch.tensor(y), mean=torch.tensor(mean), cov=lambda v: At @ v)
        want, _ = make_j()(jnp.asarray(y), mean=jnp.asarray(mean), cov=lambda v: jnp.asarray(A) @ v)
        _close(got, want, RTOL64)


def test_reortho_cg_solution_and_vjp_match_jax(x64):
    rng = np.random.default_rng(11)
    W = rng.standard_normal((30, 30))
    A = W @ W.T / 30 + 0.1 * np.eye(30)
    b, cot = rng.standard_normal(30), rng.standard_normal(30)
    diag = np.diag(A).copy()
    for precond in (False, True):
        P = (lambda v: v / torch.tensor(diag)) if precond else (lambda v: v)
        P_j = (lambda v: v / jnp.asarray(diag)) if precond else (lambda v: v)

        def solve_j(bb, s):
            return jcg.pcg_fixed_step_reortho(12)(lambda v: s * (jnp.asarray(A) @ v), bb, P_j)[0]

        x_j, vjp = jax.vjp(solve_j, jnp.asarray(b), jnp.asarray(1.3))
        db_j, ds_j = vjp(jnp.asarray(cot))
        bt = torch.tensor(b, requires_grad=True)
        st = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        x, info = cg.pcg_fixed_step_reortho(12)(lambda v, s: s * (torch.tensor(A) @ v), bt, st, P=P)
        _close(x, x_j, RTOL64, 1e-13)
        db, ds = torch.autograd.grad(x, [bt, st], torch.tensor(cot))
        _close(db, db_j, 1e-8, 1e-12)
        _close(ds, ds_j, 1e-8)
        assert info["Q"].shape == (12, 30)
    x, _ = cg.krylov_solve_cg_fixed_step_reortho(12)(lambda v: torch.tensor(A) @ v, torch.tensor(b))
    _close(x, jcg.krylov_solve_cg_fixed_step_reortho(12)(lambda v: jnp.asarray(A) @ v, jnp.asarray(b))[0],
           RTOL64, 1e-13)
    _close(cg._safe_sqrt(torch.tensor([-1.0, 4.0])), [0.0, 2.0], 0)


def test_solve_forward_mode_is_the_linear_solve(x64):
    """Under ``torch.func.jvp`` the solve's tangent is the solve of the tangent, as
    ``custom_linear_solve`` makes it in JAX, not the derivative of the iterations."""
    rng = np.random.default_rng(12)
    W = rng.standard_normal((10, 10))
    A = torch.tensor(W @ W.T / 10 + np.eye(10))
    b, db = torch.tensor(rng.standard_normal(10)), torch.tensor(rng.standard_normal(10))
    solve = cg.cg_fixed_step_reortho(4)
    _x, tangent = torch.func.jvp(lambda bb: solve(lambda v: A @ v, bb)[0], (b,), (db,))
    _close(tangent, solve(lambda v: A @ v, db)[0], 1e-14, 1e-15)


def test_laplace_predictives_match_jax(x64):
    net = Net("float64", hidden=(6, 4))
    xj, yj = net.jx(net.x_np), net.jx(net.y_np)
    ggn = np.asarray(jax.jit(jbnn.ggn_full(**net.kwargs_j()))(1.0, net.p_j, xj, yj))
    ggn_t = torch.tensor(ggn)
    for logpdf, logpdf_j in ((bnn.logpdf_eigh, jbnn.logpdf_eigh), (bnn.logpdf_cholesky, jbnn.logpdf_cholesky)):
        evaluate = jbnn.predictive_posterior_loglikelihood(
            model_apply=net.apply_j, unflatten=net.unflat_j, logpdf=logpdf_j(), ggn_fun=lambda v: jnp.asarray(ggn) @ v
        )
        want = jax.jit(lambda p, x, y: evaluate(p, x, y)[0])(net.p_j, xj[:3], yj[:3])
        got, _ = bnn.predictive_posterior_loglikelihood(
            model_apply=net.apply, unflatten=net.unflat, logpdf=logpdf(), ggn_fun=lambda v: ggn_t @ v
        )(net.p, net.x[:3], net.y[:3])
        _close(got, want, 1e-9)
    key = jax.random.PRNGKey(5)
    want = jax.jit(jbnn.predictive_logit_sampler(model_apply=net.apply_j, unflatten=net.unflat_j, num_samples=4,
                                                 ggn_fun=lambda v: jnp.asarray(ggn) @ v))(net.p_j, xj[:3], yj[:3], key)
    eps = torch.tensor(np.asarray(jax.random.normal(key, (4, 6), dtype=jnp.float64)))
    got = bnn.predictive_logit_sampler(model_apply=net.apply, unflatten=net.unflat, num_samples=4,
                                       ggn_fun=lambda v: ggn_t @ v)(net.p, net.x[:3], net.y[:3], eps)
    assert got.shape == (4, 3, 2)
    _close(got, want, 1e-9, 1e-12)


# ---------------------------------------------------------------------------
# State helpers
# ---------------------------------------------------------------------------


def test_bind_model_state_uses_the_buffers_in_eval_mode():
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4), torch.nn.Dropout(0.5))
    params = {k: v.detach() for k, v in module.named_parameters()}
    stats = {"1.running_mean": torch.full((4,), 0.3), "1.running_var": torch.full((4,), 2.0),
             "1.num_batches_tracked": torch.tensor(5)}
    x = torch.randn(6, 3)
    fn = bnn.bind_model_state(module, batch_stats=stats)
    want = (x @ params["0.weight"].T + params["0.bias"] - 0.3) / torch.sqrt(torch.tensor(2.0 + 1e-5))
    want = want * params["1.weight"] + params["1.bias"]
    assert torch.allclose(fn(params, x), want, atol=1e-6)
    assert module.training  # restored
    same = bnn.get_model_apply_fn("van_tiny", module, batch_stats=stats)
    assert torch.equal(same(params, x), fn(params, x))
    assert bnn.bind_model_state(len) is len
    with pytest.raises(TypeError, match="nn.Module"):
        bnn.bind_model_state(len, batch_stats=stats)
    dropout_off = bnn.bind_model_state(module, dropout_rng=torch.Generator().manual_seed(0))
    assert torch.equal(dropout_off(params, x), dropout_off(params, x))


def test_img_to_patch_matches_jax():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    for flatten in (True, False):
        got = bnn.img_to_patch(torch.tensor(x), 2, flatten_channels=flatten)
        _close(got, jbnn.img_to_patch(jnp.asarray(x), 2, flatten_channels=flatten), 0)


def test_every_public_name_has_a_counterpart():
    import inspect

    from lanczos_adjoints_tpu.models import bnn as jax_bnn

    for jax_module, port in ((jax_bnn, bnn), (jbase, bnn_baselines)):
        names = [n for n, v in vars(jax_module).items() if not n.startswith("_") and inspect.isfunction(v)
                 and v.__module__ == jax_module.__name__]
        assert len(names) > 4 and [n for n in names if not callable(getattr(port, n, None))] == []
    for name in ("cg_fixed_step_reortho", "pcg_fixed_step_reortho", "krylov_solve_cg_fixed_step_reortho",
                 "_safe_sqrt"):
        assert callable(getattr(jcg, name)) and callable(getattr(cg, name))
