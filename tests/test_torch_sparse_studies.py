"""The port's sparse-format, roofline and scaling studies (``studies.
dia_roofline``, ``studies.spmv_formats``, ``studies.multihost_scaling``)
against the JAX package's scripts under ``experiments/benchmarks/`` on the
CPU, with the same numpy inputs.

- K12's plain version equals the JAX ``speed_of_light`` (its Pallas kernel
  in interpret mode) bit for bit at n = 262,144, D = 5, chunk 1024.
- The roofline's traffic at ``--n_side`` 1024 and 2048 equals the committed
  artifacts' (packing only, no timing).
- The formats study at grid 64, random 4,096 x 8 and FEM 6: every row's
  matvec and VJP in x against the JAX format's (its Pallas kernels in
  interpret mode where they pack) at 1e-5, ``fill`` equal, and the row keys
  those of the committed ``formats.json``.
- The scaling model (``fit_affine_cost``, ``gram_model``, ``dia_model``,
  ``regime_80``) equals the JAX script's on the committed ``local_steps``
  with the JAX script's link constants passed in; ``--model_only`` on a
  copy of the committed ``scaling.json`` reproduces its ``comm_model``, as
  the JAX script's own functions do exactly.
- The measured path on 1, 2 and 4 partitions equals the unsharded route.
- The new studies import no JAX; every study's ``problem`` runs on the card
  unless asked for the CPU (C11).

Everything runs on one intra-op thread.
"""

import ast
import functools
import importlib
import importlib.util
import inspect
import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from lanczos_adjoints_tpu.ops import pallas_bsr as jpallas_bsr  # noqa: E402
from lanczos_adjoints_tpu.ops import pallas_dia as jpallas_dia  # noqa: E402
from lanczos_adjoints_tpu.ops import sparse as jsparse  # noqa: E402
from lanczos_adjoints_tpu_torch import studies  # noqa: E402
from lanczos_adjoints_tpu_torch.krylov import lanczos  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_dia, sparse  # noqa: E402
from lanczos_adjoints_tpu_torch.studies import dia_roofline, multihost_scaling, spmv_formats  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import test_util  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BENCHMARKS = REPO / "experiments/benchmarks"
RESULTS = REPO / "results/benchmarks"
TOL_FORMATS = 1e-5  # the JAX sparse tests' tolerance
JAX_ROW_KEYS = {"case", "format", "time_s", "time_vjp_s", "nnz_per_s", "fill"}


@pytest.fixture(autouse=True)
def _pin():
    pin_float32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# K12 and the roofline
# ---------------------------------------------------------------------------


def test_k12_plain_equals_the_jax_speed_of_light_bit_for_bit():
    script = _load_script(BENCHMARKS / "spmv_formats/dia_roofline.py", "jax_dia_roofline")
    n, num_diags, chunk = 262_144, 5, 1024
    rng = np.random.default_rng(12)
    x = rng.standard_normal(n).astype(np.float32)
    vals = rng.standard_normal((num_diags, n)).astype(np.float32)
    with mock.patch.object(script.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)):
        want = np.asarray(script.speed_of_light(n, num_diags, chunk)(jnp.asarray(x), jnp.asarray(vals)))
    got = fused_dia.dia_ceiling_plain(torch.tensor(x), torch.tensor(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    # The study's probe and the wrapper take the plain version for CPU tensors.
    for threads in fused_dia.CEILING_THREADS:
        run = dia_roofline.speed_of_light(n, num_diags, threads)
        np.testing.assert_array_equal(run(torch.tensor(x), torch.tensor(vals)).numpy(), want)


def test_k12_wrapper_rejects_what_the_kernel_does_not_take():
    x, vals = torch.zeros(16), torch.zeros(3, 16)
    with pytest.raises(ValueError, match="threads"):
        fused_dia.dia_ceiling_rows(x, vals, threads=64)
    with pytest.raises(ValueError, match="shape"):
        fused_dia.dia_ceiling_rows(x, torch.zeros(3, 15))
    with pytest.raises(TypeError, match="float32"):
        fused_dia.dia_ceiling_rows(x.double(), vals.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_dia.dia_ceiling_rows(torch.zeros(32)[::2], vals)


@pytest.mark.parametrize("n_side", [1024, 2048])
def test_roofline_traffic_equals_the_committed_artifact(n_side):
    committed = json.loads((RESULTS / f"spmv_formats/dia_roofline/dia_roofline_n{n_side}.json").read_text())
    got = dia_roofline.traffic(dia_roofline._laplacian_2d(n_side))
    for key in ("n", "num_diags", "bytes_per_matvec", "bytes_per_nnz", "traffic_model"):
        assert got[key] == committed[key], key
    if n_side == 1024:
        assert got["bytes_per_matvec"] == 29_360_128 and round(got["bytes_per_nnz"], 4) == 5.6022


def test_roofline_verdicts_clamp_as_jax_and_keep_the_ratio():
    row = lambda t, cold, **k: {"time_s": t, "time_s_l2_cold": cold, "resolved": True, **k}  # noqa: E731
    artifact = {"bytes_per_matvec": 29_360_128,
                "ceiling": {"256": row(9e-6, 10e-6), "512": row(8e-6, 11e-6)},
                "sweep": [row(7e-6, 12e-6, matvec="k4"), row(2e-4, 3e-4, matvec="plain"),
                          row(1e-6, 1e-6, matvec="cusparse")]}
    out = dia_roofline.verdicts(artifact)
    assert out["best"]["matvec"] == "k4"  # cuSPARSE is a yardstick, never the best
    assert out["pct_of_attainable"] == 1.0 and out["pct_of_attainable_unclamped"] == pytest.approx(8 / 7)
    assert out["pct_of_attainable_l2_cold"] == pytest.approx(10 / 12)
    assert out["hbm_floor_s"] == pytest.approx(29_360_128 / 3.35e12)
    assert out["l2_resident_regime"] is True  # 7 us is under the 8.76 us floor


def test_roofline_cli_writes_the_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(dia_roofline, "REPS", 2)
    monkeypatch.setattr(dia_roofline, "OPERAND_SETS", 2)
    art = dia_roofline.main(["--n_side", "32", "--device", "cpu", "--out", str(tmp_path)])
    committed = json.loads((RESULTS / "spmv_formats/dia_roofline/dia_roofline_n1024.json").read_text())
    written = json.loads((tmp_path / "dia_roofline_n32.json").read_text())
    assert set(committed) - {"vmem_resident_regime"} <= set(written)
    assert "l2_resident_regime" in written and "vmem_resident_regime" not in written
    assert sorted(art["ceiling"]) == sorted(str(t) for t in fused_dia.CEILING_THREADS)
    assert [r["matvec"] for r in art["sweep"]] == list(dia_roofline.SWEEP)
    assert all(r["time_s"] > 0 and r["time_s_l2_cold"] > 0 for r in [*art["ceiling"].values(), *art["sweep"]])
    assert art["hbm_spec_gb_per_s"] == 3350.0


# ---------------------------------------------------------------------------
# The formats study
# ---------------------------------------------------------------------------

FORMATS_CASE = {"grid": 64, "random_n": 4096, "random_nnz_per_row": 8, "fem_grid": 6}


def _jax_operator(mat_j, fmt):
    """``(matvec, values, fill)`` of the JAX script's ``fmt``, or None where it does not pack."""
    if fmt in ("dia", "dia_kernel"):
        dia = jsparse.dia_pack(mat_j)
        values = jnp.asarray(jsparse.dia_values(dia, mat_j.data), jnp.float32)
        if fmt == "dia_kernel":
            if mat_j.shape[0] % 1024:
                return None  # the Pallas kernel's (8, 128) tiling
            matvec = jpallas_dia.dia_matvec_pallas(dia, interpret=True)
        else:
            matvec = jsparse.dia_matvec_fn(dia)
        return matvec, values, mat_j.nnz / int(np.prod(values.shape))
    if fmt == "bsr_kernel":
        bsr = jsparse.bsr_pack(mat_j)
        values = jnp.asarray(jsparse.bsr_values(bsr, mat_j.data), jnp.float32)
        matvec = jpallas_bsr.bsr_matvec_pallas(bsr, symmetric=mat_j.is_symmetric(), interpret=True)
        return matvec, values, mat_j.nnz / bsr.num_slots
    if fmt == "ell_gather":
        ell = jsparse.ell_pack(mat_j)
        return jsparse.ell_matvec_fn_gather(ell), jsparse.ell_values(ell, mat_j.data), mat_j.nnz / ell.num_slots
    matvec, values, info = jsparse.sparse_operator(mat_j, format=fmt, with_info=True)
    return matvec, values, info.fill_efficiency


@functools.cache
def _formats_run():
    with mock.patch.object(spmv_formats, "REPS", 2):
        case_list = spmv_formats.cases(*FORMATS_CASE.values())
        rows, outputs, launches = spmv_formats.run(case_list, device="cpu")
    return case_list, rows, outputs, launches


def test_formats_rows_match_the_jax_formats():
    script = _load_script(BENCHMARKS / "spmv_formats/benchmark.py", "jax_spmv_formats")
    case_list, rows, outputs, launches = _formats_run()
    jax_mats = {
        "laplacian_2d": script.laplacian_2d(FORMATS_CASE["grid"]),
        "laplacian_2d_small": script.laplacian_2d(FORMATS_CASE["grid"] // 4),
        "random": script.random_csr(FORMATS_CASE["random_n"], FORMATS_CASE["random_nnz_per_row"]),
    }
    fem = jpallas_bsr.fem_test_matrix(FORMATS_CASE["fem_grid"], dofs=3)
    jax_mats["fem_3dof"] = fem
    jax_mats["fem_3dof_rcm"] = jsparse.permute_symmetric(fem, jsparse.reverse_cuthill_mckee(fem))
    assert sorted(c for c, _m, _f in case_list) == sorted(jax_mats)
    fills = {(r["case"], r["format"]): r["fill"] for r in rows}
    checked = 0
    for case, mat, formats in case_list:
        mat_j = jax_mats[case]
        np.testing.assert_array_equal(mat.indices, mat_j.indices)
        np.testing.assert_allclose(mat.data, mat_j.data, rtol=0, atol=0)
        v = jnp.ones((mat.shape[0],), jnp.float32)
        for fmt in formats:
            op = _jax_operator(mat_j, fmt)
            if op is None:  # held to the JAX script's plain DIA instead
                op = _jax_operator(mat_j, "dia")
            matvec, values, fill = op
            want_mv = np.asarray(matvec(v, values))
            want_vjp = np.asarray(jax.grad(lambda x, vl, mv=matvec: jnp.sum(mv(x, vl) ** 2))(v, values))
            got_mv, got_vjp = (t.numpy() for t in outputs[(case, fmt)])
            assert _rel(got_mv, want_mv) <= TOL_FORMATS, (case, fmt)
            assert _rel(got_vjp, want_vjp) <= TOL_FORMATS, (case, fmt)
            assert fills[(case, fmt)] == pytest.approx(fill, rel=1e-12), (case, fmt)
            assert launches[(case, fmt)] == {"matvec": {}, "vjp": {}}  # CPU tensors launch nothing
            checked += 1
    assert checked == len(rows) == 11


def test_formats_rows_have_the_committed_keys(tmp_path, monkeypatch, capsys):
    committed = json.loads((RESULTS / "spmv_formats/benchmark/formats.json").read_text())
    assert all(set(r) - {"unresolved"} == JAX_ROW_KEYS for r in committed)
    _case_list, rows, _outputs, _launches = _formats_run()
    port_to_jax = {"dia_kernel": "dia_pallas", "bsr_kernel": "bsr_pallas"}
    want = [(r["case"], r["format"]) for r in committed if r["case"] != "bloweybq"]
    assert [(r["case"], port_to_jax.get(r["format"], r["format"])) for r in rows] == want
    for r in rows:
        assert set(r) - {"same_as"} == JAX_ROW_KEYS, r
        assert all(r[k] > 0 for k in ("time_s", "time_vjp_s", "nnz_per_s"))
    ell, gather = (next(r for r in rows if r["case"] == "random" and r["format"] == f) for f in ("ell", "ell_gather"))
    assert gather["same_as"] == "ell" and gather["time_s"] == ell["time_s"]
    assert sparse.ell_matvec_fn_gather is sparse.ell_matvec_fn
    # The CLI writes the rows, and names the missing bloweybq file.
    monkeypatch.setattr(spmv_formats, "REPS", 1)
    capsys.readouterr()
    spmv_formats.main(["--grid", "16", "--random_n", "256", "--fem_grid", "3", "--device", "cpu", "--out",
                       str(tmp_path)])
    assert "data/matrices/bloweybq.mtx is not in the repository" in capsys.readouterr().out
    written = json.loads((tmp_path / "formats.json").read_text())
    assert [(r["case"], r["format"]) for r in written] == [(c, f) for c, _m, fs in spmv_formats.cases(16, 256, 8, 3)
                                                           for f in fs]


@pytest.mark.parametrize("fmt", ["hyb", "coo"])
def test_bloweybq_formats_match_the_jax_formats(fmt):
    """The formats of the case that waits for ``bloweybq.mtx``, on the random
    matrix with two dense rows (HYB's heavy rows) meanwhile."""
    rng = np.random.default_rng(3)
    n = 512
    rows = np.concatenate([np.repeat(np.arange(n), 4), np.full(n, 7), np.full(n, 300)])
    cols = np.concatenate([rng.integers(0, n, 4 * n), np.arange(n), np.arange(n)])
    vals = rng.normal(size=len(rows)).astype(np.float32)
    mat = sparse.csr_from_coo(rows, cols, vals, shape=(n, n))
    mat_j = jsparse.csr_from_coo(rows, cols, vals, shape=(n, n))
    matvec, values, info = spmv_formats.operator(mat, fmt, device="cpu")
    if fmt == "coo":
        matvec_j, values_j = jsparse.coo_matvec_fn(mat_j)
        fill_j = 1.0
    else:
        matvec_j, values_j, info_j = jsparse.sparse_operator(mat_j, format=fmt, with_info=True)
        fill_j = info_j.fill_efficiency
    v = rng.standard_normal(n).astype(np.float32)
    got_mv = matvec(torch.tensor(v), *spmv_formats._args(values)).numpy()  # HYB's values are a pair
    got_vjp = spmv_formats.vjp_in_x(matvec)(torch.tensor(v), values).numpy()
    want_mv = np.asarray(matvec_j(jnp.asarray(v), values_j))
    want_vjp = np.asarray(jax.grad(lambda x: jnp.sum(matvec_j(x, values_j) ** 2))(jnp.asarray(v)))
    assert _rel(got_mv, want_mv) <= TOL_FORMATS and _rel(got_vjp, want_vjp) <= TOL_FORMATS
    assert info.format == fmt and info.fill_efficiency == pytest.approx(fill_j, rel=1e-12)


def test_formats_predicted_launches():
    assert spmv_formats.predicted_launches("dia_kernel") == {
        "matvec": {"dia_matvec": 1}, "vjp": {"dia_matvec": 1, "dia_matvec_transposed": 1}}
    assert spmv_formats.predicted_launches("bsr_kernel") == {"matvec": {"bsr_spmv": 1}, "vjp": {"bsr_spmv": 2}}
    for fmt in ("dia", "bsr", "ell", "ell_gather", "hyb", "coo"):
        assert spmv_formats.predicted_launches(fmt) == {"matvec": {}, "vjp": {}}


# ---------------------------------------------------------------------------
# The scaling study
# ---------------------------------------------------------------------------


@functools.cache
def _scaling_script():
    return _load_script(BENCHMARKS / "multihost_scaling/benchmark.py", "jax_multihost_scaling")


def _committed_scaling():
    return json.loads((RESULTS / "multihost_scaling/benchmark/scaling.json").read_text())


def _tables(steps, *, all_resolved=False):
    gram = {int(k): v for k, v in steps["gram"]["rows_table"].items()}
    dia = {int(k): dict(v, time_s=abs(v["time_s"]), resolved=True) if all_resolved else v
           for k, v in steps["dia"]["rows_table"].items()}
    return gram, dia


@pytest.mark.parametrize("all_resolved", [False, True])
def test_scaling_model_equals_the_jax_script(all_resolved):
    script = _scaling_script()
    steps = _committed_scaling()["local_steps"]
    gram, dia = _tables(steps, all_resolved=all_resolved)
    link = {"link_bytes_per_s": script.ICI_BW, "link_latency_s": script.ICI_LAT}
    assert multihost_scaling.DEVICE_GRID == script.DEVICE_GRID
    assert multihost_scaling.MEASURE_GRID == script.MEASURE_GRID
    for table in (gram, dia):
        assert multihost_scaling.fit_affine_cost(table) == script.fit_affine_cost(table)
    for scale in (1.0, 0.8, 1.25):
        assert (multihost_scaling.gram_model(gram, steps["gram"]["n"], scale=scale, **link)
                == script.gram_model(gram, steps["gram"]["n"], scale=scale))
        got = multihost_scaling.dia_model(dia, steps["dia"]["n"], steps["dia"]["bandwidth"], scale=scale, **link)
        assert got == script.dia_model(dia, steps["dia"]["n"], steps["dia"]["bandwidth"], scale=scale)
        assert (got[0] is None) == (not all_resolved)
    gm, _fit = script.gram_model(gram, steps["gram"]["n"])
    dm, _fit = script.dia_model(dia, steps["dia"]["n"], steps["dia"]["bandwidth"])
    for rows, key in ((gm, "predicted_efficiency"), (dm, "predicted_efficiency_sequential"),
                      (dm, "predicted_efficiency_overlapped")):
        if rows is not None:
            assert multihost_scaling.regime_80(rows, key) == script.regime_80(rows, key)
    assert multihost_scaling.regime_80([{"rows_per_device": 8, "x": 0.5}], "x") == script.regime_80(
        [{"rows_per_device": 8, "x": 0.5}], "x")


def test_scaling_model_only_reproduces_the_committed_comm_model(tmp_path):
    committed = _committed_scaling()
    script = _scaling_script()
    # The JAX script's own functions rebuild the committed model exactly.
    gram, dia = _tables(committed["local_steps"])
    gm, gram_fit = script.gram_model(gram, committed["local_steps"]["gram"]["n"])
    assert gm == committed["comm_model"]["gram_flagship"]
    assert gram_fit == committed["comm_model"]["assumptions"]["local_cost_fit"]["gram"]
    shutil.copy(RESULTS / "multihost_scaling/benchmark/scaling.json", tmp_path / "scaling.json")
    artifact, measured = multihost_scaling.main(["--model_only", "--device", "cpu", "--out", str(tmp_path)])
    assert measured is None
    model, want = artifact["comm_model"], committed["comm_model"]
    for key in ("gram_flagship", "dia_lanczos", "efficiency_80_regime"):
        assert model[key] == want[key], key
    assumptions = model["assumptions"]
    assert assumptions["local_cost_fit"] == want["assumptions"]["local_cost_fit"]
    assert assumptions["link_bytes_per_s_per_direction"] == want["assumptions"]["ici_bytes_per_s_per_direction"]
    assert assumptions["link_one_hop_latency_s"] == want["assumptions"]["ici_one_hop_latency_s"]
    assert json.loads((tmp_path / "scaling.json").read_text())["comm_model"] == json.loads(json.dumps(model))
    # Given on the command line, the link numbers take precedence.
    artifact, _ = multihost_scaling.main(["--model_only", "--device", "cpu", "--out", str(tmp_path),
                                          "--link_bytes_per_s", "1e12", "--link_latency_s", "1e-5"])
    assert artifact["comm_model"]["assumptions"]["link_bytes_per_s_per_direction"] == 1e12
    assert artifact["comm_model"]["gram_flagship"] != want["gram_flagship"]


def test_scaling_link_numbers_have_no_default():
    for fn in (multihost_scaling.gram_model, multihost_scaling.dia_model):
        params = inspect.signature(fn).parameters
        for name in ("link_bytes_per_s", "link_latency_s"):
            assert params[name].default is inspect.Parameter.empty and params[name].kind is params[name].KEYWORD_ONLY
    with pytest.raises(ValueError, match="no link numbers"):
        multihost_scaling.link_constants({"local_steps": {}})
    stand_ins = {"local_steps": {"link": {"copy_bytes_per_s": 2e12, "launch_sync_latency_s": 1e-5, "device": "card"}}}
    assert multihost_scaling.link_constants(stand_ins)[:2] == (2e12, 1e-5)


def test_scaling_measure_local_needs_the_card(tmp_path):
    with pytest.raises(SystemExit, match="needs the card"):
        multihost_scaling.main(["--measure_local", "--device", "cpu", "--out", str(tmp_path)])


def test_scaling_local_tables_on_the_cpu(monkeypatch):
    monkeypatch.setattr(multihost_scaling, "REPS", 1)
    monkeypatch.setattr(multihost_scaling, "MEASURE_GRID", [1, 2, 3])
    gram = multihost_scaling.measure_gram_local(600, 3, device="cpu")
    dia = multihost_scaling.measure_dia_local(8192, 64, device="cpu")
    assert sorted(gram) == [200, 300, 600] and all(len(e["times"]) == 3 and e["resolved"] for e in gram.values())
    assert sorted(dia) == [2048, 4096, 8192] and all(e["time_s"] > 0 for e in dia.values())
    assert multihost_scaling.local_rows(1 << 20, 48) == 21_504
    fit = multihost_scaling.fit_affine_cost(gram)
    assert fit["points"] == 3 and fit["overhead_s"] >= 0 and fit["per_row_s"] >= 0


def test_measured_path_on_partitions_equals_the_unsharded_route():
    n, bandwidth, depth = 4096, 64, 10
    rows, grads, launches = multihost_scaling.measured_virtual_mesh(n, bandwidth, depth, 2, device="cpu",
                                                                    sizes=(1, 2, 4))
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(set(r) == {"devices", "time_s", "efficiency", "many_over_one"} for r in rows)
    assert rows[0]["efficiency"] == 1.0 and launches == {1: {}, 2: {}, 4: {}}
    mat = test_util.five_diagonal(n, bandwidth)
    matvec, vals = sparse.sparse_operator(mat, format="dia", device="cpu")
    estimate = lanczos.tridiag(matvec, depth, reortho="none")
    inputs = [torch.ones(n, requires_grad=True), vals.clone().requires_grad_()]
    outputs = multihost_scaling._leaves(estimate(*inputs))
    want = torch.autograd.grad(outputs, inputs, [torch.ones_like(o) for o in outputs])
    for p, got in grads.items():
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w.numpy()) <= 1e-5, p


# ---------------------------------------------------------------------------
# Imports and defaults
# ---------------------------------------------------------------------------


def test_new_studies_import_no_jax_or_matplotlib():
    modules = ["studies.dia_roofline", "studies.spmv_formats", "studies.multihost_scaling"]
    code = ("import sys; before = set(sys.modules)\n"
            + "".join(f"import lanczos_adjoints_tpu_torch.{m}\n" for m in modules)
            + "print(sorted({m.split('.')[0] for m in set(sys.modules) - before}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=REPO)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "lanczos_adjoints_tpu", "matplotlib"}, loaded
    for name in modules:
        tree = ast.parse((REPO / "lanczos_adjoints_tpu_torch" / (name.replace(".", "/") + ".py")).read_text())
        imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
        imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
        assert not {m.split(".")[0] for m in imported} & {"jax", "jaxlib", "lanczos_adjoints_tpu"}, name


def test_every_study_entry_point_defaults_to_the_card():
    """C11: a study's ``problem`` (and every other public function of
    ``studies/`` that takes a device) runs on the card unless asked for the
    CPU, or is given the device."""
    problems = 0
    for info in pkgutil.iter_modules(studies.__path__):
        module = importlib.import_module(f"lanczos_adjoints_tpu_torch.studies.{info.name}")
        for name, fn in inspect.getmembers(module, inspect.isfunction):
            if (name.startswith("_") or fn.__module__ != module.__name__
                    or "device" not in inspect.signature(fn).parameters):
                continue
            default = inspect.signature(fn).parameters["device"].default
            assert default in ("cuda", inspect.Parameter.empty), f"{info.name}.{name}"
            if name == "problem":
                assert default == "cuda", info.name
                problems += 1
    assert problems == 2
