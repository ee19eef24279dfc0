"""The port's MatrixMarket body parser (``native/``), the loader that
dispatches to it (``utils.exp_util.mtx_read``) and its study
(``studies.mtx_parser``) against the JAX package on the CPU.

- ``native.get_mtxparse().parse_body`` equals the JAX package's tracked extension
  (``lanczos_adjoints_tpu/native/mtxparse.cpython-312-*.so``) bit for bit
  on bodies with comment and blank lines, CRLF, tabs, exponents, negative
  values and a ``pattern`` field, and raises the same ``ValueError`` on a
  body shorter than its header. The JAX import must find the tracked
  file, so that no test builds into the JAX package.
- ``mtx_read`` equals the JAX ``mtx_read`` on general, symmetric,
  skew-symmetric and pattern files, plain, ``.gz`` and ``.tar.gz``, on
  the scipy path, on the C++ path (scipy switched off) and on the numpy
  path (``DISABLE`` set in both packages).
- A build that cannot run or fails raises; nothing falls back to numpy.
- ``studies.mtx_parser.synth_mtx`` writes the JAX script's bytes, and the
  study's three paths give one CSR.
"""

import gzip
import importlib.util
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
from lanczos_adjoints_tpu import native as jnative  # noqa: E402
from lanczos_adjoints_tpu.utils import exp_util as jexp_util  # noqa: E402
from lanczos_adjoints_tpu_torch import native  # noqa: E402
from lanczos_adjoints_tpu_torch.studies import mtx_parser  # noqa: E402
from lanczos_adjoints_tpu_torch.utils import exp_util  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_NATIVE = REPO / "lanczos_adjoints_tpu/native"
JAX_STUDY = REPO / "experiments/benchmarks/mtx_parser/benchmark.py"


@pytest.fixture(scope="module")
def jax_mtxparse():
    """The JAX package's tracked extension, imported without a build."""
    spec = importlib.util.find_spec("lanczos_adjoints_tpu.native.mtxparse")
    assert spec is not None and spec.origin is not None, "the tracked mtxparse extension is missing"
    origin = Path(spec.origin)
    assert origin.parent == JAX_NATIVE and origin.name.startswith("mtxparse.cpython-312"), origin
    module = jnative.get_mtxparse()
    assert module is not None and Path(module.__file__) == origin
    return module


BODIES = {
    "plain": ("1 1 2.5\n2 1 -1\n3 3 4\n", 3, True),
    "comments_and_blank_lines": ("% a comment\n\n1 2 0.5\n%another\n   \n2 2 1.25\n\n", 2, True),
    "crlf": ("1 1 1.0\r\n2 3 -2.0\r\n3 2 3.5\r\n", 3, True),
    "tabs": ("1\t2\t3.25\n\t2 1\t-0.75\n", 2, True),
    "exponents": ("1 1 1e-3\n2 2 2.5E+10\n3 3 -3.0e-7\n4 4 .5e1\n", 4, True),
    "negative_values": ("1 2 -1\n2 1 -0.000001\n3 1 -123456.789\n", 3, True),
    "many_digits": ("1 1 0.1234567890123456789\n2 2 1.7976931348623157e308\n3 3 4.9e-324\n", 3, True),
    "pattern": ("1 2\n2 3\n% pattern comment\n3 1\n", 3, False),
    "pattern_crlf": ("1 2\r\n2 3\r\n", 2, False),
    "stops_at_nnz": ("1 1 1\n2 2 2\n3 3 3\n", 2, True),
    "no_trailing_newline": ("1 1 1\n2 2 2", 2, True),
}
SHORT_BODIES = {
    "short": ("1 1 1\n2 2 2\n", 3, True),
    "garbage": ("1 1 1\nfoo 2 2\n3 3 3\n", 3, True),
    "empty": ("", 1, False),
}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_parse_body_equals_the_jax_extension(jax_mtxparse, case):
    text, nnz, has_values = BODIES[case]
    got = native.get_mtxparse().parse_body(text, nnz, has_values)
    want = jax_mtxparse.parse_body(text, nnz, has_values)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (nnz,)
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("case", sorted(SHORT_BODIES))
def test_a_short_body_raises_as_in_jax(jax_mtxparse, case):
    text, nnz, has_values = SHORT_BODIES[case]
    with pytest.raises(ValueError) as want:
        jax_mtxparse.parse_body(text, nnz, has_values)
    with pytest.raises(ValueError) as got:
        native.get_mtxparse().parse_body(text, nnz, has_values)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("parsed ") and f"header promised {nnz}" in str(got.value)


def test_the_parser_is_the_digest_named_library_in_build():
    path = native.get_mtxparse().path
    assert path == native.library_path() and path.parent == REPO / "lanczos_adjoints_tpu_torch/_build"


# ---------------------------------------------------------------------------
# mtx_read through the three paths
# ---------------------------------------------------------------------------

FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% made by a test\n4 5 6\n"
               "1 1 1.5\n2 3 -2.25e-1\n4 5 3\n3 2 7.125\n1 5 -1e3\n4 1 0.1\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n4 4 6\n"
                 "1 1 2\n2 1 -1\n2 2 2\n3 2 -1\n4 3 -1.5\n4 4 2\n",
    "skew-symmetric": "%%MatrixMarket matrix coordinate real skew-symmetric\n%\n4 4 3\n"
                      "2 1 1.25\n3 1 -2\n4 2 0.5\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n3 4 5\n"
               "1 1\n1 4\n2 2\n3 1\n3 3\n",
}


def _write(tmp_path, kind, container):
    text = FILES[kind]
    if container == "plain":
        path = tmp_path / "m.mtx"
        path.write_text(text)
    elif container == "gz":
        path = tmp_path / "m.mtx.gz"
        with gzip.open(path, "wt") as fp:
            fp.write(text)
    else:
        inner = tmp_path / "m.mtx"
        inner.write_text(text)
        path = tmp_path / "m.tar.gz"
        with tarfile.open(path, "w:gz") as tar:
            tar.add(inner, arcname="m/m.mtx")
    return str(path)


@pytest.mark.parametrize("mode", ["scipy", "native", "numpy"])
@pytest.mark.parametrize("container", ["plain", "gz", "tar.gz"])
@pytest.mark.parametrize("kind", sorted(FILES))
def test_mtx_read_equals_the_jax_reader(tmp_path, monkeypatch, jax_mtxparse, kind, container, mode):
    path = _write(tmp_path, kind, container)
    if mode != "scipy":
        monkeypatch.setattr(exp_util, "_mmread_scipy", lambda _p: None)
        monkeypatch.setattr(jexp_util, "_mmread_scipy", lambda _p: None)
    if mode == "numpy":
        monkeypatch.setattr(native, "DISABLE", True)
        monkeypatch.setattr(jnative, "DISABLE", True)
        monkeypatch.setattr(native, "build", _no_build)
    *got, got_shape = exp_util.mtx_read(path)
    *want, want_shape = jexp_util.mtx_read(path)
    assert tuple(got_shape) == tuple(want_shape)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _no_build():
    raise AssertionError("the numpy path must not reach the C++ parser")


def test_the_native_path_is_the_cpp_parser(tmp_path, monkeypatch):
    path = _write(tmp_path, "general", "plain")
    monkeypatch.setattr(exp_util, "_mmread_scipy", lambda _p: None)
    calls = []
    parser = native.get_mtxparse()
    monkeypatch.setattr(native, "get_mtxparse", lambda: calls.append(1) or parser)
    rows, cols, vals, shape = exp_util.mtx_read(path)
    assert calls == [1] and shape == (4, 5) and len(rows) == 6
    np.testing.assert_array_equal(vals, [1.5, -0.225, 3.0, 7.125, -1000.0, 0.1])


# ---------------------------------------------------------------------------
# The build: no silent fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(("cxx", "match"), [("no-such-c++-compiler-here", "was not found"),
                                            ("false", r"failed \(exit 1\)")])
def test_a_failed_build_raises(tmp_path, monkeypatch, cxx, match):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        native.build()
    assert not list(tmp_path.iterdir())


def test_a_failed_build_never_falls_back_to_numpy(tmp_path, monkeypatch):
    path = _write(tmp_path, "general", "plain")
    monkeypatch.setattr(native, "_parser", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "no-such-c++-compiler-here")
    monkeypatch.setattr(exp_util, "_mmread_scipy", lambda _p: None)
    with pytest.raises(RuntimeError, match="was not found"):
        native.get_mtxparse()
    with pytest.raises(RuntimeError, match="was not found"):
        exp_util.mtx_read(path)
    monkeypatch.setattr(native, "DISABLE", True)
    assert native.get_mtxparse() is None
    assert exp_util.mtx_read(path)[3] == (4, 5)


def test_a_compile_error_carries_the_compilers_output(tmp_path, monkeypatch):
    source = tmp_path / "broken.cc"
    source.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", source)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cc") as err:
        native.build()
    assert "error" in str(err.value)


# ---------------------------------------------------------------------------
# The study
# ---------------------------------------------------------------------------


def _jax_study():
    spec = importlib.util.spec_from_file_location("_mtx_parser_benchmark", JAX_STUDY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(("n", "per_row", "seed"), [(50, 3, 0), (300, 8, 4)])
def test_synth_mtx_writes_the_jax_scripts_bytes(tmp_path, n, per_row, seed):
    size = mtx_parser.synth_mtx(tmp_path / "port.mtx", n, per_row, seed=seed)
    want = _jax_study().synth_mtx(tmp_path / "jax.mtx", n, per_row, seed=seed)
    assert size == want
    assert (tmp_path / "port.mtx").read_bytes() == (tmp_path / "jax.mtx").read_bytes()


def test_the_study_gives_one_csr_on_three_paths(tmp_path):
    scipy_reader = exp_util._mmread_scipy
    result = mtx_parser.main(["--n", "2000", "--nnz_per_row", "8", "--out", str(tmp_path / "mtx.json")])
    assert exp_util._mmread_scipy is scipy_reader and native.DISABLE is False
    assert set(result["seconds"]) == set(mtx_parser.PATHS) == set(result["mb_per_s"])
    assert result["nnz"] == result["csr"].nnz <= 16_000 and result["csr"].shape == (2000, 2000)
    # The same file through the JAX loader's scipy path gives the same CSR.
    (tmp_path / "synth").mkdir()
    mtx_parser.synth_mtx(tmp_path / "synth/synth.mtx", 2000, 8)
    want = jexp_util.suite_sparse_load("synth", path=str(tmp_path))
    got = result["csr"]
    assert got.shape == want.shape and np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices) and got.data.tobytes() == want.data.tobytes()
    saved = json.loads((tmp_path / "mtx.json").read_text())
    assert saved["nnz"] == result["nnz"] and saved["file_bytes"] == result["file_bytes"]
    assert set(saved["mb_per_s"]) == set(mtx_parser.PATHS)


def test_the_study_restores_its_switches_when_a_path_fails(monkeypatch):
    scipy_reader = exp_util._mmread_scipy

    def failing():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "get_mtxparse", failing)
    with pytest.raises(RuntimeError, match="no compiler"):
        mtx_parser.run(200, 2)
    assert exp_util._mmread_scipy is scipy_reader and native.DISABLE is False
