"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all of
them started together) into ``_build/lib<name>-<digest>.so`` for
``sm_90a`` and loaded with ``ctypes``. ``<digest>`` hashes every source
and the flags, so an edited source is never served from a stale library.
The build happens at the first launch of a kernel (or on
``build_all()``); nothing is compiled when a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
SOURCES = ("gram_matvec", "gram_grads")
FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# Every C entry point returns a cudaError_t as int (0 = success).
_SIGNATURES = {
    "gram_matvec": {"lat_gram_matvec": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _P)},
    "gram_grads": {"lat_gram_grads": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)},
}

_loaded = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    msg = "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
    raise RuntimeError(msg)


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (empty if all were built already). Raises ``RuntimeError`` with the
    compiler's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    reports, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, target)
        reports[name] = output
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = f"{what} failed with CUDA error {status}"
        raise RuntimeError(msg)
