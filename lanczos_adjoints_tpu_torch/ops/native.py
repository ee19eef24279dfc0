"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all of
them started together) into ``_build/lib<name>-<digest>.so`` for
``sm_90a`` and loaded with ``ctypes``. ``<digest>`` hashes every source
and the flags, so an edited source is never served from a stale library.
The build happens at the first launch of a kernel (or on
``build_all()``); nothing is compiled when a module is imported.

``Kernel`` binds one C entry point and counts its launches; every
kernel the package defines is registered in ``KERNELS``, the one place
a run reads its launch counts from. ``device_symbol`` is the part of the
``__global__`` function's name that a profiler's kernel names contain,
so that a run can hold the profiler's count to the registry's. While a
profiler records, ``utils.spans`` also counts each launch in the
innermost open span.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from lanczos_adjoints_tpu_torch.utils import spans

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
SOURCES = (
    "gram_matvec", "gram_grads", "gram_dgrads", "dia", "lanczos_dia", "arnoldi_dia", "bsr",
    "halo_dia", "dia_ceiling", "device",
)
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

MAX_PARTITIONS = 64  # kMaxParts in csrc/halo_dia.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
# Every C entry point returns a cudaError_t as int (0 = success).
_SIGNATURES = {
    "gram_matvec": {"lat_gram_matvec": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)},
    "gram_grads": {"lat_gram_grads": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)},
    "gram_dgrads": {"lat_gram_dgrads": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)},
    "dia": {
        "lat_dia_matvec": (_P, _P, _P, _I, _I, _P, _P),
        "lat_dia_dvals": (_P, _P, _P, _I, _I, _P, _P),
    },
    "lanczos_dia": {
        "lat_lanczos_dia_forward": (
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        ),
        "lat_lanczos_dia_adjoint": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
            _I, _I, _I, _I, _I, _P,
        ),
    },
    "arnoldi_dia": {
        "lat_arnoldi_dia_forward": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        ),
    },
    "device": {"lat_device_limits": (_P, _P)},
    "bsr": {"lat_bsr_spmv": (_P, _P, _P, _P, _P, _I, _I, _P)},
    "halo_dia": {
        "lat_halo_dia_matvec": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P),
    },
    "dia_ceiling": {"lat_dia_ceiling": (_P, _P, _P, _I, _I, _I, _P)},
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


# Every kernel of the package, by name, in the order its module was imported.
KERNELS = {}


class Kernel:
    """A CUDA kernel's C entry point and the count of its launches.

    Constructing one registers it in ``KERNELS``. ``launch`` is the only
    place that counts, and it counts only a launch that the C entry point
    reported as accepted.
    """

    def __init__(self, name: str, source: str, symbol: str, *, device_symbol: str | None = None):
        if name in KERNELS:
            msg = f"kernel {name!r} is registered twice"
            raise ValueError(msg)
        self.name = name
        self.source = source
        self.symbol = symbol
        self.device_symbol = device_symbol
        self.launches = 0
        KERNELS[name] = self

    def launch(self, *args) -> None:
        fn = getattr(library(self.source), self.symbol)
        check(fn(*args), self.name)
        self.launches += 1
        spans.launched(self.name)


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launch_counts() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def device_symbols() -> dict:
    return {name: kernel.device_symbol for name, kernel in KERNELS.items()}


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream


def on_card(device) -> bool:
    """Whether ``device`` is a CUDA device: the port's "backend is tpu".

    The dispatch predicates of ``ops.sparse.sparse_operator`` and
    ``krylov.lanczos.tridiag`` read it; the kernel wrappers do not (they
    take the plain version for CPU tensors whatever this returns).
    """
    return torch.device(device).type == "cuda"


def offsets_arg(offsets, n, device="cpu"):
    """DIA offsets as an int32 tensor on ``device``, each taken modulo ``n``
    into [0, n) (as given where ``n`` is None, for the halo kernel).

    The kernels read them from device memory, so any number of diagonals
    runs. Built once for each operator (offsets, n) and device, then served
    from a bounded cache of the most recent operators, so a launch copies
    nothing to the card.
    """
    if not offsets:
        raise ValueError("a DIA operator needs at least one diagonal")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _offsets_tensor(tuple(int(d) for d in offsets), n, device)


@functools.lru_cache(maxsize=64)
def _offsets_tensor(offsets, n, device):
    values = offsets if n is None else tuple(d % n for d in offsets)
    return torch.tensor(values, dtype=torch.int32, device=device)


_DEVICE_LIMITS = {}


def device_limits(device):
    """``(SMs, opt-in shared memory bytes a block)`` of a CUDA device, for
    the launch plans of K6, K7 and K9."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _DEVICE_LIMITS:
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            check(library("device").lat_device_limits(ctypes.addressof(sms), ctypes.addressof(smem)),
                  "lat_device_limits")
        _DEVICE_LIMITS[index] = (sms.value, smem.value)
    return _DEVICE_LIMITS[index]
