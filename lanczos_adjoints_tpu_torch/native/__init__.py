"""Host (C++) parts of the port, compiled at first use.

``mtxparse.cc``: the MatrixMarket body parser that
``utils.exp_util._mtx_read_builtin`` reads a ``.mtx`` file's entries
with, one ``strtol``/``strtol``/``strtod`` sweep over the text. It is
compiled by the host C++ compiler (``CXX``, ``c++ -O2 -shared -fPIC
-std=c++17``) at the first call into ``_build/libmtxparse-<digest>.so``
beside the CUDA kernels' libraries, ``<digest>`` a hash of the source
and the flags, and loaded with ``ctypes``; its C entry point fills numpy
buffers allocated here. Nothing is compiled when the module is imported.

A failed build raises with the compiler's output: there is no silent
fallback. ``DISABLE = True`` makes ``get_mtxparse()`` return None, and
only then does ``utils.exp_util`` parse the body with numpy.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "mtxparse.cc"
BUILD_DIR = _HERE.parent / "_build"
CXX = "c++"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# Set True to take the numpy body parser instead (benchmarking / debugging).
DISABLE = False

_parser = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmtxparse-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``SOURCE`` with ``CXX`` unless its library is there; return the library's path.

    Raises ``RuntimeError`` if the compiler is missing or fails, with its output.
    """
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except FileNotFoundError as err:
        msg = f"the host C++ compiler {cmd[0]!r} was not found; {SOURCE.name} cannot be built"
        raise RuntimeError(msg) from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        msg = f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    os.replace(tmp, target)
    return target


class MtxParse:
    """The compiled parser: ``parse_body(text, nnz, has_values)``."""

    def __init__(self, path):
        self.path = Path(path)
        fn = ctypes.CDLL(str(self.path)).lat_mtx_parse_body
        fn.restype = ctypes.c_longlong
        fn.argtypes = (ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
        self._fn = fn

    def parse_body(self, text: str, nnz: int, has_values: bool):
        """The body ``text`` -> ``(rows int64, cols int64, vals float64)`` of
        ``nnz`` entries, zero-based; ``vals`` are ones where ``has_values`` is
        false. Raises ``ValueError`` if the body holds fewer than ``nnz`` entries."""
        data = text.encode()
        nnz = int(nnz)
        rows, cols = np.empty(nnz, np.int64), np.empty(nnz, np.int64)
        vals = np.empty(nnz, np.float64)
        count = self._fn(data, len(data), nnz, int(bool(has_values)),
                         rows.ctypes.data, cols.ctypes.data, vals.ctypes.data)
        if count != nnz:
            msg = f"parsed {count} entries, header promised {nnz}"
            raise ValueError(msg)
        return rows, cols, vals


def get_mtxparse():
    """The compiled parser, built at the first call; None while ``DISABLE`` is set.

    Raises ``RuntimeError`` if the build fails.
    """
    global _parser
    if DISABLE:
        return None
    if _parser is None:
        _parser = MtxParse(build())
    return _parser
