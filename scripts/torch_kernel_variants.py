"""Time design variants of the port's K1 and K10 kernels side by side on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 scripts/torch_kernel_variants.py``. Each variant is the
kernel's source under ``lanczos_adjoints_tpu_torch/csrc/`` with one
constant replaced, compiled into its own library in a temporary
directory; the package's own build is left alone. It prints each
variant's register count and time beside the chosen one's:

- K1 (``gram_matvec.cu``): 2 m-tiles of 16 rows a warp (the kernel) or
  4, at N = M = 400,000 and 50,000 x 400,000, d = 8, m = 1 and 15,
  CUDA events, each result held to the plain version on its first rows;
- K10 (``bsr.cu``): 1, 2 (the kernel) or 4 float4 loads in flight a lane,
  at 4, 8 and 16 lanes a row, on the FEM test matrix (grid 24), device
  time from the profiler with 8 rotating vectors (warm) and with the L2
  flushed before each call (cold), beside cuSPARSE CSR under both.

``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive``) also builds that commit's ``gram_matvec.cu`` and
``bsr.cu`` and times them against this tree's on the same card, in the
order parent, this, this, parent.
"""

import ctypes
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_bsr, native  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_gram as fg  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32  # noqa: E402
from lanczos_adjoints_tpu_torch.utils.timing import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(source, edits, workdir):
    """``source`` with each ``(old, new)`` replaced, compiled and loaded."""
    text = (native.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source}: {old!r} not found")
        text = text.replace(old, new)
    for header in native.CSRC.glob("*.cuh"):
        (workdir / header.name).write_text(header.read_text())
    (workdir / source).write_text(text)
    lib = workdir / "lib.so"
    out = subprocess.run([native._nvcc(), *native.FLAGS, "-o", str(lib), str(workdir / source)],
                         capture_output=True, text=True, check=True)
    regs = sorted({line.split("Used ")[1].split(",")[0] for line in out.stdout.splitlines()
                   + out.stderr.splitlines() if "Used " in line})
    return ctypes.CDLL(str(lib)), regs


def k1_variants(tmp, n=400_000):
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = fg.kernel_rows(torch.randn((n, 8), generator=g, device="cuda"),
                        torch.full((8,), 0.9, device="cuda"), "matern32")
    vs = {m: torch.randn((n, m), generator=g, device="cuda") for m in (1, 15)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = {
        "2 m-tiles a warp (the kernel)": (2, []),
        "4 m-tiles a warp": (4, [("constexpr int R = 2;                    // m-tiles",
                                  "constexpr int R = 4;                    // m-tiles"),
                                 ("__launch_bounds__(kThreads, kBlocksPerSM)\n    gram_matvec_kernel_reg",
                                  "__launch_bounds__(kThreads)\n    gram_matvec_kernel_reg")]),
    }
    for i, (label, (tiles, edits)) in enumerate(variants.items()):
        lib, regs = build("gram_matvec.cu", edits, tmp / f"k1_{i}")
        fn = lib.lat_gram_matvec
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        rows_per_block = 64 * tiles
        print(f"K1 {label}: registers {regs}", flush=True)
        for rows in (n, 50_000):
            for m in (1, 15):
                # The kernel's split rule, on this variant's count of row blocks.
                blocks = -(-rows // rows_per_block)
                splits = fg.column_splits(blocks * fg.K1_ROWS, n, sms)
                out = torch.empty((rows, m), device="cuda")
                part = torch.empty((splits, rows, m), device="cuda")

                def run(rows=rows, m=m, out=out, part=part, blocks=blocks, splits=splits):
                    counters = torch.zeros(blocks, dtype=torch.int32, device="cuda")
                    native.check(fn(2, xs.data_ptr(), xs.data_ptr(), vs[m].data_ptr(), out.data_ptr(),
                                    part.data_ptr(), counters.data_ptr(), rows, n, m, 8, splits,
                                    torch.cuda.current_stream().cuda_stream), "variant")

                run()
                ms = events_ms(run, 2)
                err = cs._rel_err(out[:2048], fg.gram_matvec_plain("matern32", xs[:2048], xs, vs[m]))
                print(f"  {rows} x {n} m={m}, {splits} column segments: {ms:.3f} ms, "
                      f"rel err {err:.2e} (first 2,048 rows)", flush=True)


def k10_variants(tmp):
    mat, bsr, tiles = cs._fem()
    pack = fused_bsr.BsrPacker(bsr)(tiles)
    n = mat.shape[0]
    vs = [torch.randn(n, device="cuda") for _ in range(cs.ROTATE_SETS)]
    csr = torch.sparse_csr_tensor(
        torch.tensor(mat.indptr, device="cuda"), torch.tensor(mat.indices, device="cuda"),
        torch.tensor(mat.data, dtype=torch.float32, device="cuda"), size=mat.shape)
    flush = torch.zeros(cs.FLUSH_BYTES // 4, device="cuda")
    out = torch.empty(n, device="cuda")
    for unroll in (1, 2, 4):
        lib, regs = build("bsr.cu", [("constexpr int kUnroll = 2;", f"constexpr int kUnroll = {unroll};")],
                          tmp / f"k10_{unroll}")
        fn = lib.lat_bsr_spmv
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
        for lanes in (4, 8, 16):
            def run(v, lanes=lanes, fn=fn):
                native.check(fn(pack.vals.data_ptr(), pack.cols.data_ptr(), pack.row_ptr.data_ptr(),
                                v.data_ptr(), out.data_ptr(), n, lanes,
                                torch.cuda.current_stream().cuda_stream), "variant")

            run(vs[0])
            err = cs._rel_err(out, csr @ vs[0])
            cycle = itertools.cycle(vs)
            _wall, kernels, _counts = cs._profiled(lambda: [run(next(cycle)) for _ in range(64)])
            warm = cs._per_launch_ms(kernels, "bsr_csr_spmv_kernel")
            events, cold = cs._cold_ms(lambda: run(vs[0]), 20, flush, "bsr_csr_spmv_kernel")
            print(f"K10 {unroll} float4 in flight, {lanes} lanes a row (registers {regs}): warm "
                  f"{1e3 * warm:.2f} us, cold {1e3 * cold:.2f} us on the device ({1e3 * events:.2f} us by "
                  f"events), rel err vs cuSPARSE {err:.1e}", flush=True)
    cycle = itertools.cycle(vs)
    _wall, kernels, _counts = cs._profiled(lambda: [csr @ next(cycle) for _ in range(64)])
    warm = sum(t for _c, t in kernels.values()) / 64
    cold, _none = cs._cold_ms(lambda: csr @ vs[0], 20, flush)
    print(f"cuSPARSE CSR: warm {1e3 * warm:.2f} us on the device, cold {1e3 * cold:.2f} us by events",
          flush=True)


def build_parent(parent, source, workdir):
    """The parent commit's ``source``, compiled and loaded."""
    csrc = parent / "lanczos_adjoints_tpu_torch" / "csrc"
    lib = workdir / "lib.so"
    subprocess.run([native._nvcc(), *native.FLAGS, "-o", str(lib), str(csrc / source)],
                   capture_output=True, text=True, check=True)
    return ctypes.CDLL(str(lib))


def parent_comparison(tmp, parent, n=400_000):
    """K1 at N = M = 400,000 (m = 1, 15) and K10 on the FEM matrix (warm and
    cold): the parent's kernels and this tree's, parent, this, this, parent."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    old_k1 = build_parent(parent, "gram_matvec.cu", tmp / "parent_k1").lat_gram_matvec
    old_k1.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = fg.kernel_rows(torch.randn((n, 8), generator=g, device="cuda"),
                        torch.full((8,), 0.9, device="cuda"), "matern32")
    for m in (1, 15):
        v = torch.randn((n, m), generator=g, device="cuda")
        out = torch.empty((n, m), device="cuda")
        runs = {
            "parent": lambda v=v, m=m, out=out: native.check(old_k1(
                2, xs.data_ptr(), xs.data_ptr(), v.data_ptr(), out.data_ptr(), n, n, m, 8, stream()), "parent"),
            "this": lambda v=v: fg.gram_matvec_rows("matern32", xs, xs, v),
        }
        for label in ("parent", "this"):
            runs[label]()
        times = [(label, events_ms(runs[label], 2)) for label in ("parent", "this", "this", "parent")]
        print(f"K1 {n} x {n} m={m}: " + ", ".join(f"{label} {ms:.3f} ms" for label, ms in times)
              + f"; clocks {cs._clocks()}", flush=True)

    old_k10 = build_parent(parent, "bsr.cu", tmp / "parent_k10").lat_bsr_spmv
    old_k10.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    mat, bsr, tiles = cs._fem()
    pack = fused_bsr.BsrPacker(bsr)(tiles)
    vs = [torch.randn(mat.shape[0], device="cuda") for _ in range(cs.ROTATE_SETS)]
    out = torch.empty(mat.shape[0], device="cuda")
    nbr = bsr.padded_n // bsr.tile_rows
    runs = {
        "parent": (lambda v: native.check(old_k10(
            tiles.data_ptr(), bsr.block_cols.data_ptr(), v.data_ptr(), out.data_ptr(), nbr, bsr.width,
            mat.shape[0], mat.shape[1], stream()), "parent"), "bsr_spmv_kernel"),
        "this": (lambda v: fused_bsr.bsr_spmv_packed(pack, v), "bsr_csr_spmv_kernel"),
    }
    flush = torch.zeros(cs.FLUSH_BYTES // 4, device="cuda")
    for label in ("parent", "this", "this", "parent"):
        run, symbol = runs[label]
        run(vs[0])
        cycle = itertools.cycle(vs)
        _wall, kernels, _counts = cs._profiled(lambda run=run, cycle=cycle: [run(next(cycle)) for _ in range(64)])
        warm = cs._per_launch_ms(kernels, symbol)
        events, cold = cs._cold_ms(lambda run=run: run(vs[0]), 20, flush, symbol)
        print(f"K10 FEM {label}: warm {1e3 * warm:.2f} us, cold {1e3 * cold:.2f} us on the device "
              f"({1e3 * events:.2f} us by events)", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card_line(), flush=True)
    pin_float32()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("k1_0", "k1_1", "k10_1", "k10_2", "k10_4", "parent_k1", "parent_k10"):
            (tmp / sub).mkdir()
        if len(argv) == 2 and argv[0] == "--parent":
            parent_comparison(tmp, Path(argv[1]))
        k1_variants(tmp)
        k10_variants(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
