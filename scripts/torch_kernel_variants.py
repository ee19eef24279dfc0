"""Time design variants of the port's K1, K2, K3 and K10 kernels side by side on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 scripts/torch_kernel_variants.py [--only k1,k2,k3,k10] [--parent DIR]``
(all four kernels unless ``--only`` names some). Each variant is the
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
  flushed before each call (cold), beside cuSPARSE CSR under both;
- K2 (``gram_grads.cu``): the kernel (12 warps, U resident), U re-staged
  per tile, 16 warps a block, 8 warps (two blocks an SM with U re-staged,
  one with U resident), the epilogue in one pass over a warp's 4 n-tiles
  instead of two of 2, 3 pipeline stages, the full-precision
  transcendentals (expf, sqrtf) and 64 rows a block, at N = M = 400,000, d = 8,
  matern32, m = 1 and 225, CUDA events with the SM clock, each result
  held to the plain version on the first 2,048 rows; with the registers,
  stack and spill bytes of every instantiation (``-Xptxas -v``). The
  variants compile in parallel;
- K3 (``gram_dgrads.cu``): the kernel (U resident) and U re-staged per
  tile, at the same shapes as K2, each result held to the plain version
  on the first 2,048 rows, with the registers, stack and spill bytes of
  every instantiation.

``--breakdown`` times K2 at m = 225 and K3 at m = 1 and 225 instead of
their variants, with parts of their work cut out (K3's moments; the
epilogue; then also the V copies, the contraction, both, or the TF32
split), to show where their time goes.

``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive``) also builds that commit's ``gram_matvec.cu``,
``gram_grads.cu``, ``gram_dgrads.cu`` and ``bsr.cu`` (those of the
kernels selected) and times them against this tree's on the same card,
in the order parent, this, this, parent. The parent's K2 and K3 get m
unpadded.
"""

import argparse
import ctypes
import itertools
import re
import subprocess
import sys
import tempfile
import time
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


_KINDS = ("rbf", "matern12", "matern32")


def ptxas_table(report, kernel="gram_grads_kernel"):
    """``[(instantiation, registers, stack, spill stores, spill loads)]`` of
    each instantiation of the Gram kernel ``kernel`` (K2's or K3's) in an
    ``nvcc -Xptxas -v`` report."""
    entry = re.compile(kernel + r"ILi(\d+)ELi(\d+)ELb([01])E")
    rows, current, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            match = entry.search(line)
            current = None
            if match:
                kind, width, one = int(match[1]), int(match[2]), match[3] == "1"
                current = f"{_KINDS[kind]} d={width or 'wide'} {'m=1' if one else 'm>1'}"
            frame = (0, 0, 0)
        elif current and "bytes stack frame" in line:
            frame = tuple(int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif current and "Used" in line and "registers" in line:
            rows.append((current, int(re.search(r"Used (\d+) registers", line)[1]), *frame))
            current = None
    return rows


def build_parallel(jobs):
    """``{label: (source path, workdir)}`` compiled together, one nvcc each ->
    ``{label: (library, ptxas report)}``."""
    procs = {}
    for label, (source, workdir) in jobs.items():
        lib = workdir / "lib.so"
        procs[label] = (subprocess.Popen([native._nvcc(), *native.FLAGS, "-o", str(lib), str(source)],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for label, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc failed\n{report}")
        built[label] = (ctypes.CDLL(str(lib)), report)
    return built


def edited_source(source, edits, workdir):
    """``source`` with each ``(old, new)`` replaced, and the headers, in ``workdir``."""
    text = (native.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source}: {old!r} not found")
        text = text.replace(old, new)
    workdir.mkdir(parents=True, exist_ok=True)
    for header in native.CSRC.glob("*.cuh"):
        (workdir / header.name).write_text(header.read_text())
    (workdir / source).write_text(text)
    return workdir / source


def k2_runner(fn, rows_per_block, xs, ys, v, u, pad=True):
    """A closure that launches one K2 library's ``lat_gram_grads`` (matern32)
    and returns its (1 + D,) totals; ``pad`` widens u and v to a multiple
    of 4 columns, as the wrapper does for this tree's kernel."""
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    if v.shape[1] > 1 and v.shape[1] % 4 and pad:  # as gram_grads_rows pads for the kernel
        v, u = (torch.nn.functional.pad(a, (0, -v.shape[1] % 4)) for a in (v, u))
    n, width = xs.shape
    part = torch.empty((-(-n // rows_per_block), 1 + width), device="cuda")

    def run():
        native.check(fn(2, xs.data_ptr(), ys.data_ptr(), v.data_ptr(), u.data_ptr(), part.data_ptr(), n,
                        ys.shape[0], v.shape[1], width, torch.cuda.current_stream().cuda_stream), "K2")
        return part.sum(dim=0)

    return run


def _gram_data(n, plain=fg.gram_grads_plain):
    """Rows, (v, u) at m = 1 and 225, and ``plain`` (K2's or K3's plain
    version) on the first rows, at N = M = n, d = 8, matern32."""
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = fg.kernel_rows(torch.randn((n, 8), generator=g, device="cuda"),
                        torch.full((8,), 0.9, device="cuda"), "matern32")
    data = {m: (torch.randn((n, m), generator=g, device="cuda"), torch.randn((n, m), generator=g, device="cuda"))
            for m in (1, 225)}
    check_rows = 2048
    want = {m: plain("matern32", xs[:check_rows], xs, v, u[:check_rows]) for m, (v, u) in data.items()}
    return xs, data, want, check_rows


def k2_variants(tmp, n=400_000):
    xs, data, want, check_rows = _gram_data(n)
    restage = ("kResidentU = true;", "kResidentU = false;")
    variants = {
        "the kernel": (128, []),
        "U re-staged per tile": (128, [restage]),
        "16 warps a block (128 x 128 tiles)": (128, [("kWarps = 12;", "kWarps = 16;")]),
        "8 warps a block, 2 blocks an SM, U re-staged": (128, [("kWarps = 12;", "kWarps = 8;"),
                                                                ("kBlocksPerSM = 1;", "kBlocksPerSM = 2;"), restage]),
        "8 warps a block, U resident": (128, [("kWarps = 12;", "kWarps = 8;")]),
        "one epilogue pass over the 4 n-tiles": (128, [("kNH = 2;", "kNH = 4;")]),
        "3 stages": (128, [("kStages = 2;", "kStages = 3;")]),
        "full-precision transcendentals": (128, [("kFastMath = true;", "kFastMath = false;")]),
        "64 rows a block": (64, [("constexpr int kR = 2; ", "constexpr int kR = 1; ")]),
    }
    jobs = {label: (edited_source("gram_grads.cu", edits, tmp / f"k2_{i}"), tmp / f"k2_{i}")
            for i, (label, (_rows, edits)) in enumerate(variants.items())}
    start = time.perf_counter()
    built = build_parallel(jobs)
    print(f"K2: {len(built)} variants compiled in {time.perf_counter() - start:.1f} s", flush=True)
    for label, (rows, _edits) in variants.items():
        lib, report = built[label]
        table = ptxas_table(report)
        shown = table if label == "the kernel" else [r for r in table if r[0].startswith(("matern32 d=8 ",
                                                                                            "matern32 d=64 "))]
        print(f"K2 {label}: " + "; ".join(f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B"
                                         for name, regs, stack, st, ld in shown), flush=True)
        if label == "the kernel":
            spills = [r[0] for r in table if (r[3] or r[4]) and "wide" not in r[0]]
            print(f"  instantiations with spills at d <= 64: {spills or 'none'}", flush=True)
        for m, (v, u) in data.items():
            got = k2_runner(lib.lat_gram_grads, rows, xs[:check_rows], xs, v, u[:check_rows])()
            err = cs._rel_err(got, want[m])
            run = k2_runner(lib.lat_gram_grads, rows, xs, xs, v, u)
            run()
            ms, clocks = cs._events_ms_clocked(run, 2)
            print(f"  {n} x {n} m={m}: {ms:.3f} ms (SM clock, max, power, temperature {clocks}); "
                  f"rel err {err:.2e} on the first {check_rows} rows", flush=True)


# Where K2's and K3's time goes: the kernel with parts of its work cut
# out (results are not the function's; only the times mean something).
_NO_EPILOGUE = [("kernel_values<KIND>(p[r][nh][q], gv, dg);", "gv = p[r][nh][q]; dg = 1.0f;"),
                ("dims_pass<DS, true>(xs, ys, wr, wch, g, t, p, tsum + tid, wsum + warp * (1 + DS), lane);", "")]
# K3: the moments replaced by one sum of the tile's w (which keeps the
# contraction live); then also no distances and no dg.
_K3_NO_MOMENTS = [("    moments_pass<DS>(ys, wc, t, acc, add);",
                   "    { float s = 0.0f; for (const auto& a : acc) for (const auto& b : a) for (float c : b) s += c;"
                   " add(0, s); }")]
_K3_NO_EPILOGUE = _K3_NO_MOMENTS + [("        distances<DS>(xs, ys, wr, wch, g, t, p);", ""),
                                    ("            cell *= kernel_dsq<KIND>(p[r][nh][q]);", "")]
_NO_COPIES = [("      if (resident) stage_chunk(nullptr, v_buf(it), kRows, kRows + kCols, j0, k0);\n"
               "      else stage_chunk(u_buf(it), v_buf(it), 0, kRows + kCols, j0, k0);\n", "")]
_NO_CONTRACTION = [("          if (kp >= m) break;", "          if (kp >= 0) break;")]
_NO_SPLIT = [("for (int q = 0; q < 4; ++q) lat::split_tf32(a[st][q], ahi[st][r][q], alo[st][r][q]);",
              "for (int q = 0; q < 4; ++q) ahi[st][r][q] = alo[st][r][q] = __float_as_uint(a[st][q]);"),
             ("              lat::split_tf32(b[st][0], h0, l0);\n              lat::split_tf32(b[st][1], h1, l1);",
              "              h0 = l0 = __float_as_uint(b[st][0]);\n              h1 = l1 = __float_as_uint(b[st][1]);")]


def breakdown(tmp, kernel, n=400_000):
    """K2 at m = 225, or K3 at m = 1 and 225, at N = M = 400,000, d = 8
    with parts of its work removed."""
    xs, data, _want, _rows = _gram_data(n)
    if kernel == "k2":
        source, ms_, epilogue = "gram_grads.cu", (225,), _NO_EPILOGUE
        cuts = {"the kernel": [], "no epilogue (values and sums)": epilogue}
        runner = lambda lib, v, u: k2_runner(lib.lat_gram_grads, 128, xs, xs, v, u)  # noqa: E731
    else:
        source, ms_, epilogue = "gram_dgrads.cu", (1, 225), _K3_NO_EPILOGUE
        cuts = {"the kernel": [], "no moments": _K3_NO_MOMENTS, "no epilogue (distances, dg and moments)": epilogue}
        runner = lambda lib, v, u: k3_runner(lib.lat_gram_dgrads, xs, xs, v, u)  # noqa: E731
    contraction = {
        "no epilogue, no V copies": epilogue + _NO_COPIES,
        "no epilogue, no contraction": epilogue + _NO_CONTRACTION,
        "no epilogue, no V copies, no contraction": epilogue + _NO_COPIES + _NO_CONTRACTION,
        "no epilogue, no TF32 split": epilogue + _NO_SPLIT,
    }
    cuts.update(contraction)
    jobs = {label: (edited_source(source, edits, tmp / f"{kernel}_cut_{i}"), tmp / f"{kernel}_cut_{i}")
            for i, (label, edits) in enumerate(cuts.items())}
    built = build_parallel(jobs)
    for m in ms_:
        v, u = data[m]
        for label, (lib, _report) in built.items():
            if m == 1 and label in contraction:  # m = 1 has no copies and no contraction
                continue
            run = runner(lib, v, u)
            run()
            ms, clocks = cs._events_ms_clocked(run, 1)
            print(f"{kernel.upper()} breakdown m={m}, {label}: {ms:.3f} ms ({clocks})", flush=True)


def k2_parent(tmp, parent, n=400_000):
    """K2 at N = M = 400,000, d = 8, m = 1 and 225: the parent's kernel
    (64 rows a block) and this tree's wrapper, parent, this, this, parent."""
    xs, data, want, check_rows = _gram_data(n)
    old = build_parent(parent, "gram_grads.cu", tmp / "parent_k2").lat_gram_grads
    for m, (v, u) in data.items():
        runs = {"parent": k2_runner(old, 64, xs, xs, v, u, pad=False),
                "this": lambda v=v, u=u: fg.gram_grads_rows("matern32", xs, xs, v, u)}
        errs = {"parent": cs._rel_err(k2_runner(old, 64, xs[:check_rows], xs, v, u[:check_rows], pad=False)(),
                                      want[m]),
                "this": cs._rel_err(fg.gram_grads_rows("matern32", xs[:check_rows], xs, v, u[:check_rows]),
                                    want[m])}
        for label in ("parent", "this"):
            runs[label]()
        times = []
        for label in ("parent", "this", "this", "parent"):
            ms, clocks = cs._events_ms_clocked(runs[label], 1 if m > 1 else 2)
            times.append(f"{label} {ms:.3f} ms ({clocks})")
        print(f"K2 {n} x {n} m={m}: " + ", ".join(times) + "; rel err on the first "
              f"{check_rows} rows: parent {errs['parent']:.2e}, this {errs['this']:.2e}", flush=True)


def k3_runner(fn, xs, ys, v, u, pad=True):
    """A closure that launches one K3 library's ``lat_gram_dgrads``
    (matern32) and returns its (n, 1 + D) moments; ``pad`` widens u and v
    to a multiple of 4 columns, as the wrapper does for this tree's kernel."""
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    if pad:
        v, u = fg.grads_operands(v, u)
    n, width = xs.shape
    out = torch.empty((n, 1 + width), device="cuda")

    def run():
        native.check(fn(2, xs.data_ptr(), ys.data_ptr(), v.data_ptr(), u.data_ptr(), out.data_ptr(), n,
                        ys.shape[0], v.shape[1], width, torch.cuda.current_stream().cuda_stream), "K3")
        return out

    return run


def k3_variants(tmp, n=400_000):
    """K3 as built (U resident) and with U re-staged per tile, at N = M =
    400,000, d = 8, matern32, m = 1 and 225; the registers, stack and
    spill of every instantiation."""
    xs, data, want, check_rows = _gram_data(n, fg.gram_dgrads_plain)
    variants = {"the kernel": [], "U re-staged per tile": [("kResidentU = true;", "kResidentU = false;")]}
    jobs = {label: (edited_source("gram_dgrads.cu", edits, tmp / f"k3_{i}"), tmp / f"k3_{i}")
            for i, (label, edits) in enumerate(variants.items())}
    start = time.perf_counter()
    built = build_parallel(jobs)
    print(f"K3: {len(built)} variants compiled in {time.perf_counter() - start:.1f} s", flush=True)
    for label, (lib, report) in built.items():
        table = ptxas_table(report, "gram_dgrads_kernel")
        print(f"K3 {label}: {len(table)} instantiations: " + "; ".join(
            f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B" for name, regs, stack, st, ld in table),
            flush=True)
        spills = [r[0] for r in table if r[2] or r[3] or r[4]]
        print(f"  instantiations with stack or spills: {spills or 'none'}", flush=True)
        for m, (v, u) in data.items():
            got = k3_runner(lib.lat_gram_dgrads, xs[:check_rows], xs, v, u[:check_rows])()
            err = cs._rel_err(got, want[m])
            run = k3_runner(lib.lat_gram_dgrads, xs, xs, v, u)
            run()
            ms, clocks = cs._events_ms_clocked(run, 1 if m > 1 else 2)
            print(f"  {n} x {n} m={m}: {ms:.3f} ms (SM clock, max, power, temperature {clocks}); "
                  f"rel err {err:.2e} on the first {check_rows} rows", flush=True)


def k3_parent(tmp, parent, n=400_000):
    """K3 at N = M = 400,000, d = 8, matern32, m = 1 and 225: the parent's
    kernel (m unpadded) and this tree's wrapper, parent, this, this, parent."""
    xs, data, want, check_rows = _gram_data(n, fg.gram_dgrads_plain)
    old = build_parent(parent, "gram_dgrads.cu", tmp / "parent_k3").lat_gram_dgrads
    for m, (v, u) in data.items():
        runs = {"parent": k3_runner(old, xs, xs, v, u, pad=False),
                "this": lambda v=v, u=u: fg.gram_dgrads_rows("matern32", xs, xs, v, u)}
        errs = {"parent": cs._rel_err(k3_runner(old, xs[:check_rows], xs, v, u[:check_rows], pad=False)(),
                                      want[m]),
                "this": cs._rel_err(fg.gram_dgrads_rows("matern32", xs[:check_rows], xs, v, u[:check_rows]),
                                    want[m])}
        for label in ("parent", "this"):
            runs[label]()
        times = []
        for label in ("parent", "this", "this", "parent"):
            ms, clocks = cs._events_ms_clocked(runs[label], 1 if m > 1 else 2)
            times.append(f"{label} {ms:.3f} ms ({clocks})")
        print(f"K3 {n} x {n} m={m}: " + ", ".join(times) + "; rel err on the first "
              f"{check_rows} rows: parent {errs['parent']:.2e}, this {errs['this']:.2e}", flush=True)


def build_parent(parent, source, workdir):
    """The parent commit's ``source``, compiled and loaded."""
    csrc = parent / "lanczos_adjoints_tpu_torch" / "csrc"
    workdir.mkdir(parents=True, exist_ok=True)
    lib = workdir / "lib.so"
    subprocess.run([native._nvcc(), *native.FLAGS, "-o", str(lib), str(csrc / source)],
                   capture_output=True, text=True, check=True)
    return ctypes.CDLL(str(lib))


def _arity(source, symbol):
    """The number of parameters of the C entry point ``symbol`` in ``source``."""
    text = source.read_text()
    params = text[text.index(symbol + "(") + len(symbol) + 1:]
    return params[:params.index(")")].count(",") + 1


def parent_comparison(tmp, parent, n=400_000):
    """K1 at N = M = 400,000 (m = 1, 15) and K10 on the FEM matrix (warm and
    cold): the parent's kernels and this tree's, parent, this, this, parent."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    csrc = parent / "lanczos_adjoints_tpu_torch" / "csrc"
    arity = {name: _arity(csrc / f"{name}.cu", symbol)
             for name, symbol in (("gram_matvec", "lat_gram_matvec"), ("bsr", "lat_bsr_spmv"))}
    if arity != {"gram_matvec": 10, "bsr": 9}:
        print(f"K1/K10 parent comparison skipped: it calls the tile-stream C interfaces (10 and 9 "
              f"arguments), the parent's take {arity}", flush=True)
        return
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="k1,k2,k3,k10", help="comma-separated kernels: k1, k2, k3, k10")
    parser.add_argument("--parent", type=Path, help="a tree of an earlier commit to time against")
    parser.add_argument("--breakdown", action="store_true",
                        help="K2 and K3: time the kernel with parts of its work removed")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= {"k1", "k2", "k3", "k10"}:
        parser.error(f"--only takes k1, k2, k3, k10, got {args.only!r}")
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card_line(), flush=True)
    pin_float32()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("k1_0", "k1_1", "k10_1", "k10_2", "k10_4"):
            (tmp / sub).mkdir()
        if args.parent is not None:
            if "k2" in only:
                k2_parent(tmp, args.parent)
            if "k3" in only:
                k3_parent(tmp, args.parent)
            if only & {"k1", "k10"}:
                parent_comparison(tmp, args.parent)
        if args.breakdown:
            for kernel in ("k2", "k3"):
                if kernel in only:
                    breakdown(tmp, kernel)
        else:
            if "k2" in only:
                k2_variants(tmp)
            if "k3" in only:
                k3_variants(tmp)
        if "k1" in only:
            k1_variants(tmp)
        if "k10" in only:
            k10_variants(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
