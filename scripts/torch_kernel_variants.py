"""Time design variants of the port's K1, K2, K3, K6, K7, K9, K10 and K11 kernels side by side on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 scripts/torch_kernel_variants.py [--only k1,k2,k3,k6,k7,k9,k10,k11] [--parent DIR]``
(all eight kernels unless ``--only`` names some). Each variant is the
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
  every instantiation;
- K9 (``arnoldi_dia.cu``): the kernel as ``launch_plan`` sets it up and
  with other plans derived from it (256 computing threads a block,
  staging buffers of a quarter of the size, so tiles of a quarter of the
  rows; at n = 16,384 the streamed path in place of the resident one) and
  with 3 staging buffers in place of 2; the direct path (the basis read
  from device memory) at every shape, on the 2-D Laplacian
  at (n, K, reortho) = (1,000,000, 90, full), (16,384, 90, none),
  (16,384, 90, full) and (16,384, 250, full), CUDA events, each result
  held to the plain version; with the registers, stack and spill bytes of
  the three paths' instantiations;
- K6 (``lanczos_dia.cu``): the kernel as ``forward_plan`` sets it up,
  without its shared window of x, with 256 threads a block (32 rows a
  thread in registers) and, on the cluster path, on 8 blocks, at
  ``K6_SHAPES`` (K7's below); then the grid path against the cluster path
  of 16 and of 8 blocks on the 128^2, 256^2 and 362^2 Laplacians (the
  cluster plans past the planner's run on a build whose C entry takes
  every cluster instantiation); with the registers, stack and spill bytes
  of its instantiations; and the host's microseconds a K6 launch, in
  parts, at n = 16,384 and 2^20;
- K7 (``lanczos_dia.cu``): the kernel as ``adjoint_plan`` sets it up, with
  all of dvals in device memory, with phase c's rows in chunks of 1, 2,
  4 and 8 (in place of 2, or of 4 where some diagonals of dvals are
  streamed) and with 1024 threads a block, on the 2-D
  Laplacian at n = 1,048,576, 1,000,000 and 16,384 (K = 90) and at
  n = 2^20 on the 2-D 9-point stencil, the 3-D 27-point stencil and 65
  diagonals, CUDA events, each result held to the plain version; with the
  registers, stack and spill bytes of its four instantiations;
- K11 (``halo_dia.cu``): the kernel (4 rows a thread, two diagonals a
  loop iteration) and its variants (one or four diagonals an iteration,
  the vector path in 40 registers, the scalar path without its register
  cap, 8 rows a thread, the offsets read through L1 instead of staged) on
  the plan's grid and on one and two waves of 5 blocks an SM, and 1 row a
  thread on four grids, at the slice's operator (n = 2^20, D = 5, halo
  1,024) over P = 1, 2, 4, 8 partitions, beside K4 and a PyTorch column
  sum of the values on the same 8 rotating operand sets, device time from
  the profiler and events, each result bit for bit against K4; the
  registers, stack and spill bytes of every build's four instantiations;
  and the host's microseconds a call in the wrapper's parts
  (``k11_host``), with ``--parent`` the parent's parts beside them.

``--breakdown`` times K2 at m = 225 and K3 at m = 1 and 225 instead of
their variants, with parts of their work cut out (K3's moments; the
epilogue; then also the V copies, the contraction, both, or the TF32
split), to show where their time goes; K9 at its shapes without
the second-pass dots of sweep B, and (streamed) without the copies; and
K7 at n = 2^20, D = 5, K = 90: the parent tree's kernel (with
``--parent``) as it is, without its dvals read-modify-write, without the
sums of the per-block partials after its grid barriers and without the
values' reads, and this tree's without the dvals update and without the
values' reads; and the parent tree's K11 (``--parent`` needed) at P = 1
and 8 with a plain launch and no wait, without its edge fix-up, without
its send copies, without its ``PartPtrs`` index, and its interior sweep
alone, each build's registers, stack and spill beside this tree's.

``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive``) also builds that commit's ``gram_matvec.cu``,
``gram_grads.cu``, ``gram_dgrads.cu`` and ``bsr.cu`` (those of the
kernels selected) and times them against this tree's on the same card,
in the order parent, this, this, parent. The parent's K2 and K3 get m
unpadded; the parent's K9 (``arnoldi_dia.cu``, launched with this
tree's plan for its 112-float head) runs at K9's four shapes and, where DIR is a
whole checkout, the paths that launch K9 (the Arnoldi VJPs of
``chip_smoke.ARNOLDI_SLICE`` and the per-probe SLQ value and gradient)
run with each tree's own code in a process of its own. The parent's K7
(its occupancy-sized grid, its host offsets) runs at the same shapes but
65 diagonals (more than it takes), parent, this, this, parent, by the profiler's device time and
CUDA events; with DIR a whole checkout the fused Lanczos VJP at 1024^2,
1000^2 and 128^2 runs with each tree's own code in a process of its own.
The parent's K11 (its cooperative launch, receive buffers and flags) runs
at P = 1, 2, 4, 8, parent, this, this, parent; with DIR a whole checkout
each tree's K11 wrapper (host microseconds a call) and the sharded
Lanczos VJP at n = 2^20, K = 30, P = 1, 2, 4, 8 run in a process of
their own.
"""

import argparse
import ctypes
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_arnoldi as fa  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_bsr, native  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_gram as fg  # noqa: E402
from lanczos_adjoints_tpu_torch.ops import fused_lanczos as fl  # noqa: E402
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


K9_SHAPES = ((1_000_000, 90, "full"), (16_384, 90, "none"), (16_384, 90, "full"), (16_384, 250, "full"))


def _k9_data(shapes=K9_SHAPES):
    """``{(n, K, reortho): (offsets, vals, v0, plain result)}`` on the 2-D
    Laplacian, v0 from one seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(5)
    data = {}
    for n, depth, reortho in shapes:
        _mat, dia, vals = cs._laplacian(int(round(n ** 0.5)))
        v0 = torch.randn(n, generator=g, device="cuda")
        want = fa.hessenberg_dia_forward_plain(dia.offsets, vals, v0, depth, reortho)
        data[(n, depth, reortho)] = (dia.offsets, vals, v0, want)
    return data


def _k9_err(got, want):
    return max(cs._rel_err(a, b) for a, b in zip(got, want))


def k9_runner(fn, offsets, vals, v0, depth, reortho, plan):
    """A closure that launches one K9 library's ``lat_arnoldi_dia_forward``
    (this tree's C interface) with ``plan`` and returns (q, H, res, 1/|v0|)."""
    fn.argtypes = list(native._SIGNATURES["arnoldi_dia"]["lat_arnoldi_dia_forward"])
    n = v0.shape[0]
    q, h, res, inv = (torch.empty(shape, device="cuda") for shape in ((depth, n), (depth, depth), (n,), (1,)))
    wbuf, partials = torch.empty((2, n), device="cuda"), torch.empty(plan.partial_floats, device="cuda")
    coefs = torch.empty(plan.coef_floats, device="cuda") if plan.coef_floats else None
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    offs = native.offsets_arg(offsets, n, "cuda")

    def run():
        counter.zero_()
        native.check(fn(vals.data_ptr(), v0.data_ptr(), q.data_ptr(), h.data_ptr(), res.data_ptr(),
                        inv.data_ptr(), wbuf.data_ptr(), partials.data_ptr(), counter.data_ptr(),
                        None if coefs is None else coefs.data_ptr(), n, len(offsets), offs.data_ptr(), depth,
                        int(reortho == "full"), plan.blocks, plan.threads, plan.rows,
                        fa.PATHS.index(plan.path), plan.stage_floats, plan.smem_bytes,
                        torch.cuda.current_stream().cuda_stream), "K9")
        return q, h, res, inv[0]

    return run


def k9_ptxas(report):
    """``[(instantiation, registers, stack, spill stores, spill loads)]`` of K9's three paths."""
    rows, current, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            match = re.search(r"arnoldi_forward_kernelILi([012])E", line)
            current = fa.PATHS[int(match[1])] if match else None
            frame = (0, 0, 0)
        elif current and "bytes stack frame" in line:
            frame = tuple(int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif current and "Used" in line and "registers" in line:
            rows.append((current, int(re.search(r"Used (\d+) registers", line)[1]), *frame))
            current = None
    return rows


def k9_variant(plan, path=None, threads=None, stage_floats=None):
    """``plan`` with another path, computing threads or staging buffers (a
    streamed path taking the buffers that fit unless given), its shared
    bytes recomputed as ``launch_plan`` computes them."""
    path, threads = path or plan.path, threads or plan.threads
    stage = 0
    if path == "streamed":
        budget = native.device_limits("cuda")[1] - fa.SMEM_RESERVE
        stage = stage_floats or fa.stage_floats(plan.depth, threads, plan.rows, budget, plan.num_diags)
    smem = fa._smem_bytes(plan.depth, threads, plan.rows, path, stage, plan.num_diags)
    return dataclasses.replace(plan, path=path, threads=threads, stage_floats=stage, smem_bytes=smem)


def k9_variants(tmp):
    """K9 with ``launch_plan``'s plan and with other plans at ``K9_SHAPES``,
    and the streamed path with 3 staging buffers in place of 2; the
    registers, stack and spill of every instantiation."""
    other = 3 if fa.STAGES == 2 else 2
    stages = {fa.STAGES: [], other: [(f"kStages = {fa.STAGES};", f"kStages = {other};")]}
    built = build_parallel({k: (edited_source("arnoldi_dia.cu", edits, tmp / f"k9_{k}"), tmp / f"k9_{k}")
                            for k, edits in stages.items()})
    for k, (_lib, report) in built.items():
        print(f"K9 with {k} staging buffers: " + "; ".join(
            f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B"
            for name, regs, stack, st, ld in k9_ptxas(report)), flush=True)
    lib = built[fa.STAGES][0]
    sms, smem = native.device_limits("cuda")
    for (n, depth, reortho), (offsets, vals, v0, want) in _k9_data().items():
        base = fa.launch_plan(n, depth, reortho, sms, smem, num_diags=len(offsets))
        plans = {"the plan": (lib, base), "256 threads": (lib, k9_variant(base, threads=256))}
        if base.path == "streamed":
            plans["buffers of a quarter"] = (lib, k9_variant(base, stage_floats=base.stage_floats // 16 * 4))
            default = fa.STAGES
            fa.STAGES = other  # the plan of the kernel built with the other number of buffers
            try:
                plans[f"{other} staging buffers"] = (built[other][0], fa.launch_plan(
                    n, depth, reortho, sms, smem, num_diags=len(offsets)))
            finally:
                fa.STAGES = default
        else:
            plans["the streamed path"] = (lib, k9_variant(base, path="streamed"))
        plans["the direct path"] = (lib, k9_variant(base, path="direct"))
        for label, (variant, plan) in plans.items():
            run = k9_runner(variant.lat_arnoldi_dia_forward, offsets, vals, v0, depth, reortho, plan)
            err = _k9_err(run(), want)
            ms, clocks = cs._events_ms_clocked(run, 5 if n > 100_000 else 20)
            print(f"K9 n={n} K={depth} {reortho}, {label} ({plan.path}, {plan.blocks} x {plan.block_threads}, "
                  f"tile rows {plan.tile_rows(0)}..{plan.tile_rows(depth - 1)}): {ms:.4f} ms ({clocks}); "
                  f"rel err {err:.2e}", flush=True)


# Where K9's time goes: the kernel with parts of its work cut out
# (results are not the function's; only the times mean something).
_K9_NO_DOTS_B = [("      if (full) {\n        sync_workers(threads);\n        tile_dots(tile, ld, nullptr, w_out,",
                  "      if (false) {\n        sync_workers(threads);\n        tile_dots(tile, ld, nullptr, w_out,")]
_K9_NO_COPIES = [("mbar_expect_tx(bar, static_cast<unsigned>(floats * 4));", "mbar_expect_tx(bar, 0u);"),
                 ("bulk_copy(dst, src, static_cast<unsigned>(len * 4), bar);", "(void)bar;"),
                 ("bulk_copy(dst + done, prev + pos, static_cast<unsigned>(part * 4), bar);", ""),
                 ("for (int r = lane; r < len; r += 32) lat::cp_async4(dst + r, src + r, true);",
                  "(void)src; (void)dst;"),
                 ("lat::cp_async4(dst + r, prev + lat::wrap(lat::wrap(g0, r, n), d, n), true);", "")]
_K9_NO_COMPUTE = [("                          int count, float* acc, int threads) {\n",
                   "                          int count, float* acc, int threads) {\n  return;\n"),
                  ("                             float* w_out, float* wg, int len, float* red, int threads) {\n",
                   "                             float* w_out, float* wg, int len, float* red, int threads) {\n"
                   "  return 0.0f;\n"),
                  ("        for (int r = tid; r < len; r += threads) {\n          const int row = g0 + r;",
                   "        for (int r = tid; r < 0; r += threads) {\n          const int row = g0 + r;"),
                  ("        for (int r = tid; r < len; r += threads) {\n          const float qv = guarded_div(win[r], norm);",
                   "        for (int r = tid; r < 0; r += threads) {\n          const float qv = guarded_div(win[r], norm);")]
_K9_NO_SUMS = [("                           int threads) {\n  constexpr int kBatch = 4;\n",
                "                           int threads) {\n  return;\n  constexpr int kBatch = 4;\n")]


def k9_breakdown(tmp):
    cuts = {"the kernel": [], "no second-pass dots in sweep B": _K9_NO_DOTS_B, "no copies": _K9_NO_COPIES,
            "no compute (matvec, dots, updates)": _K9_NO_COMPUTE,
            "no compute, no copies": _K9_NO_COMPUTE + _K9_NO_COPIES,
            "no compute, no copies, no coefficient sums": _K9_NO_COMPUTE + _K9_NO_COPIES + _K9_NO_SUMS}
    built = build_parallel({label: (edited_source("arnoldi_dia.cu", edits, tmp / f"k9_cut_{i}"),
                                    tmp / f"k9_cut_{i}") for i, (label, edits) in enumerate(cuts.items())})
    sms, smem = native.device_limits("cuda")
    for (n, depth, reortho), (offsets, vals, v0, _want) in _k9_data().items():
        plans = {"": fa.launch_plan(n, depth, reortho, sms, smem, num_diags=len(offsets))}
        if n < 100_000:
            plans[" (streamed path)"] = k9_variant(plans[""], path="streamed")
        for suffix, plan in plans.items():
            for label, (lib, _report) in built.items():
                if "copies" in label and plan.path == "resident" and label != "no compute, no copies, no coefficient sums":
                    continue
                run = k9_runner(lib.lat_arnoldi_dia_forward, offsets, vals, v0, depth, reortho, plan)
                run()
                ms, clocks = cs._events_ms_clocked(run, 5 if n > 100_000 else 20)
                print(f"K9 breakdown n={n} K={depth} {reortho}{suffix}, {label}: {ms:.4f} ms ({clocks})",
                      flush=True)


def _parent_k9_plan(n, depth, reortho, num_diags):
    """The parent's plan: this tree's ``launch_plan`` with the parent's head
    (64 offsets, 32 warp sums, 8 mbarriers: 112 floats, whatever the
    diagonals), the one layout difference between the two."""
    sized_by_diags = fa.head_floats
    fa.head_floats = lambda _num_diags: 112
    try:
        return fa.launch_plan(n, depth, reortho, *native.device_limits("cuda"), num_diags=num_diags)
    finally:
        fa.head_floats = sized_by_diags


def k9_parent(tmp, parent):
    """K9 at ``K9_SHAPES``: the parent's kernel (its plan, its host offsets)
    and this tree's wrapper, parent, this, this, parent."""
    lib = build_parent(parent, "arnoldi_dia.cu", tmp / "parent_k9")
    old = lib.lat_arnoldi_dia_forward
    old.argtypes = [_P] * 9 + [_I, _I, _P] + [_I] * 8 + [_P]
    for (n, depth, reortho), (offsets, vals, v0, want) in _k9_data().items():
        plan = _parent_k9_plan(n, depth, reortho, len(offsets))
        q, h, res, inv = (torch.empty(shape, device="cuda") for shape in ((depth, n), (depth, depth), (n,), (1,)))
        wbuf, partials = torch.empty((2, n), device="cuda"), torch.empty(plan.partial_floats, device="cuda")
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        offs = (ctypes.c_int * len(offsets))(*(int(d) % n for d in offsets))

        def parent_run(q=q, h=h, res=res, inv=inv, wbuf=wbuf, partials=partials, counter=counter, n=n,
                       depth=depth, reortho=reortho, offsets=offsets, offs=offs, vals=vals, v0=v0, plan=plan):
            counter.zero_()
            native.check(old(vals.data_ptr(), v0.data_ptr(), q.data_ptr(), h.data_ptr(), res.data_ptr(),
                             inv.data_ptr(), wbuf.data_ptr(), partials.data_ptr(), counter.data_ptr(), n,
                             len(offsets), offs, depth, int(reortho == "full"), plan.blocks, plan.threads,
                             plan.rows, fa.PATHS.index(plan.path), plan.stage_floats, plan.smem_bytes,
                             torch.cuda.current_stream().cuda_stream), "parent K9")
            return q, h, res, inv[0]

        runs = {"parent": parent_run,
                "this": lambda offsets=offsets, vals=vals, v0=v0, depth=depth, reortho=reortho:
                fa.hessenberg_dia_forward_rows(offsets, vals, v0, depth, reortho)}
        errs = {label: _k9_err(run(), want) for label, run in runs.items()}
        this = fa.launch_plan(n, depth, reortho, *native.device_limits("cuda"), num_diags=len(offsets))
        times = []
        for label in ("parent", "this", "this", "parent"):
            ms, clocks = cs._events_ms_clocked(runs[label], 5 if n > 100_000 else 20)
            times.append(f"{label} {ms:.4f} ms ({clocks})")
        print(f"K9 n={n} K={depth} {reortho} (this: {this.path}, tile rows {this.tile_rows(depth - 1)} at the "
              f"last step; parent: {plan.path}, {plan.tile_rows(depth - 1)}): " + ", ".join(times)
              + f"; rel err against the plain version: parent {errs['parent']:.2e}, this {errs['this']:.2e}",
              flush=True)


# The paths that launch K9, timed by a tree's own chip_smoke.py helpers in a
# process of its own (its own kernel build): each fused VJP of
# ARNOLDI_SLICE (the all-ones cotangent, CUDA events over 5 after a
# warm-up) and the per-probe SLQ value and gradient (phase_slice_slq).
_K9_PATHS = """
import json, sys
import torch
import chip_smoke as cs
from lanczos_adjoints_tpu_torch.ops import sparse
from lanczos_adjoints_tpu_torch.utils import test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import events_ms

pin_float32()
out = {}
for m, kind, depth, reortho in cs.ARNOLDI_SLICE:
    matvec, vals = sparse.sparse_operator(test_util.laplacian_2d(m), device="cuda")
    v0 = torch.ones(m * m, device="cuda")
    estimate = cs._arnoldi_entry(kind, matvec, depth, reortho)
    cs._one_vjp(estimate, v0, vals)
    out[f"{kind} K={depth} {reortho} m={m}"] = events_ms(lambda: cs._one_vjp(estimate, v0, vals), 5)
out["slq value and gradient m=128"] = cs.phase_slice_slq()["ms"]
print("K9PATHS " + json.dumps(out), flush=True)
"""


def k9_paths(parent):
    """The 1000^2 Arnoldi VJP, the 128^2 hessenberg and tridiag(full) VJPs
    and the 128^2 SLQ value and gradient, each tree's own code in a process
    of its own: parent, this, this, parent. ``parent`` is a whole
    checkout of the earlier commit."""
    here = Path(__file__).resolve().parent.parent
    runs = []
    for label, tree in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", _K9_PATHS], cwd=tree, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K9PATHS ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"{label} paths failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(line[0][len("K9PATHS "):])))
    for key in runs[0][1]:
        print(f"K9 path {key}: " + ", ".join(f"{label} {times[key]:.3f} ms" for label, times in runs)
              + f"; clocks {cs._clocks()}", flush=True)


# ---------------------------------------------------------------------------
# K7: the fused Lanczos adjoint
# ---------------------------------------------------------------------------

# K7's operators beside the Laplacian: the 2-D 9-point stencil on the
# 1024^2 grid and the 3-D 27-point one on 128 x 128 x 64 (n = 2^20 each;
# dvals streamed), and a band of 65 diagonals.
K7_BANDS = {
    "9-point": tuple(a + b for a in (-1024, 0, 1024) for b in (-1, 0, 1)),
    "27-point": tuple(a + b + c for a in (-16_384, 0, 16_384) for b in (-128, 0, 128) for c in (-1, 0, 1)),
    "65 diagonals": cs.WIDE_65,
}
K7_SHAPES = ((1 << 20, "laplacian"), (1_000_000, "laplacian"), (16_384, "laplacian"),
             *((1 << 20, kind) for kind in K7_BANDS))
K7_DEPTH = 90


def _k7_data(shapes=K7_SHAPES):
    """``{(n, kind): (offsets, vals, args, plain result)}``: the adjoint's
    inputs from the plain forward on the 2-D Laplacian (v0 seeded) or a
    symmetric operator on one of ``K7_BANDS``, and a seeded cotangent."""
    rng = __import__("numpy").random.default_rng(17)
    data = {}
    for n, kind in shapes:
        if kind == "laplacian":
            _mat, dia, vals = cs._laplacian(int(round(n ** 0.5)))
        else:
            dia, vals = cs._symmetric_dia(rng, K7_BANDS[kind], n)
        v0 = cs._tensor(rng, n)
        xs, alphas, betas = fl.lanczos_forward_plain(dia.offsets, vals, v0, K7_DEPTH)
        cot = cs._cotangent(rng, K7_DEPTH, n)
        args = (xs, alphas, betas, 1.0 / torch.linalg.vector_norm(v0),
                torch.cat([cot[0], cot[3][None]]), cot[1], torch.cat([cot[2], cot[4][None]]))
        data[(n, kind)] = (dia.offsets, vals, args, fl.lanczos_adjoint_plain(dia.offsets, vals, *args))
    return data


def _k7_err(got, want):
    return max(cs._rel_err(a, b) for a, b in zip(got, want))


def k7_runner(fn, offsets, vals, args, plan):
    """A closure that launches one K7 library's ``lat_lanczos_dia_adjoint``
    (this tree's C interface) with ``plan`` and returns (dv, dvals)."""
    fn.argtypes = list(native._SIGNATURES["lanczos_dia"]["lat_lanczos_dia_adjoint"])
    xs, alphas, betas, inv_norm, dxs, dalphas, dbetas = args
    inv_norm = inv_norm.reshape(1)
    n = xs.shape[1]
    dv, dvals, xi, lam = (torch.empty(shape, device="cuda") for shape in ((n,), vals.shape, (n,), (2, n)))
    partials = torch.empty(plan.partial_floats, device="cuda")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    offs = native.offsets_arg(offsets, n, "cuda")

    def run():
        counter.zero_()
        native.check(fn(vals.data_ptr(), xs.data_ptr(), dxs.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
                        dalphas.data_ptr(), dbetas.data_ptr(), inv_norm.data_ptr(), dv.data_ptr(),
                        dvals.data_ptr(), xi.data_ptr(), lam.data_ptr(), partials.data_ptr(),
                        counter.data_ptr(), n, len(offsets), offs.data_ptr(), plan.depth, plan.blocks,
                        plan.threads, plan.rows, plan.resident_diags, plan.smem_bytes,
                        torch.cuda.current_stream().cuda_stream), "K7")
        return dv, dvals

    return run


def k7_ptxas(report):
    """``[(instantiation, registers, stack, spill stores, spill loads)]`` of K7's four instantiations."""
    rows, current, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            match = re.search(r"lanczos_adjoint_kernelILb([01])ELi(\d+)E", line)
            current = (f"{'some' if int(match[1]) else 'no'} diagonals of dvals streamed, state in "
                       f"{'registers' if int(match[2]) else 'device memory'}") if match else None
            frame = (0, 0, 0)
        elif current and "bytes stack frame" in line:
            frame = tuple(int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif current and "Used" in line and "registers" in line:
            rows.append((current, int(re.search(r"Used (\d+) registers", line)[1]), *frame))
            current = None
    return rows


def k7_variant(plan, resident_diags):
    """``plan`` with ``resident_diags`` diagonals of dvals in shared memory,
    its shared bytes recomputed as ``adjoint_plan`` computes them."""
    smem = fl.adjoint_smem_bytes(plan.num_diags, plan.rows, resident_diags)
    return dataclasses.replace(plan, resident_diags=resident_diags, smem_bytes=smem)


_K7_CHUNK = "constexpr int kChunkOnChip = 2, kChunkStreamed = 4;"


def k7_variants(tmp):
    """K7 with ``adjoint_plan``'s plan and with other plans at ``K7_SHAPES``,
    built with phase c's rows in chunks of 1, 2, 4 and 8 in both
    instantiations and with 1024 threads of 8 rows each; registers, stack
    and spill."""
    builds = {"the kernel": [],
              **{f"chunks of {c} rows": [(_K7_CHUNK, f"constexpr int kChunkOnChip = {c}, kChunkStreamed = {c};")]
                 for c in (1, 2, 4, 8)},
             "1024 threads, 8 rows a thread in registers": [
                 ("constexpr int kAdjThreads = 512;", "constexpr int kAdjThreads = 1024;"),
                 ("constexpr int kSlots = 16;", "constexpr int kSlots = 8;")]}
    built = build_parallel({k: (edited_source("lanczos_dia.cu", edits, tmp / f"k7_{i}"), tmp / f"k7_{i}")
                            for i, (k, edits) in enumerate(builds.items())})
    for k, (_lib, report) in built.items():
        print(f"K7 ({k}): " + "; ".join(f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B"
                                        for name, regs, stack, st, ld in k7_ptxas(report)), flush=True)
    lib = built["the kernel"][0]
    for (n, kind), (offsets, vals, args, want) in _k7_data().items():
        base = cs._k7_plan(offsets, n, K7_DEPTH)
        plans = {"the plan": (lib, base)}
        plans.update({f"the plan, {k}": (built[k][0], base) for k in list(builds)[1:-1]})
        # 32 warps' sums (3 x 16 more floats) in the 1024-thread build's layout.
        plans["1024 threads, 8 rows a thread in registers"] = (
            built["1024 threads, 8 rows a thread in registers"][0],
            dataclasses.replace(base, threads=min(1024, -(-base.rows // 32) * 32), smem_bytes=base.smem_bytes + 4 * 48))
        plans["dvals all in device memory"] = (lib, k7_variant(base, 0))
        for label, (variant, plan) in plans.items():
            run = k7_runner(variant.lat_lanczos_dia_adjoint, offsets, vals, args, plan)
            err = _k7_err(run(), want)
            ms, clocks = cs._events_ms_clocked(run, 5 if n > 100_000 else 20)
            print(f"K7 n={n} {kind} K={K7_DEPTH}, {label} ({plan.path} dvals, {plan.resident_diags} of "
                  f"{plan.num_diags} diagonals on chip, state in "
                  f"{plan.state}, {plan.blocks} x {plan.threads}): {ms:.4f} ms ({clocks}); rel err {err:.2e}",
                  flush=True)


# Where the parent's K7 lost its time, and this one's goes: the kernels with
# parts of their work cut out (results are not the function's).
_K7_PARENT_CUTS = {
    "no dvals read-modify-write": [("        dvals[slot] += xval * lj;\n", "        (void)xval;\n")],
    "no sums of the per-block partials": [
        ("    const float s0 = grid_total(part0, red);\n    const float s1 = grid_total(part1, red);\n"
         "    const float s2 = grid_total(part2, red);\n",
         "    const float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;\n")],
    "no values read": [("at_lam = fmaf(vals[slot], lj, at_lam);", "at_lam += lj;")],
}
_K7_CUTS = {
    "no dvals update": [("            s_dvals[static_cast<size_t>(k) * rows + rr[u]] += xv[u] * ll[u];\n",
                         "            (void)xv;\n")],
    "no values read": [("          vv[u] = __ldg(vals + k * nn + row);", "          vv[u] = 1.0f;")],
    "no loop over the diagonals in phase c": [
        ("      for (int k = 0; k < num_diags; ++k) {\n        const int off = s_off[k];\n",
         "      for (int k = 0; k < 0; ++k) {\n        const int off = s_off[k];\n")],
    "no grid barriers (block barriers in their place)": [("grid_sync(counter, goal, threads);",
                                                          "sync_workers(threads);")],
}


def _parent_k7_runner(fn, offsets, vals, args):
    """The parent's ``lat_lanczos_dia_adjoint`` (host offsets, an occupancy-sized grid)."""
    fn.argtypes = [_P] * 13 + [_I, _I, _I, _P, _I, _P]
    xs, alphas, betas, inv_norm, dxs, dalphas, dbetas = args
    inv_norm = inv_norm.reshape(1)
    n = xs.shape[1]
    dv, dvals, xi, lam = (torch.empty(shape, device="cuda") for shape in ((n,), vals.shape, (n,), (2, n)))
    capacity = 3 * 8192
    partials = torch.empty(capacity, device="cuda")
    offs = (ctypes.c_int * len(offsets))(*(int(d) % n for d in offsets))

    def run():
        native.check(fn(vals.data_ptr(), xs.data_ptr(), dxs.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
                        dalphas.data_ptr(), dbetas.data_ptr(), inv_norm.data_ptr(), dv.data_ptr(),
                        dvals.data_ptr(), xi.data_ptr(), lam.data_ptr(), partials.data_ptr(), capacity, n,
                        len(offsets), offs, K7_DEPTH, torch.cuda.current_stream().cuda_stream), "parent K7")
        return dv, dvals

    return run


def _parent_source(parent, source, edits, workdir):
    """The parent tree's ``source`` with each ``(old, new)`` replaced, beside its headers."""
    csrc = parent / "lanczos_adjoints_tpu_torch" / "csrc"
    text = (csrc / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"parent {source}: {old!r} not found")
        text = text.replace(old, new)
    workdir.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (workdir / header.name).write_text(header.read_text())
    (workdir / source).write_text(text)
    return workdir / source


def k7_breakdown(tmp, parent):
    """K7 at (2^20, 5, 90) with parts of its work cut out: the parent's kernel
    (where ``parent`` is given) and this one."""
    jobs = {}
    if parent is not None:
        cuts = {"the parent's kernel": [], **{f"the parent's, {k}": e for k, e in _K7_PARENT_CUTS.items()}}
        for i, (label, edits) in enumerate(cuts.items()):
            jobs[label] = (_parent_source(parent, "lanczos_dia.cu", edits, tmp / f"k7p_cut_{i}"), tmp / f"k7p_cut_{i}")
    for i, (label, edits) in enumerate({"this kernel": [], **{f"this, {k}": e for k, e in _K7_CUTS.items()}}.items()):
        jobs[label] = (edited_source("lanczos_dia.cu", edits, tmp / f"k7_cut_{i}"), tmp / f"k7_cut_{i}")
    built = build_parallel(jobs)
    (offsets, vals, args, _want), = _k7_data(((1 << 20, "laplacian"),)).values()
    plan = cs._k7_plan(offsets, 1 << 20, K7_DEPTH)
    for label, (lib, _report) in built.items():
        if label.startswith("the parent"):
            run = _parent_k7_runner(lib.lat_lanczos_dia_adjoint, offsets, vals, args)
        else:
            run = k7_runner(lib.lat_lanczos_dia_adjoint, offsets, vals, args, plan)
        run()
        ms, clocks = cs._events_ms_clocked(run, 5)
        _wall, kernels, _counts = cs._profiled(lambda run=run: [run() for _ in range(5)])
        device = cs._per_launch_ms(kernels, "lanczos_adjoint_kernel")
        dev = f"{device:.4f} ms on the device, " if device is not None else ""
        print(f"K7 breakdown n={1 << 20} K={K7_DEPTH}, {label}: {dev}{ms:.4f} ms by events ({clocks})", flush=True)


def k7_parent(tmp, parent):
    """K7 at n = 2^20, 1,000,000, 16,384 (the Laplacian, K = 90) and at 2^20 on
    the 9- and 27-point stencils: the parent's kernel and this tree's
    wrapper, parent, this, this, parent, by the profiler's device time and
    CUDA events."""
    lib = build_parent(parent, "lanczos_dia.cu", tmp / "parent_k7")
    shapes = tuple(shape for shape in K7_SHAPES if shape[1] != "65 diagonals")
    for (n, kind), (offsets, vals, args, want) in _k7_data(shapes).items():
        runs = {"parent": _parent_k7_runner(lib.lat_lanczos_dia_adjoint, offsets, vals, args),
                "this": lambda offsets=offsets, vals=vals, args=args: fl.lanczos_adjoint_rows(offsets, vals, *args)}
        errs = {label: _k7_err(run(), want) for label, run in runs.items()}
        reps = 5 if n > 100_000 else 20
        times = []
        for label in ("parent", "this", "this", "parent"):
            ms, clocks = cs._events_ms_clocked(runs[label], reps)
            _wall, kernels, _counts = cs._profiled(lambda run=runs[label]: [run() for _ in range(reps)])
            device = cs._per_launch_ms(kernels, "lanczos_adjoint_kernel")
            dev = f"{device:.4f}" if device is not None else "not measured"
            times.append(f"{label} {dev} ms on the device, {ms:.4f} ms by events ({clocks})")
        print(f"K7 n={n} {kind} K={K7_DEPTH} (this: {cs._k7_plan(offsets, n, K7_DEPTH).path}): " + "; ".join(times)
              + f"; rel err against the plain version: parent {errs['parent']:.2e}, this {errs['this']:.2e}",
              flush=True)


# The fused Lanczos VJP of bench.py's flow, timed by a tree's own code in a
# process of its own: the m x m Laplacian -> sparse_operator -> tridiag
# (K = 90, the dispatch to K6/K7), one VJP with the all-ones cotangent,
# CUDA events over 5 after a warm-up.
_K7_PATHS = """
import json
import torch
import chip_smoke as cs
from lanczos_adjoints_tpu_torch.krylov import lanczos
from lanczos_adjoints_tpu_torch.ops import sparse
from lanczos_adjoints_tpu_torch.utils import test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import events_ms

pin_float32()
out = {}
for m in (1024, 1000, 128):
    matvec, vals = sparse.sparse_operator(test_util.laplacian_2d(m), device="cuda")
    v0 = torch.ones(m * m, device="cuda")
    estimate = lanczos.tridiag(matvec, cs.DEPTH, reortho="none")
    cs._one_vjp(estimate, v0, vals)
    out[f"fused Lanczos VJP m={m}"] = events_ms(lambda: cs._one_vjp(estimate, v0, vals), 5)
print("K7PATHS " + json.dumps(out), flush=True)
"""


def k7_paths(parent):
    """The fused Lanczos VJP at 1024^2, 1000^2 and 128^2, each tree's own code in a
    process of its own: parent, this, this, parent."""
    here = Path(__file__).resolve().parent.parent
    runs = []
    for label, tree in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", _K7_PATHS], cwd=tree, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K7PATHS ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"{label} paths failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(line[0][len("K7PATHS "):])))
    for key in runs[0][1]:
        print(f"K7 path {key}: " + ", ".join(f"{label} {times[key]:.3f} ms" for label, times in runs)
              + f"; clocks {cs._clocks()}", flush=True)


# ---------------------------------------------------------------------------
# K6: the fused Lanczos forward
# ---------------------------------------------------------------------------

# K6's shapes: K7's (the 2-D Laplacian at 2^20, 1,000,000 and 16,384, the
# 9- and 27-point stencils and 65 diagonals at 2^20), K = 90.
K6_SHAPES = K7_SHAPES
# The Laplacians on which the grid and the cluster path are timed against
# each other: 128^2, 256^2 and 362^2 (n = 131,044, the largest square grid
# below 131,072).
K6_CROSSOVER = (128, 256, 362)


def _k6_data(shapes=K6_SHAPES):
    """``{(n, kind): (offsets, vals, v0, plain result)}``: the 2-D Laplacian
    or a symmetric operator on one of ``K7_BANDS``, v0 seeded."""
    rng = __import__("numpy").random.default_rng(18)
    data = {}
    for n, kind in shapes:
        if kind == "laplacian":
            _mat, dia, vals = cs._laplacian(int(round(n ** 0.5)))
        else:
            dia, vals = cs._symmetric_dia(rng, K7_BANDS[kind], n)
        v0 = cs._tensor(rng, dia.shape[0])
        data[(dia.shape[0], kind)] = (dia.offsets, vals, v0, fl.lanczos_forward_plain(dia.offsets, vals, v0, K7_DEPTH))
    return data


def _k6_err(got, want):
    return max(cs._rel_err(a, b) for a, b in zip(got, want))


def k6_runner(fn, offsets, vals, v0, plan, zero_counter=True):
    """A closure that launches one K6 library's ``lat_lanczos_dia_forward``
    (this tree's C interface) with ``plan`` and returns (xs, alphas, betas);
    the grid barrier's counter is zeroed before each launch unless
    ``zero_counter`` is false (the cluster path does not read it)."""
    fn.argtypes = list(native._SIGNATURES["lanczos_dia"]["lat_lanczos_dia_forward"])
    n, depth = v0.shape[0], plan.depth
    xs, coef = torch.empty((depth + 1, n), device="cuda"), torch.empty((2, depth), device="cuda")
    scratch = torch.empty((2, n), device="cuda")
    partials = torch.empty(max(plan.partial_floats, 1), device="cuda")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    offs = native.offsets_arg(offsets, n, "cuda")
    table = torch.tensor(fl.window_table(offsets, n, plan.rows)[1], dtype=torch.int32, device="cuda")

    def run():
        if zero_counter:
            counter.zero_()
        native.check(fn(vals.data_ptr(), v0.data_ptr(), xs.data_ptr(), coef[0].data_ptr(), coef[1].data_ptr(),
                        scratch.data_ptr(), partials.data_ptr(), counter.data_ptr(), n, len(offsets),
                        offs.data_ptr(), table.data_ptr(), depth, int(plan.path == "cluster"), plan.blocks,
                        plan.threads, plan.rows, plan.resident_diags, plan.window, plan.smem_bytes,
                        torch.cuda.current_stream().cuda_stream), "K6")
        return xs, coef[0], coef[1]

    return run


def _parent_k6_runner(fn, offsets, vals, v0):
    """The parent's ``lat_lanczos_dia_forward`` (an occupancy-sized grid, three
    grid barriers a step; offsets as a device array)."""
    fn.argtypes = [_P] * 7 + [_I, _I, _I, _P, _I, _P]
    n = v0.shape[0]
    xs, coef = torch.empty((K7_DEPTH + 1, n), device="cuda"), torch.empty((2, K7_DEPTH), device="cuda")
    work, capacity = torch.empty(n, device="cuda"), 2 * 8192
    partials = torch.empty(capacity, device="cuda")
    offs = native.offsets_arg(offsets, n, "cuda")

    def run():
        native.check(fn(vals.data_ptr(), v0.data_ptr(), xs.data_ptr(), coef[0].data_ptr(), coef[1].data_ptr(),
                        work.data_ptr(), partials.data_ptr(), capacity, n, len(offsets), offs.data_ptr(), K7_DEPTH,
                        torch.cuda.current_stream().cuda_stream), "parent K6")
        return xs, coef[0], coef[1]

    return run


def _timed(run, reps, symbol):
    """``(device ms per launch or None, ms by events, clocks)`` of ``run``."""
    run()
    ms, clocks = cs._events_ms_clocked(run, reps)
    _wall, kernels, _counts = cs._profiled(lambda: [run() for _ in range(reps)])
    return cs._per_launch_ms(kernels, symbol), ms, clocks


def _dev(device):
    return f"{device:.4f}" if device is not None else "not measured"


def k6_parent(tmp, parent):
    """K6 at ``K6_SHAPES``: the parent's kernel and this tree's wrapper,
    parent, this, this, parent, by the profiler's device time and CUDA events."""
    lib = build_parent(parent, "lanczos_dia.cu", tmp / "parent_k6")
    for (n, kind), (offsets, vals, v0, want) in _k6_data().items():
        runs = {"parent": _parent_k6_runner(lib.lat_lanczos_dia_forward, offsets, vals, v0),
                "this": lambda offsets=offsets, vals=vals, v0=v0: fl.lanczos_forward_rows(offsets, vals, v0, K7_DEPTH)}
        errs = {label: _k6_err(run(), want) for label, run in runs.items()}
        reps = 5 if n > 100_000 else 20
        times = []
        for label in ("parent", "this", "this", "parent"):
            device, ms, clocks = _timed(runs[label], reps, "lanczos_forward_kernel")
            times.append(f"{label} {_dev(device)} ms on the device, {ms:.4f} ms by events ({clocks})")
        plan = cs._k6_plan(offsets, n, K7_DEPTH)
        print(f"K6 n={n} {kind} K={K7_DEPTH} (this: {plan.path} path, {plan.resident_diags} of {plan.num_diags} "
              f"diagonals on chip, state in {plan.state}): " + "; ".join(times)
              + f"; rel err against the plain version: parent {errs['parent']:.2e}, this {errs['this']:.2e}",
              flush=True)


def k6_ptxas(report):
    """``[(instantiation, registers, stack, spill stores, spill loads)]`` of K6's instantiations."""
    rows, current, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            match = re.search(r"lanczos_forward_kernelILb([01])ELi(\d+)ELb([01])E", line)
            current = (f"{'cluster' if int(match[1]) else 'grid'} path, state in "
                       f"{f'registers ({match[2]} slots)' if int(match[2]) else 'device memory'}, "
                       f"{'window' if int(match[3]) else 'x from device memory'}") if match else None
            frame = (0, 0, 0)
        elif current and "bytes stack frame" in line:
            frame = tuple(int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif current and "Used" in line and "registers" in line:
            rows.append((current, int(re.search(r"Used (\d+) registers", line)[1]), *frame))
            current = None
    return rows


def _print_ptxas(label, report):
    print(f"K6 ({label}): " + "; ".join(f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B"
                                        for name, regs, stack, st, ld in k6_ptxas(report)), flush=True)


_K6_THREADS = "constexpr int kFwdThreads = 512;"
_K6_SLOTS = "constexpr int kFwdSlots = 16;"
# The C entry opened to every cluster instantiation (16 slots, no window),
# for cluster plans past the planner's: 8 rows a thread or more (65,536,
# 131,044) and x from distributed shared memory without the window.
_K6_OPEN_CLUSTER = [
    ("resident_diags != num_diags || !win || !few", "resident_diags != num_diags || !regs"),
    ("    auto kernel = &lanczos_forward_kernel<true, kFwdFewSlots, true>;",
     "    auto kernel = few ? (win ? &lanczos_forward_kernel<true, kFwdFewSlots, true>\n"
     "                             : &lanczos_forward_kernel<true, kFwdFewSlots, false>)\n"
     "                      : (win ? &lanczos_forward_kernel<true, kFwdSlots, true>\n"
     "                             : &lanczos_forward_kernel<true, kFwdSlots, false>);"),
]
# The C entry making its launch checks (check_forward_launch) on its
# first launch of each path only: what the checks cost the host.
_K6_CHECKS_ONCE = [
    (f"{pad}err = check_forward_launch(kernel, {flag}, blocks, threads, smem);",
     f"{pad}static const cudaError_t once = check_forward_launch(kernel, {flag}, blocks, threads, smem);\n"
     f"{pad}err = once;") for pad, flag in (("    ", "true"), ("  ", "false"))]


def k6_plan_on(path, n, offsets, blocks=fl.CLUSTER_BLOCKS, window=True):
    """K6's plan on ``path`` whatever n: the grid as ``forward_plan`` lays it
    out above ``CLUSTER_MAX_N``; the cluster of ``blocks`` blocks with all
    diagonals of the values on chip, and the window of x where ``window``
    asks for it and it fits (raises ``ValueError`` where the cluster's
    shared memory cannot hold the rest)."""
    sms, smem = native.device_limits("cuda")
    if path == "grid":
        with mock.patch.object(fl, "CLUSTER_MAX_N", 0):
            return fl.forward_plan(n, K7_DEPTH, sms, smem, offsets=offsets)
    num_diags, budget = len(offsets), smem - fl.SMEM_RESERVE
    rows = -(-(-(-n // blocks)) // 4) * 4  # n / blocks rounded up to a multiple of 4
    threads = min(fl.FORWARD_THREADS, -(-rows // 32) * 32)
    floats = fl.window_table(offsets, n, rows)[0] if window else 0
    if fl.forward_smem_bytes(num_diags, rows, num_diags, "cluster", floats) > budget:
        floats = 0
    smem_bytes = fl.forward_smem_bytes(num_diags, rows, num_diags, "cluster", floats)
    if smem_bytes > budget:
        raise ValueError(f"no cluster of {blocks} blocks holds n={n}, {num_diags} diagonals")
    return fl.ForwardPlan(path="cluster", resident_diags=num_diags, window=floats, blocks=blocks, threads=threads,
                          rows=rows, smem_bytes=smem_bytes, partial_floats=0, depth=K7_DEPTH, num_diags=num_diags)


def k6_variants(tmp):
    """K6 with ``forward_plan``'s plan and with other plans at ``K6_SHAPES``
    (without the shared window of x, reading x from device memory; 256
    threads a block with 32 rows a thread in registers; the cluster path on
    8 blocks), then the grid and the cluster path against each other on the
    Laplacians of ``K6_CROSSOVER``; registers, stack and spill; and the
    host's cost of a K6 launch (``k6_host``)."""
    builds = {"the kernel": [],
              "256 threads, 32 rows a thread in registers": [
                  (_K6_THREADS, "constexpr int kFwdThreads = 256;"), (_K6_SLOTS, "constexpr int kFwdSlots = 32;")],
              "the cluster open to every instantiation": _K6_OPEN_CLUSTER,
              "the checks on the first launch only": _K6_CHECKS_ONCE}
    built = build_parallel({k: (edited_source("lanczos_dia.cu", edits, tmp / f"k6_{i}"), tmp / f"k6_{i}")
                            for i, (k, edits) in enumerate(builds.items())})
    for k, (_lib, report) in built.items():
        _print_ptxas(k, report)
    lib, lib256 = built["the kernel"][0], built["256 threads, 32 rows a thread in registers"][0]
    open_lib = built["the cluster open to every instantiation"][0]
    for (n, kind), (offsets, vals, v0, want) in _k6_data().items():
        base = cs._k6_plan(offsets, n, K7_DEPTH)
        plans = {"the plan": (lib, base)}
        if base.window:
            plans["no window (x from device memory)"] = (lib if base.path == "grid" else open_lib, k6_variant(base, 0))
        if base.path == "grid":
            # 256 threads: the block sums of 8 warps, not 16, in the layout.
            plans["256 threads"] = (lib256, dataclasses.replace(
                base, threads=min(256, base.threads), smem_bytes=base.smem_bytes - 4 * 8 * (1 + 2 * 16)))
        else:
            plans["the cluster on 8 blocks"] = (lib, k6_plan_on("cluster", n, offsets, blocks=8))
        for label, (variant, plan) in plans.items():
            _k6_line(n, kind, label, variant, offsets, vals, v0, want, plan)
    for m in K6_CROSSOVER:
        _mat, dia, vals = cs._laplacian(m)
        n, offsets = m * m, dia.offsets
        v0 = cs._tensor(__import__("numpy").random.default_rng(m), n)
        want = fl.lanczos_forward_plain(offsets, vals, v0, K7_DEPTH)
        for label, path, blocks in (("grid", "grid", None), ("cluster of 16", "cluster", 16),
                                    ("cluster of 8", "cluster", 8)):
            try:
                plan = k6_plan_on(path, n, offsets, **({"blocks": blocks} if blocks else {}))
            except ValueError as err:
                print(f"K6 n={n} laplacian K={K7_DEPTH}, {label}: no plan ({err})", flush=True)
                continue
            _k6_line(n, "laplacian", label, open_lib, offsets, vals, v0, want, plan)
    k6_host(lib, built["the checks on the first launch only"][0])


def _host_us(fn, reps=100):
    """Host microseconds a call of ``fn``, the card left to run behind."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - start) / reps * 1e6
    torch.cuda.synchronize()
    return host


def k6_host(lib, lib_checks):
    """The host's cost of one K6 launch at n = 16,384 (the cluster path) and
    2^20 (the grid path), in its parts: ``forward_plan`` made anew and from
    the wrapper's cache, the grid barrier's zeroed counter, the C entry
    (through ctypes) with its launch checks on every launch and
    (``lib_checks``) on the first only, and the whole wrapper."""
    data = _k6_data(((16_384, "laplacian"), (1 << 20, "laplacian")))
    limits = native.device_limits("cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    for (n, _kind), (offsets, vals, v0, _want) in data.items():
        plan = cs._k6_plan(offsets, n, K7_DEPTH)
        key = tuple(int(d) for d in offsets)
        parts = {
            "forward_plan anew": lambda: fl.forward_plan(n, K7_DEPTH, *limits, offsets=offsets),
            "the cached plan": lambda: fl._forward_plan(n, K7_DEPTH, key, device),
            "a zeroed counter": lambda: torch.zeros(1, dtype=torch.int32, device="cuda"),
        }
        for label, variant in (("the C entry", lib), ("the C entry, checks on the first launch only", lib_checks)):
            run = k6_runner(variant.lat_lanczos_dia_forward, offsets, vals, v0, plan, zero_counter=plan.path == "grid")
            parts[label] = run
        parts["the wrapper"] = lambda: fl.lanczos_forward_rows(offsets, vals, v0, K7_DEPTH)
        times = {label: _host_us(fn) for label, fn in parts.items()}
        print(f"K6 host n={n} ({plan.path} path), us a call: "
              + ", ".join(f"{label} {us:.1f}" for label, us in times.items())
              + f"; clocks {cs._clocks()}", flush=True)


def k6_variant(plan, window):
    """``plan`` with a window of ``window`` floats (0: x from device memory),
    its shared bytes recomputed as ``forward_plan`` computes them."""
    smem = fl.forward_smem_bytes(plan.num_diags, plan.rows, plan.resident_diags, plan.path, window)
    return dataclasses.replace(plan, window=window, smem_bytes=smem)


def _k6_line(n, kind, label, lib, offsets, vals, v0, want, plan):
    try:
        run = k6_runner(lib.lat_lanczos_dia_forward, offsets, vals, v0, plan)
        err = _k6_err(run(), want)
    except RuntimeError as exc:
        print(f"K6 n={n} {kind} K={K7_DEPTH}, {label}: refused ({exc})", flush=True)
        return
    device, ms, clocks = _timed(run, 5 if n > 100_000 else 20, "lanczos_forward_kernel")
    print(f"K6 n={n} {kind} K={K7_DEPTH}, {label} ({plan.path} path, {plan.blocks} x {plan.threads}, "
          f"{plan.rows} rows a block, {plan.resident_diags} of {plan.num_diags} diagonals on chip, window "
          f"{plan.window}, state in {plan.state}): {_dev(device)} ms on the device, {ms:.4f} ms by events ({clocks}); rel err {err:.2e}",
          flush=True)


# Where K6's time goes: the kernel with parts of its work cut out (results
# are not the function's).
_K6_CUTS = {
    "no barriers (block barriers in their place)": [
        ("    grid_sync(counter, goal, threads);\n    if (warp == 0) {", "    sync_workers(threads);\n    if (warp == 0) {"),
        ("    lat::cluster_sync();\n    float t = 0.0f;", "    __syncthreads();\n    float t = 0.0f;")],
    "no values read": [("            v[u] = ok ? (on_chip ? sk[r] : __ldg(vk + r)) : 0.0f;", "            v[u] = 1.0f;")],
    "no basis stores": [("      __stcs(x_next + row, xn);", "      (void)x_next;")],
    "no halo reads": [("        v[u] = source_row<kCluster>(src, s_r, g, rows, first);",
                       "        v[u] = static_cast<float>(g);")],
    "no window reads": [("              xj[u] = ok ? wk[r] : 0.0f;", "              xj[u] = static_cast<float>(r);")],
}


def k6_breakdown(tmp):
    """K6 at (2^20, 5, 90) (the grid path) and (16,384, 5, 90) (the cluster
    path) with parts of its work cut out."""
    jobs = {label: (edited_source("lanczos_dia.cu", edits, tmp / f"k6_cut_{i}"), tmp / f"k6_cut_{i}")
            for i, (label, edits) in enumerate({"the kernel": [], **_K6_CUTS}.items())}
    built = build_parallel(jobs)
    data = _k6_data(((1 << 20, "laplacian"), (16_384, "laplacian")))
    for (n, _kind), (offsets, vals, v0, _want) in data.items():
        plan = cs._k6_plan(offsets, n, K7_DEPTH)
        for label, (lib, _report) in built.items():
            run = k6_runner(lib.lat_lanczos_dia_forward, offsets, vals, v0, plan)
            device, ms, clocks = _timed(run, 5 if n > 100_000 else 20, "lanczos_forward_kernel")
            print(f"K6 breakdown n={n} K={K7_DEPTH} ({plan.path} path), {label}: {_dev(device)} ms on the device, "
                  f"{ms:.4f} ms by events ({clocks})", flush=True)


# ---------------------------------------------------------------------------
# K11: the halo-exchange DIA matvec
# ---------------------------------------------------------------------------

# The slice's operator (test_util.five_diagonal(2^20, 1024), chip_smoke's
# HALO_*) over these partition counts.
K11_PARTITIONS = (1, 2, 4, 8)
K11_REPS = 48


def _k11_data():
    """``(offsets, [(v, vals)] x ROTATE_SETS)``: the slice's operator, a new
    seeded v and a copy of the values in each set, so that L2 does not hold
    one set's operands for its next use."""
    from lanczos_adjoints_tpu_torch.ops import sparse
    from lanczos_adjoints_tpu_torch.utils import test_util

    rng = __import__("numpy").random.default_rng(14)
    mat = test_util.five_diagonal(cs.HALO_N, cs.HALO_BANDWIDTH)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device="cuda")
    return dia.offsets, [(cs._tensor(rng, cs.HALO_N), vals.clone()) for _ in range(cs.ROTATE_SETS)]


class _ParentK11:
    """The parent's ``lat_halo_dia_matvec`` (a cooperative launch; receive
    buffers, flags and an epoch a call) on views of global tensors, as
    its wrapper launched it; ``parts`` splits the wrapper's host work."""

    def __init__(self, lib, offsets, parts, n):
        from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

        self.fn = lib.lat_halo_dia_matvec
        self.fn.argtypes = [_P] * 5 + [_I] * 5 + [_P, _P, ctypes.c_uint, _P]
        self.offsets, self.parts, self.n = tuple(offsets), parts, n
        self.halo, self.local_n = fh.halo_width(offsets), n // parts
        self.recv = [torch.full((2, 2, self.halo), float("nan"), device="cuda") for _ in range(parts)]
        self.flags = [torch.zeros(2, dtype=torch.int32, device="cuda") for _ in range(parts)]
        self.tables = [torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64, device="cuda")
                       for ts in (self.recv, self.flags)]
        self.offs = native.offsets_arg(offsets, None, "cuda")
        self.epoch = 0

    def views(self, v, vals, out):
        cut = [slice(p * self.local_n, (p + 1) * self.local_n) for p in range(self.parts)]
        return [v[s] for s in cut], [vals[:, s] for s in cut], [out[s] for s in cut]

    def arrays(self, v_parts, vals_parts, out_parts):
        ptrs = [(ctypes.c_void_p * self.parts)(*(t.data_ptr() for t in ts)) for ts in (v_parts, vals_parts, out_parts)]
        return ptrs, (ctypes.c_int * len(self.offsets))(*self.offsets)

    def call(self, ptrs, host_offsets):
        self.epoch = (self.epoch + 1) % 2**32
        native.check(self.fn(*ptrs, self.tables[0].data_ptr(), self.tables[1].data_ptr(), self.parts,
                             self.local_n, self.n, self.halo, len(self.offsets), host_offsets, self.offs.data_ptr(),
                             self.epoch, torch.cuda.current_stream().cuda_stream), "parent K11")

    def __call__(self, v, vals):
        out = torch.empty_like(v)
        with torch.cuda.device(v.device):
            self.call(*self.arrays(*self.views(v, vals, out)))
        return out


def _k11_line(label, runs, want, symbol="halo_dia_kernel"):
    """Time ``runs`` (one closure an operand set) in rotation: device us a
    launch by the profiler and by events; each set's result bit for bit
    against ``want``."""
    exact = all(torch.equal(run(), w) for run, w in zip(runs, want))
    device, ms, clocks = _timed(cs._rotating(runs), K11_REPS, symbol)
    return f"{label} {_dev(1e3 * device if device is not None else None)} us on the device, " \
           f"{1e3 * ms:.2f} us by events, bit for bit vs K4 {exact} ({clocks})"


def k11_parent(tmp, parent):
    """K11 at n = 2^20, D = 5, halo 1,024, P = 1, 2, 4, 8: the parent's
    kernel and this tree's wrapper, parent, this, this, parent."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

    lib = build_parent(parent, "halo_dia.cu", tmp / "parent_k11")
    offsets, sets = _k11_data()
    want = [fd.dia_matvec_rows(offsets, v, vals) for v, vals in sets]
    for parts in K11_PARTITIONS:
        old = _ParentK11(lib, offsets, parts, cs.HALO_N)
        runs = {"parent": [lambda v=v, vals=vals: old(v, vals) for v, vals in sets],
                "this": [lambda v=v, vals=vals, p=parts: fh.halo_dia_rows(offsets, v, vals, p) for v, vals in sets]}
        print(f"K11 P={parts}: " + "; ".join(_k11_line(label, runs[label], want)
                                            for label in ("parent", "this", "this", "parent")), flush=True)


# K11's design variants: its source with constants replaced.
_K11_VARIANTS = {
    "the kernel": [],
    "1 diagonal a loop iteration": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "4 diagonals a loop iteration": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "the vector path in at most 40 registers (6 blocks an SM)": [
        ("constexpr int kMinBlocksVector = 1;", "constexpr int kMinBlocksVector = 6;")],
    "the scalar path without a register cap": [
        ("constexpr int kMinBlocksScalar = 8;", "constexpr int kMinBlocksScalar = 1;")],
    "8 rows a thread": [("constexpr int kVectorRows = 4;", "constexpr int kVectorRows = 8;")],
    "offsets read through L1, not staged": [("  lat::stage_offsets(offsets, num_diags, s_off);\n", ""),
                                            ("s_off[k]", "__ldg(offsets + k)")],
}
# Grids: the plan's, and 5 and 10 blocks an SM over all partitions (one
# and two waves of the vector path's resident blocks).
_K11_GRIDS = (None, 5, 10)


def k11_variants(tmp):
    """This tree's K11 at n = 2^20, D = 5, halo 1,024, P = 1, 2, 4, 8: each
    design variant (``_K11_VARIANTS``) on the plan's grid and on grids of
    5 and 10 blocks an SM over all partitions, and the kernel with 1 row a
    thread (the plan's grid, 8, 16 and 32 blocks an SM), beside K4 on the
    same operand sets and a PyTorch column sum of the values (as many
    bytes); the registers, stack and spill of each build."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd

    built = build_parallel({label: (edited_source("halo_dia.cu", edits, tmp / f"k11_{i}"), tmp / f"k11_{i}")
                            for i, (label, edits) in enumerate(_K11_VARIANTS.items())})
    for label, (_lib, report) in built.items():
        _print_k11_ptxas(label, report)
    offsets, sets = _k11_data()
    want = [fd.dia_matvec_rows(offsets, v, vals) for v, vals in sets]
    k4 = [lambda v=v, vals=vals: fd.dia_matvec_rows(offsets, v, vals) for v, vals in sets]
    sms = native.device_limits("cuda")[0]
    # A yardstick of the card's rate on as many bytes: PyTorch's sum of the
    # values' D rows (D n floats read, n written; not K11's function).
    sums = [lambda vals=vals: vals.sum(0) for _v, vals in sets]
    device, ms, clocks = _timed(cs._rotating(sums), K11_REPS, "reduce")
    print(f"K11 yardstick: the values' column sum (PyTorch) {_dev(1e3 * device if device is not None else None)} us "
          f"on the device, {1e3 * ms:.2f} us by events ({clocks})", flush=True)
    for parts in K11_PARTITIONS:
        print(f"K11 P={parts}: " + _k11_line("K4 on the whole vector", k4, want, "dia_matvec_kernel"), flush=True)
        for label, (lib, _report) in built.items():
            rows = 8 if label == "8 rows a thread" else 4
            grids = _K11_GRIDS if label != "8 rows a thread" else (None,)
            lines = [_k11_line(f"grid {'the plan' if g is None else f'{g} an SM'}",
                               [_k11_direct(offsets, v, vals, parts, rows, g and max(1, g * sms // parts), lib)
                                for v, vals in sets], want) for g in grids]
            print(f"K11 P={parts} {label}: " + "; ".join(lines), flush=True)
        lines = [_k11_line(f"grid {'the plan' if g is None else f'{g} an SM'}",
                           [_k11_direct(offsets, v, vals, parts, 1, g and max(1, g * sms // parts))
                            for v, vals in sets], want) for g in (None, 8, 16, 32)]
        print(f"K11 P={parts} 1 row a thread: " + "; ".join(lines), flush=True)


def _k11_direct(offsets, v, vals, parts, rows, max_blocks=None, lib=None):
    """A closure that launches K11 (this tree's build, or ``lib``, a
    variant's) through its C entry with ``rows`` rows a thread and the
    plan's or ``max_blocks`` blocks a partition (the launch count
    untouched)."""
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

    fn = (lib or native.library("halo_dia")).lat_halo_dia_matvec
    fn.argtypes = list(native._SIGNATURES["halo_dia"]["lat_halo_dia_matvec"])
    n = v.shape[0]
    plan, host, offs = fh._launch_args(tuple(offsets), n, parts, v.device)
    blocks = max_blocks or plan.max_blocks
    out = torch.empty_like(v)

    def run():
        native.check(fn(v.data_ptr(), vals.data_ptr(), out.data_ptr(), 0, parts, plan.local_n, n, plan.halo,
                        len(offsets), host, offs.data_ptr(), rows, blocks, torch.cuda.current_stream().cuda_stream),
                     "K11")
        return out

    return run


def k11_ptxas(report):
    """``[(instantiation, registers, stack, spill stores, spill loads)]`` of K11's kernels."""
    rows, current, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry function" in line:
            match = re.search(r"halo_dia_kernel(ILi(\d+)E.*?(Rows|Table))?", line)
            current = None
            if match:
                current = f"{match[2]} rows a thread, {match[3]}" if match[1] else "halo_dia_kernel"
            frame = (0, 0, 0)
        elif current and "bytes stack frame" in line:
            frame = tuple(int(v) for v in re.findall(r"(\d+) bytes", line)[:3])
        elif current and "Used" in line and "registers" in line:
            rows.append((current, int(re.search(r"Used (\d+) registers", line)[1]), *frame))
            current = None
    return rows


def _print_k11_ptxas(label, report):
    print(f"K11 ({label}): " + "; ".join(f"{name} {regs} registers, stack {stack} B, spill {st}/{ld} B"
                                         for name, regs, stack, st, ld in k11_ptxas(report)), flush=True)


# Where the parent's K11 spent its time: its source with parts of its
# protocol cut out (results are not the function's, except "the kernel").
_K11_WAIT = ("    while (!reached(load_acquire(flags[p] + 0), epoch)) __nanosleep(32);\n"
             "    while (!reached(load_acquire(flags[p] + 1), epoch)) __nanosleep(32);\n")
_K11_PLAIN = ("err = cudaLaunchCooperativeKernel(", "err = cudaLaunchKernel(")
_K11_SEND = ("      to_right[t] = v[local_n - halo + t];\n      to_left[t] = v[t];\n", "")
_K11_FIXUP = ("  if (b * blockDim.x >= edges) return;", "  return;")
_K11_CUTS = {
    "a plain launch, no wait": [_K11_PLAIN, (_K11_WAIT, "")],
    "no edge fix-up": [_K11_FIXUP],
    "no send copies (the flags still released)": [_K11_SEND],
    "no PartPtrs indexing (partition 0's pointers)": [
        ("ptrs.v[p];", "ptrs.v[0];"), ("ptrs.vals[p];", "ptrs.vals[0];"), ("ptrs.out[p];", "ptrs.out[0];")],
    "the interior sweep alone (a plain launch; no send, wait or fix-up)": [
        _K11_PLAIN, ("  if (b == 0) {", "  if (false) {"), _K11_FIXUP],
}


def k11_breakdown(tmp, parent):
    """The parent's K11 at n = 2^20, D = 5, halo 1,024, P = 1 and 8, as it
    is and with parts of its protocol cut out, with each build's registers,
    stack and spill."""
    jobs = {label: (_parent_source(parent, "halo_dia.cu", edits, tmp / f"k11_cut_{i}"), tmp / f"k11_cut_{i}")
            for i, (label, edits) in enumerate({"the kernel": [], **_K11_CUTS}.items())}
    built = build_parallel(jobs)
    for label, (_lib, report) in built.items():
        _print_k11_ptxas(label, report)
    offsets, sets = _k11_data()
    for parts in (1, 8):
        for label, (lib, _report) in built.items():
            old = _ParentK11(lib, offsets, parts, cs.HALO_N)
            runs = [lambda v=v, vals=vals: old(v, vals) for v, vals in sets]
            device, ms, clocks = _timed(cs._rotating(runs), K11_REPS, "halo_dia_kernel")
            print(f"K11 breakdown P={parts}, parent, {label}: {_dev(1e3 * device if device is not None else None)} "
                  f"us on the device, {1e3 * ms:.2f} us by events ({clocks})", flush=True)


def _entered(context):
    with context:
        pass


def k11_host(tmp, parent):
    """The host's microseconds a K11 call at P = 1 and 8, in the parts of
    this tree's wrapper and, with ``parent``, of the parent's (its views,
    ctypes arrays, device context and C entry with its occupancy queries,
    on the parent's library), and each whole launch path."""
    from lanczos_adjoints_tpu_torch.ops import fused_dia as fd
    from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh

    offsets, sets = _k11_data()
    v, vals = sets[0]
    device = v.device
    lib = build_parent(parent, "halo_dia.cu", tmp / "parent_k11_host") if parent else None
    for parts in (1, 8):
        plan, _host, _offs = fh._launch_args(tuple(offsets), cs.HALO_N, parts, device)
        out = torch.empty_like(v)
        this = {
            "the operand checks": lambda: fd.check_operands(v, vals),
            "the cached plan and offsets": lambda p=parts: fh._launch_args(tuple(offsets), cs.HALO_N, p, device),
            "the output's allocation": lambda: torch.empty_like(v),
            "the pointers and rows a thread": lambda: plan.rows(cs.HALO_N, v.data_ptr(), vals.data_ptr(),
                                                                out.data_ptr()),
            "the current-device check": lambda: _entered(fh._device(device)),
            "the stream": lambda: native.stream(device),
            "the raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(device.index),
            "the C entry through ctypes": _k11_direct(offsets, v, vals, parts,
                                                      plan.rows(cs.HALO_N, v.data_ptr(), vals.data_ptr())),
            "the wrapper": lambda p=parts: fh.halo_dia_rows(offsets, v, vals, p),
        }
        times = {label: _host_us(fn) for label, fn in this.items()}
        print(f"K11 host P={parts}, this tree, us a call: "
              + ", ".join(f"{label} {us:.1f}" for label, us in times.items()) + f"; clocks {cs._clocks()}", flush=True)
        if lib is None:
            continue
        old = _ParentK11(lib, offsets, parts, cs.HALO_N)
        views = old.views(v, vals, out)
        arrays = old.arrays(*views)
        parent_parts = {
            "3P views": lambda: old.views(v, vals, out),
            "the ctypes pointer and offsets arrays": lambda: old.arrays(*views),
            "torch.cuda.device": lambda: _entered(torch.cuda.device(device)),
            "the C entry through ctypes (its occupancy queries, the epoch)": lambda: old.call(*arrays),
            "the launch path without the checks": lambda: old(v, vals),
        }
        times = {label: _host_us(fn) for label, fn in parent_parts.items()}
        print(f"K11 host P={parts}, parent, us a call: "
              + ", ".join(f"{label} {us:.1f}" for label, us in times.items()) + f"; clocks {cs._clocks()}", flush=True)


_K11_PATHS = """
import json, time
import torch
import chip_smoke as cs
from lanczos_adjoints_tpu_torch import parallel
from lanczos_adjoints_tpu_torch.krylov import lanczos
from lanczos_adjoints_tpu_torch.ops import sparse
from lanczos_adjoints_tpu_torch.parallel import fused_halo as fh
from lanczos_adjoints_tpu_torch.utils import test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import events_ms

def host_us(fn, reps=100):
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - start) / reps * 1e6
    torch.cuda.synchronize()
    return host

pin_float32()
out = {}
mat = test_util.five_diagonal(cs.HALO_N, cs.HALO_BANDWIDTH)
dia = sparse.dia_pack(mat)
vals = sparse.dia_values(dia, mat.data, device="cuda")
v0 = torch.ones(cs.HALO_N, device="cuda")
for parts in (1, 8):
    ring = fh.HaloExchange(parts, fh.halo_width(dia.offsets)) if hasattr(fh, "HaloExchange") else parts
    out[f"K11 wrapper P={parts}, host us a call"] = host_us(lambda: fh.halo_dia_rows(dia.offsets, v0, vals, ring))
for parts in cs.HALO_MESHES:
    matvec = parallel.sharded_dia_operator(dia, parallel.device_mesh(parts, device="cuda"))
    estimate = lanczos.tridiag(matvec, cs.HALO_DEPTH, reortho="none")
    cs._one_vjp(estimate, v0, vals)
    out[f"sharded Lanczos VJP P={parts}, ms"] = events_ms(lambda: cs._one_vjp(estimate, v0, vals), 20)
print("K11PATHS " + json.dumps(out), flush=True)
"""


def k11_paths(parent):
    """K11's wrapper (host us a call, P = 1 and 8) and the sharded Lanczos
    VJP at n = 2^20, K = 30 (CUDA events, mean of 20, P = 1, 2, 4, 8), each
    tree's own code in a process of its own: parent, this, this, parent."""
    here = Path(__file__).resolve().parent.parent
    runs = []
    for label, tree in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", _K11_PATHS], cwd=tree, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K11PATHS ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"{label} paths failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((label, json.loads(line[0][len("K11PATHS "):])))
    for key in runs[0][1]:
        print(f"K11 path {key}: " + ", ".join(f"{label} {values[key]:.3f}" for label, values in runs)
              + f"; clocks {cs._clocks()}", flush=True)


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
    parser.add_argument("--only", default="k1,k2,k3,k6,k7,k9,k10,k11",
                        help="comma-separated kernels: k1, k2, k3, k6, k7, k9, k10, k11")
    parser.add_argument("--parent", type=Path, help="a tree of an earlier commit to time against")
    parser.add_argument("--breakdown", action="store_true",
                        help="K2, K3, K6, K7, K9 and K11: time the kernel with parts of its work removed")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= {"k1", "k2", "k3", "k6", "k7", "k9", "k10", "k11"}:
        parser.error(f"--only takes k1, k2, k3, k6, k7, k9, k10, k11, got {args.only!r}")
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
            if "k6" in only and not args.breakdown:
                k6_parent(tmp, args.parent)
            if "k7" in only and not args.breakdown:
                k7_parent(tmp, args.parent)
            if only & {"k6", "k7"} and not args.breakdown and (args.parent / "chip_smoke.py").exists():
                k7_paths(args.parent)
            if "k9" in only:
                k9_parent(tmp, args.parent)
                if (args.parent / "chip_smoke.py").exists():
                    k9_paths(args.parent)
            if "k11" in only and not args.breakdown:
                k11_parent(tmp, args.parent)
                if (args.parent / "chip_smoke.py").exists():
                    k11_paths(args.parent)
            if only & {"k1", "k10"}:
                parent_comparison(tmp, args.parent)
        if args.breakdown:
            for kernel in ("k2", "k3"):
                if kernel in only:
                    breakdown(tmp, kernel)
            if "k6" in only:
                k6_breakdown(tmp)
            if "k7" in only:
                k7_breakdown(tmp, args.parent)
            if "k9" in only:
                k9_breakdown(tmp)
            if "k11" in only:
                if args.parent is None:
                    parser.error("--only k11 --breakdown cuts the parent's kernel: give --parent DIR")
                k11_breakdown(tmp, args.parent)
        else:
            if "k2" in only:
                k2_variants(tmp)
            if "k3" in only:
                k3_variants(tmp)
            if "k6" in only:
                k6_variants(tmp)
            if "k7" in only:
                k7_variants(tmp)
            if "k9" in only:
                k9_variants(tmp)
            if "k11" in only:
                k11_variants(tmp)
                k11_host(tmp, args.parent)
        if "k1" in only:
            k1_variants(tmp)
        if "k10" in only:
            k10_variants(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
