"""The DIA matvec's roofline on the card: K12's attainable ceiling against K4.

Counterpart of ``experiments/benchmarks/spmv_formats/dia_roofline.py``.
The traffic that one DIA matvec must move is

    bytes = num_diags * n * 4   (the values, read once)
          + n * 4               (x, read once)
          + n * 4               (the output, written once)

and K12 (``ops.fused_dia.dia_ceiling_rows``, ``csrc/dia_ceiling.cu``)
moves exactly those bytes, with one addition in place of the shifted
reads: the ceiling attainable for this traffic, taken at each of its
block sizes (``threads``, the counterpart of the TPU script's ``chunk``).
The TPU script's sweep over its Pallas kernel's ``chunk_target`` and
``one_roll`` becomes one row each for K4 as built (``csrc/dia.cu``, which
has neither knob), for the plain ``ops.sparse.dia_matvec_fn`` (one
``torch.roll`` a diagonal) and for cuSPARSE's CSR product through
``torch.sparse_csr_tensor @ x``, a yardstick that the port never calls.

Each time is taken twice. L2-warm: every call on one operand set, as the
TPU script times it; at ``--n_side 1024`` the 29.4 MB fit the card's
50 MB L2, so a reading may beat the HBM floor (``l2_resident_regime``).
L2-cold: the calls cycle through ``OPERAND_SETS`` sets, so that a set's
bytes pass through the L2 many times over between two of its uses. A
time is the device time per call over ``REPS`` back-to-back calls
(``utils.timing.device_seconds``: CUDA events around calls queued behind
a spin that hides the host's launch time; a host clock off the card):
the host's share of launching a 10 us kernel is not the kernel's. A
reading the host held back is an upper bound and not ``resolved``.

``python -m lanczos_adjoints_tpu_torch.studies.dia_roofline [--n_side
1024] [--device cuda] --out DIR`` writes ``dia_roofline_n{n_side}.json``
under the TPU script's keys (``n``, ``num_diags``, ``bytes_per_matvec``,
``bytes_per_nnz``, ``traffic_model``, ``ceiling``, ``sweep``, ``best``,
``pct_of_attainable``, ``hbm_spec_gb_per_s``, ``hbm_floor_s``), with
``time_s`` the L2-warm time and ``time_s_l2_cold`` beside it,
``l2_resident_regime`` for ``vmem_resident_regime``, the plain and
library versions of the ceiling, and the device.
"""

import argparse
import itertools
import json
import os

import numpy as np
import torch

from lanczos_adjoints_tpu_torch.ops import fused_dia, sparse
from lanczos_adjoints_tpu_torch.utils import test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import device_seconds

REPS = 32  # calls a timed run: the plain matvec queues ~16 kernels a call, a held stream ~1,000
OPERAND_SETS = 8
# The HBM3 rate of one H100 SXM (NVIDIA's data sheet), the floor's rate.
CARD_HBM_GB_PER_S = 3350.0
SWEEP = ("k4", "plain", "cusparse")
SWEEP_NOTE = (
    "K4 (csrc/dia.cu lat_dia_matvec) has no chunk_target or one_roll: one thread a row in a "
    "grid-stride loop, so the TPU script's tuning sweep is one row for K4 as built, beside the plain "
    "dia_matvec_fn (torch.roll) and cuSPARSE CSR (torch.sparse_csr_tensor @ x, a yardstick only)"
)


def _laplacian_2d(n_side):
    """The TPU script's operator: offsets ``(-n_side, -1, 0, 1, n_side)`` on
    ``n_side^2`` rows with no wrap, 4 on the diagonal and -1 off it."""
    return test_util.five_diagonal(n_side * n_side, n_side)


def traffic(mat) -> dict:
    """The bytes one DIA matvec of ``mat`` must move, and per nonzero."""
    n = mat.shape[0]
    num_diags = len(sparse.dia_analyze(mat))
    bytes_matvec = (num_diags + 2) * n * 4  # probe traffic == kernel traffic
    return {"n": n, "num_diags": num_diags, "bytes_per_matvec": bytes_matvec,
            "bytes_per_nnz": bytes_matvec / mat.nnz,
            "traffic_model": "num_diags*n*4 (values) + n*4 (x) + n*4 (out)"}


def speed_of_light(n, num_diags, threads):
    """``run(v, vals) -> v + sum_k vals[k]``: K12 at ``threads`` a block, the
    traffic of one DIA matvec with no shifted read."""

    def run(v, vals):
        if v.shape != (n,) or vals.shape != (num_diags, n):
            msg = f"expected ({n},) and ({num_diags}, {n}), got {tuple(v.shape)} and {tuple(vals.shape)}"
            raise ValueError(msg)
        return fused_dia.dia_ceiling_rows(v, vals, threads=threads)

    return run


def predicted_launches() -> dict:
    """K12 and K4 launches of one ``run``: per timed function a warm-up call
    and ``REPS`` calls L2-warm, a warm-up pass over the sets and ``REPS``
    calls L2-cold."""
    per_function = 1 + REPS + OPERAND_SETS + REPS
    return {"dia_ceiling": len(fused_dia.CEILING_THREADS) * per_function, "dia_matvec": per_function}


def _time_both(calls, bytes_matvec, device, *, rate_key):
    """L2-warm and L2-cold device time of ``calls`` (one callable an operand set)."""
    warm = calls[0]
    warm()
    t_warm, clock = device_seconds(warm, reps=REPS, device=device)
    for call in calls:
        call()
    turn = itertools.cycle(calls)
    t_cold, clock_cold = device_seconds(lambda: next(turn)(), reps=REPS, device=device)
    # A host-bound reading is an upper bound, not the device's time.
    resolved = bool(t_warm > 0 and t_cold > 0 and "host-bound" not in clock + clock_cold)
    return {"time_s": t_warm, "time_s_l2_cold": t_cold, rate_key: bytes_matvec / t_warm / 1e9,
            f"{rate_key}_l2_cold": bytes_matvec / t_cold / 1e9, "resolved": resolved,
            "clock": clock if clock == clock_cold else f"{clock}/{clock_cold}"}


def _us(row):
    return f"{row['time_s'] * 1e6:.2f} us L2-warm, {row['time_s_l2_cold'] * 1e6:.2f} us L2-cold"


def run(n_side, *, device="cuda", seed=0) -> dict:
    """The artifact of one ``--n_side``: the ceiling at each ``threads``, its
    plain and library versions, the sweep and the verdicts."""
    mat = _laplacian_2d(n_side)
    dia = sparse.dia_pack(mat)
    vals = sparse.dia_values(dia, mat.data, device=device)
    artifact = traffic(mat)
    n, num_diags, bytes_matvec = artifact["n"], artifact["num_diags"], artifact["bytes_per_matvec"]
    print(f"n={n} diags={num_diags} traffic/matvec={bytes_matvec / 1e6:.1f} MB "
          f"({artifact['bytes_per_nnz']:.2f} B/nnz)", flush=True)
    rng = np.random.default_rng(seed)
    sets = [(torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=device),
             vals if s == 0 else vals.clone()) for s in range(OPERAND_SETS)]
    artifact.update(ceiling={}, sweep=[], sweep_note=SWEEP_NOTE,
                    device=torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu")

    def time_calls(fn, rate_key):
        return _time_both([lambda s=s: fn(*s) for s in sets], bytes_matvec, device, rate_key=rate_key)

    for threads in fused_dia.CEILING_THREADS:
        row = time_calls(speed_of_light(n, num_diags, threads), "gb_per_s")
        artifact["ceiling"][str(threads)] = row
        print(f"ceiling threads={threads}: {_us(row)}; {row['gb_per_s']:.0f} / {row['gb_per_s_l2_cold']:.0f} "
              f"GB/s ({row['clock']})", flush=True)
    artifact["ceiling_plain"] = time_calls(fused_dia.dia_ceiling_plain, "gb_per_s")
    # The library yardstick: two PyTorch calls, summing the values first.
    artifact["ceiling_library"] = dict(time_calls(lambda x, v: x + v.sum(0), "gb_per_s"),
                                       calls="x + vals.sum(0), two PyTorch calls")
    print(f"ceiling plain (D + 1 additions): {_us(artifact['ceiling_plain'])}; library x + vals.sum(0): "
          f"{_us(artifact['ceiling_library'])}", flush=True)

    plain = sparse.dia_matvec_fn(dia)
    crow = torch.tensor(mat.indptr, device=device)
    col = torch.tensor(mat.indices, device=device)
    data = torch.tensor(mat.data, dtype=torch.float32, device=device)
    csrs = [torch.sparse_csr_tensor(crow, col, data if s == 0 else data.clone(), size=mat.shape,
                                    check_invariants=False)
            for s in range(OPERAND_SETS)]
    matvecs = {
        "k4": [lambda s=s: fused_dia.dia_matvec_rows(dia.offsets, *s) for s in sets],
        "plain": [lambda s=s: plain(*s) for s in sets],
        "cusparse": [lambda s=s, c=c: c @ s[0] for s, c in zip(sets, csrs)],
    }
    for name in SWEEP:
        row = dict(matvec=name, **_time_both(matvecs[name], bytes_matvec, device, rate_key="gb_per_s_effective"))
        artifact["sweep"].append(row)
        print(f"{name}: {_us(row)}; {row['gb_per_s_effective']:.0f} / {row['gb_per_s_effective_l2_cold']:.0f} "
              f"GB/s eff ({row['clock']})", flush=True)
    return verdicts(artifact)


def verdicts(artifact) -> dict:
    """``best``, ``pct_of_attainable`` (clamped at 1 as in the TPU script, with
    the unclamped ratio beside it), L2-warm and L2-cold, and the floor.

    ``best`` is the fastest resolved row of the port's own matvecs (K4 and
    the plain one; cuSPARSE is a yardstick). Only resolved readings count.
    """
    kernel_ok = [r for r in artifact["sweep"] if r["resolved"] and r["matvec"] != "cusparse"]
    ceil_ok = [r for r in artifact["ceiling"].values() if r["resolved"]]
    for suffix in ("", "_l2_cold"):
        key = f"time_s{suffix}"
        best = min(kernel_ok, key=lambda r: r[key])
        ceil_best = min(ceil_ok, key=lambda r: r[key])
        ratio = ceil_best[key] / best[key]
        artifact[f"best{suffix}"] = best
        artifact[f"pct_of_attainable{suffix}"] = min(ratio, 1.0)
        artifact[f"pct_of_attainable{suffix}_unclamped"] = ratio
    floor_s = artifact["bytes_per_matvec"] / (CARD_HBM_GB_PER_S * 1e9)
    artifact["hbm_spec_gb_per_s"] = CARD_HBM_GB_PER_S
    artifact["hbm_floor_s"] = floor_s
    # A warm reading below the floor re-reads the operands from L2, not HBM.
    artifact["l2_resident_regime"] = bool(artifact["best"]["time_s"] < floor_s)
    for suffix, label in (("", "L2-warm"), ("_l2_cold", "L2-cold")):
        best, ratio = artifact[f"best{suffix}"], artifact[f"pct_of_attainable{suffix}_unclamped"]
        ceiling = min(r[f"time_s{suffix}"] for r in ceil_ok)
        print(f"{label}: best {best['matvec']} {best[f'time_s{suffix}'] * 1e6:.2f} us vs attainable "
              f"{ceiling * 1e6:.2f} us -> {100 * min(ratio, 1.0):.0f}% of the measured ceiling "
              f"(unclamped {100 * ratio:.1f}%)"
              + ("; the ceiling is no ceiling: the matvec beat the probe" if ratio > 1.0 else ""), flush=True)
    print(f"HBM-spec floor {floor_s * 1e6:.2f} us at {CARD_HBM_GB_PER_S:.0f} GB/s; "
          f"l2_resident_regime={artifact['l2_resident_regime']}", flush=True)
    return artifact


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_side", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    print(args, flush=True)
    pin_float32()
    artifact = run(args.n_side, device=args.device, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    fname = os.path.join(args.out, f"dia_roofline_n{args.n_side}.json")
    with open(fname, "w") as fp:
        json.dump(artifact, fp, indent=2)
    print(f"wrote {fname}", flush=True)
    return artifact


if __name__ == "__main__":
    main()
