"""Scaling of the row-partitioned workloads, on P partitions of one card.

Counterpart of ``experiments/benchmarks/multihost_scaling/benchmark.py``.
Two workloads:

1. **The GP Gram matvec over row blocks** (``parallel.sharded_gram_policy``):
   O(n^2/P) local work against one all-gather of the n * 4-byte output a
   matvec. ``measure_gram_local`` times K1 (``csrc/gram_matvec.cu``,
   matern32) at rows = n/P against all n columns.
2. **The row-partitioned DIA Lanczos** (``parallel.sharded_dia_operator``,
   K11 on the card): O(nnz/P) local work against a halo exchange and two
   scalar reductions a step. ``measure_dia_local`` times K4 (``csrc/dia.cu``)
   at each local size.

``fit_affine_cost``, ``gram_model``, ``dia_model`` and ``regime_80`` are
the TPU script's cost model, in numpy: a monotone affine fit of the local
times, then the predicted efficiency of P devices joined by a link of
``link_bytes_per_s`` a direction and ``link_latency_s`` a hop. The link's
numbers are arguments with no default. One card has no link between
cards (that waits for ROADMAP A13), so ``--measure_local`` records two
stand-ins that one card does have, named as such with the card: the rate
of a device-to-device ``copy_`` of the largest local rows, and the
latency of one launch and its synchronisation. ``--model_only`` rebuilds
the model from an artifact's ``local_steps`` with the link numbers given
on the command line, else those stand-ins, else the numbers that built
the artifact's model before (a TPU artifact's ``ici_*``).

``measured_virtual_mesh`` runs the sharded Lanczos VJP (``tridiag``, K =
``--depth``, all-ones cotangent) over meshes of 1, 2, 4, 8 and 16
partitions of one card: per P the time of ``--reps`` chained VJPs less
one, over ``reps - 1`` (medians of 3 on a synchronised host clock, a VJP
taking milliseconds), and the ratio of the two medians.

Local times are device time per call on one operand set
(``utils.timing.device_seconds``: CUDA events around ``REPS`` calls
queued behind a spin that hides the host's launch time), never a host
loop: K4's local steps take microseconds. A reading the host held back
is not ``resolved`` and stays out of the fit.

``python -m lanczos_adjoints_tpu_torch.studies.multihost_scaling
[--measure_local | --model_only] [--num_rows 1048576] [--bandwidth 1024]
[--depth 30] [--reps 4] [--gram_n 65536] [--gram_d 9] [--link_bytes_per_s
B --link_latency_s S] [--device cuda] --out DIR`` updates
``DIR/scaling.json`` (merged into what is there, as the TPU script does).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from lanczos_adjoints_tpu_torch import parallel
from lanczos_adjoints_tpu_torch.krylov import lanczos
from lanczos_adjoints_tpu_torch.ops import fused_dia, fused_gram, native, sparse
from lanczos_adjoints_tpu_torch.utils import test_util
from lanczos_adjoints_tpu_torch.utils.precision import pin_float32
from lanczos_adjoints_tpu_torch.utils.timing import device_seconds

DEVICE_GRID = [2, 4, 8, 16, 32]
# Local-cost fits are measured on a denser grid than the device counts,
# repeated per point (the TPU script's grid and repeats).
MEASURE_GRID = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48]
MEASURE_REPEATS = 3
MESH_SIZES = (1, 2, 4, 8, 16)
REPS = 32  # calls a device-time reading
TIMED_RUNS = 3  # medians of the measured path


def _median_slope(measure, repeats=MEASURE_REPEATS):
    """Median of ``repeats`` readings ``measure() -> (seconds, resolved)``."""
    times, resolved = [], True
    for _ in range(repeats):
        t, ok = measure()
        times.append(t)
        resolved = resolved and ok
    return {"time_s": float(np.median(times)), "times": [float(t) for t in times], "resolved": resolved}


def _device_time(call, device):
    t, clock = device_seconds(call, reps=REPS, device=device)
    return t, bool(t > 0 and not clock.endswith("host-bound"))


def measure_gram_local(gram_n, gram_d, *, device="cuda", seed=0):
    """K1 (matern32) time at rows = n/P for each P of ``MEASURE_GRID``."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((gram_n, gram_d)), dtype=torch.float32, device=device)
    v = torch.tensor(rng.standard_normal(gram_n), dtype=torch.float32, device=device)
    ell = torch.ones(gram_d, device=device)
    out_scale = torch.tensor(1.0, device=device)
    fused = fused_gram.gram_matvec_fused("matern32")
    table = {}
    for p in MEASURE_GRID:
        rows = gram_n // p
        x_loc = x[:rows]

        def local(x_loc=x_loc):
            return fused(x_loc, x, v, ell, out_scale)

        local()
        entry = _median_slope(lambda local=local: _device_time(local, device))
        table[rows] = entry
        print(f"gram local rows={rows}: {entry['time_s'] * 1e3:.4f} ms (spread {min(entry['times']) * 1e3:.4f}-"
              f"{max(entry['times']) * 1e3:.4f}, resolved={entry['resolved']})", flush=True)
    return table


def local_rows(num_rows, p):
    """The DIA local rows at P devices: n/P rounded down to a multiple of 1024."""
    rows = num_rows // p
    return rows - rows % 1024


def measure_dia_local(num_rows, bandwidth, *, device="cuda"):
    """K4 time on the local 5-diagonal operator at rows = n/P (rounded down to
    a multiple of 1024, the TPU kernel's tiling) for each P of ``MEASURE_GRID``."""
    table = {}
    for p in MEASURE_GRID:
        rows = local_rows(num_rows, p)
        mat = test_util.five_diagonal(rows, bandwidth)
        dia = sparse.dia_pack(mat)
        values = sparse.dia_values(dia, mat.data, device=device)
        v = torch.ones(rows, device=device)

        def local(dia=dia, values=values, v=v):
            return fused_dia.dia_matvec_rows(dia.offsets, v, values)

        local()
        t, ok = _device_time(local, device)
        table[rows] = {"time_s": t, "resolved": ok}
        print(f"dia local rows={rows}: {t * 1e6:.2f} us (resolved={ok})", flush=True)
    return table


def measure_link(rows, *, device="cuda", calls=200):
    """The stand-ins one card has for a link: the device-to-device ``copy_``
    rate of ``rows`` float32 entries, and the host's median latency of one
    launch (a one-entry fill) and its synchronisation."""
    src = torch.ones(rows, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    t_copy, clock = device_seconds(lambda: dst.copy_(src), reps=REPS, device=device)
    one = torch.empty(1, device=device)
    lat = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.fill_(0.0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    link = {"device": torch.cuda.get_device_name(device), "copy_rows": rows, "copy_bytes": 4 * rows,
            "copy_s": t_copy, "copy_clock": clock, "copy_bytes_per_s": 4 * rows / t_copy,
            "launch_sync_latency_s": float(np.median(lat)),
            "note": "stand-ins measured on one card: there is no link between cards until ROADMAP A13"}
    print(f"link stand-ins on {link['device']}: copy_ of {4 * rows} bytes {t_copy * 1e6:.2f} us "
          f"({link['copy_bytes_per_s'] / 1e9:.1f} GB/s); launch + synchronise "
          f"{link['launch_sync_latency_s'] * 1e6:.2f} us", flush=True)
    return link


def fit_affine_cost(local_table):
    """Fit a monotone cost model ``t(rows) = a + b*rows`` (a, b >= 0).

    Raw per-row readings can make t(rows) locally sub-linear and predict a
    super-linear speedup; the nonnegative affine fit (a fixed cost a call
    and a throughput term) bounds the predicted efficiency by 1:
    eff = (a + b n) / (P a + b n + P t_comm) <= 1. Resolved readings only,
    by relative least squares (weight 1/t), so that the small-rows points,
    where the 80 % boundary is decided, are fitted as closely as the rest.
    """
    resolved = {r: v for r, v in local_table.items() if v.get("resolved", True)}
    if len(resolved) < 3:
        return {
            "overhead_s": None,
            "per_row_s": None,
            "max_rel_fit_error": None,
            "median_rel_fit_error": None,
            "points": int(len(resolved)),
            "unresolved": True,
        }
    local_table = resolved
    rows = np.array(sorted(local_table))
    t = np.array([local_table[r]["time_s"] for r in rows])
    A = np.stack([np.ones_like(rows, dtype=float), rows.astype(float)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A / t[:, None], np.ones_like(t), rcond=None)
    if b < 0:  # degenerate: flat-cost regime; all overhead
        a, b = float(np.mean(t)), 0.0
    elif a < 0:  # degenerate: pure-throughput regime
        a, b = 0.0, float(np.sum(rows / t) / np.sum(rows * rows / t**2))
    residual = t - (a + b * rows)
    rel = np.abs(residual) / t
    return {
        "overhead_s": float(a),
        "per_row_s": float(b),
        "max_rel_fit_error": float(np.max(rel)),
        "median_rel_fit_error": float(np.median(rel)),
        "points": int(len(rows)),
    }


def gram_model(local_table, n, *, link_bytes_per_s, link_latency_s, scale=1.0):
    """Efficiency of the row-sharded Gram matvec against the device count.

    Communication: a ring all-gather of the (n,) output, P - 1 hops of
    n/P * 4 bytes. Local work: the affine fit at rows = n/P, times
    ``scale`` (the fit residual's band: a smaller local cost is the
    pessimistic edge).
    """
    fit = fit_affine_cost(local_table)
    if fit.get("unresolved"):
        return None, fit
    cost = lambda rows: scale * (fit["overhead_s"] + fit["per_row_s"] * rows)  # noqa: E731
    t1 = cost(n)
    out = []
    for p in DEVICE_GRID:
        rows = n // p
        if rows not in local_table:
            rows = min(local_table, key=lambda r: abs(r - n // p))
        t_local = cost(rows)
        t_comm = (p - 1) * (rows * 4 / link_bytes_per_s + link_latency_s)
        eff = t1 / (p * (t_local + t_comm))
        out.append({"devices": p, "rows_per_device": rows, "t_local_s": t_local,
                    "t_local_measured_s": local_table[rows]["time_s"], "t_comm_s": t_comm,
                    "predicted_efficiency": eff})
    return out, fit


def dia_model(local_table, n, bandwidth, *, link_bytes_per_s, link_latency_s, scale=1.0):
    """Efficiency of the sharded DIA Lanczos step against the device count.

    A step and device: one halo exchange (both directions, ``bandwidth``
    float32 entries each) and two scalar reductions on the recurrence's
    critical path. Sequential: the exchange, then the local sweep.
    Overlapped: the exchange rides under the local sweep, so only its
    exposed remainder max(0, t_halo - t_local) and the boundary rows'
    recompute cost time; the reductions cannot be hidden.
    """
    fit = fit_affine_cost(local_table)
    if fit.get("unresolved"):
        return None, fit
    cost = lambda rows: scale * (fit["overhead_s"] + fit["per_row_s"] * rows)  # noqa: E731
    t1 = cost(n)
    halo_bytes = 2 * bandwidth * 4  # per direction
    out = []
    for p in DEVICE_GRID:
        rows = n // p
        if rows not in local_table:
            rows = min(local_table, key=lambda r: abs(r - n // p))
        t_local = cost(rows)
        t_halo = halo_bytes / link_bytes_per_s + link_latency_s
        t_psum = 2 * 2 * link_latency_s * max(1, int(np.log2(p)))
        t_recompute = t_local * min(1.0, 2 * bandwidth / rows)
        eff_seq = t1 / (p * (t_local + 2 * t_halo + t_psum))
        exposed = max(0.0, 2 * t_halo - t_local)
        overlap_fraction = 1.0 - exposed / (2 * t_halo)
        eff_ovl = t1 / (p * (t_local + exposed + t_recompute + t_psum))
        out.append({"devices": p, "rows_per_device": rows, "t_local_s": t_local,
                    "t_local_measured_s": local_table[rows]["time_s"], "t_halo_exchange_s": 2 * t_halo,
                    "t_psum_s": t_psum, "overlap_fraction": overlap_fraction,
                    "predicted_efficiency_sequential": eff_seq, "predicted_efficiency_overlapped": eff_ovl})
    return out, fit


def regime_80(model_rows, key):
    """Smallest rows/device at which every device count meets >= 0.80."""
    passing = [m["rows_per_device"] for m in model_rows if m[key] >= 0.80]
    failing = [m["rows_per_device"] for m in model_rows if m[key] < 0.80]
    if not passing:
        return {"holds": False, "min_rows_per_device": None}
    threshold = max(failing) if failing else 0
    return {"holds": True, "min_rows_per_device": int(min(r for r in passing if r > threshold))}


def comm_model(steps, *, link_bytes_per_s, link_latency_s, link_source) -> dict:
    """The model of both workloads from ``local_steps``, with the 80 % regimes
    and their band under the fit's largest relative residual."""
    link = {"link_bytes_per_s": link_bytes_per_s, "link_latency_s": link_latency_s}
    gram_table = {int(k): v for k, v in steps["gram"]["rows_table"].items()}
    dia_table = {int(k): v for k, v in steps["dia"]["rows_table"].items()}
    gram_n, dia_n, bandwidth = steps["gram"]["n"], steps["dia"]["n"], steps["dia"]["bandwidth"]
    gm, gram_fit = gram_model(gram_table, gram_n, **link)
    dm, dia_fit = dia_model(dia_table, dia_n, bandwidth, **link)

    def band(model_fn, fit, key, *fn_args):
        if fit.get("unresolved"):
            return {"unresolved": True, "points_resolved": fit["points"]}
        e = min(fit["max_rel_fit_error"], 0.9)
        lo, _ = model_fn(*fn_args, scale=1.0 - e, **link)
        hi, _ = model_fn(*fn_args, scale=1.0 + e, **link)
        return {"local_cost_scaled_down": regime_80(lo, key), "local_cost_scaled_up": regime_80(hi, key),
                "scale_half_width": e}

    model = {
        "assumptions": {
            "link_bytes_per_s_per_direction": link_bytes_per_s,
            "link_one_hop_latency_s": link_latency_s,
            "link_source": link_source,
            "local_step_times": (
                "monotone affine fit t(rows) = a + b*rows (a, b >= 0) to the measurements in local_steps; "
                "raw per-row readings are noisy enough to predict super-linear (>1.0) efficiency if used "
                "directly, and the affine form bounds efficiency by 1 by construction"
            ),
            "local_cost_fit": {"gram": gram_fit, "dia": dia_fit},
            "gram_communication": "ring all-gather of the n*4-byte output",
            "dia_communication": (
                "bidirectional halo exchange + 2 scalar reductions per Lanczos step; the overlapped variant "
                "hides min(t_halo, t_local) of the exchange behind the local sweep"
            ),
        },
        "gram_flagship": gm,
        "dia_lanczos": dm,
        "efficiency_80_regime": {
            "gram_flagship": regime_80(gm, "predicted_efficiency") if gm else {"unresolved": True},
            "dia_lanczos_sequential": (regime_80(dm, "predicted_efficiency_sequential") if dm
                                       else {"unresolved": True}),
            "dia_lanczos_overlapped": (regime_80(dm, "predicted_efficiency_overlapped") if dm
                                       else {"unresolved": True}),
            "uncertainty_band": {
                "gram_flagship": band(gram_model, gram_fit, "predicted_efficiency", gram_table, gram_n),
                "dia_lanczos_overlapped": band(dia_model, dia_fit, "predicted_efficiency_overlapped",
                                               dia_table, dia_n, bandwidth),
            },
        },
    }
    for row in gm or []:
        print(f"gram P={row['devices']}: eff {row['predicted_efficiency']:.3f}", flush=True)
    for row in dm or []:
        print(f"dia P={row['devices']}: seq {row['predicted_efficiency_sequential']:.3f} "
              f"ovl {row['predicted_efficiency_overlapped']:.3f}", flush=True)
    return model


def link_constants(artifact, *, link_bytes_per_s=None, link_latency_s=None):
    """``(bytes/s, latency s, source)``: the arguments where given, else the
    stand-ins measured into ``local_steps``, else the numbers behind the
    artifact's model; raises if there are none."""
    if link_bytes_per_s is not None and link_latency_s is not None:
        return link_bytes_per_s, link_latency_s, "given on the command line"
    link = artifact.get("local_steps", {}).get("link")
    if link:
        return (link["copy_bytes_per_s"], link["launch_sync_latency_s"],
                f"stand-ins on {link['device']}: copy_ rate and launch + synchronise latency (no link between "
                "cards until ROADMAP A13)")
    before = artifact.get("comm_model", {}).get("assumptions", {})
    for bw_key, lat_key in (("link_bytes_per_s_per_direction", "link_one_hop_latency_s"),
                            ("ici_bytes_per_s_per_direction", "ici_one_hop_latency_s")):
        if bw_key in before and lat_key in before:
            source = before.get("link_source", f"the artifact's earlier model ({bw_key}, {lat_key})")
            return before[bw_key], before[lat_key], source
    msg = ("no link numbers: pass --link_bytes_per_s and --link_latency_s, or measure the card's stand-ins "
           "with --measure_local")
    raise ValueError(msg)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [leaf for item in out for leaf in _leaves(item)]


def measured_virtual_mesh(num_rows, bandwidth, depth, reps, *, device="cuda", sizes=MESH_SIZES):
    """The sharded DIA Lanczos VJP on meshes of ``sizes`` partitions of one card.

    Returns ``(rows, grads, launches)``: the JSON rows (``devices``,
    ``time_s``, ``efficiency``, ``many_over_one``), each P's ``(dv, dvals)``
    at v = ones with the all-ones cotangent, and the kernels that one
    such VJP launched.
    """
    mat = test_util.five_diagonal(num_rows, bandwidth)
    dia = sparse.dia_pack(mat)
    values = sparse.dia_values(dia, mat.data, device=device)
    v0 = torch.ones(num_rows, device=device)
    print(f"operator: n={num_rows} nnz={mat.nnz} diagonals={len(dia.offsets)}", flush=True)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rows, grads, launches = [], {}, {}
    base_time = None
    for p in sizes:
        mesh = parallel.device_mesh(p, device=device)
        matvec = parallel.sharded_dia_operator(dia, mesh)
        vals_sharded = parallel.shard_rows(values, mesh, dim=1)
        factorise = lanczos.tridiag(matvec, depth, reortho="none")

        def one_vjp(v, vals, factorise=factorise):
            inputs = [v.detach().requires_grad_(), vals.detach().requires_grad_()]
            outputs = _leaves(factorise(*inputs))
            dv, dvals = torch.autograd.grad(outputs, inputs, [torch.ones_like(o) for o in outputs])
            return torch.sum(dv), dv, dvals

        def repeated(count, one_vjp=one_vjp):
            v, acc = parallel.shard_rows(v0, mesh), 0.0
            for _ in range(count):
                contribution, dv, _dvals = one_vjp(v, vals_sharded)
                v, acc = v + 1e-12 * dv, acc + contribution
            return acc

        native.reset_launches()
        _sum, dv, dvals = one_vjp(v0, vals_sharded)
        sync()
        launches[p] = {k: c for k, c in native.launch_counts().items() if c}
        grads[p] = (dv.detach(), dvals.detach())
        repeated(reps)
        t_many, t_one = [], []
        for _ in range(TIMED_RUNS):
            for count, times in ((reps, t_many), (1, t_one)):
                sync()
                t0 = time.perf_counter()
                float(repeated(count))
                times.append(time.perf_counter() - t0)
        many, one = float(np.median(t_many)), float(np.median(t_one))
        t = (many - one) / (reps - 1)
        base_time = t if base_time is None else base_time
        eff = base_time / (t * p)
        print(f"devices={p}: {t * 1e3:.2f} ms/VJP  scaling efficiency {eff:.2f} ({reps} VJPs / one "
              f"{many / one:.2f}x); launches per VJP {launches[p]}", flush=True)
        rows.append({"devices": p, "time_s": t, "efficiency": eff, "many_over_one": many / one})
    return rows, grads, launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_rows", type=int, default=1 << 20)
    parser.add_argument("--bandwidth", type=int, default=1024)
    parser.add_argument("--depth", type=int, default=30)
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--measure_local", action="store_true")
    parser.add_argument("--model_only", action="store_true",
                        help="rebuild comm_model from the stored local_steps (no device runs)")
    parser.add_argument("--merge", action="store_true", default=True)
    parser.add_argument("--gram_n", type=int, default=1 << 16)
    parser.add_argument("--gram_d", type=int, default=9)
    parser.add_argument("--link_bytes_per_s", type=float, default=None)
    parser.add_argument("--link_latency_s", type=float, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    print(args, flush=True)
    pin_float32()
    os.makedirs(args.out, exist_ok=True)
    artifact_path = os.path.join(args.out, "scaling.json")
    artifact = {}
    if os.path.exists(artifact_path) and args.merge:
        with open(artifact_path) as fp:
            artifact = json.load(fp)
    on_card = native.on_card(args.device)
    card = torch.cuda.get_device_name(args.device) if on_card else "cpu"
    measured = None
    if args.model_only:
        pass  # rebuild comm_model below from the stored local_steps
    elif args.measure_local:
        if not on_card:
            raise SystemExit("--measure_local needs the card (--device cuda)")
        gram_table = measure_gram_local(args.gram_n, args.gram_d, device=args.device)
        dia_table = measure_dia_local(args.num_rows, args.bandwidth, device=args.device)
        artifact["local_steps"] = {
            "platform": "gpu",
            "device": card,
            "gram": {"n": args.gram_n, "d": args.gram_d, "kernel": "matern32 K1 (csrc/gram_matvec.cu)",
                     "rows_table": {str(k): v for k, v in gram_table.items()}},
            "dia": {"n": args.num_rows, "bandwidth": args.bandwidth, "kernel": "K4 (csrc/dia.cu)",
                    "rows_table": {str(k): v for k, v in dia_table.items()}},
            "link": measure_link(max(dia_table), device=args.device),
        }
    else:
        measured = measured_virtual_mesh(args.num_rows, args.bandwidth, args.depth, args.reps,
                                         device=args.device)
        artifact["measured"] = measured[0]
        artifact["virtual_mesh"] = True
        artifact["platform"] = "gpu" if on_card else "cpu"
        artifact["device"] = card
        artifact["caveat"] = (
            "P partitions of one card (parallel.device_mesh; K11 reads each neighbour's halo in place): "
            "the times show the partitioned path's cost on one card, not scaling across cards, and there is "
            "no link between cards until ROADMAP A13; see comm_model for the analytical statement."
        )
    steps = artifact.get("local_steps")
    if steps:
        bw, lat, source = link_constants(artifact, link_bytes_per_s=args.link_bytes_per_s,
                                         link_latency_s=args.link_latency_s)
        artifact["comm_model"] = comm_model(steps, link_bytes_per_s=bw, link_latency_s=lat, link_source=source)
    with open(artifact_path, "w") as fp:
        json.dump(artifact, fp, indent=2)
    print(f"wrote {artifact_path}", flush=True)
    return artifact, measured


if __name__ == "__main__":
    main()
