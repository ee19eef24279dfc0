"""The readings that the limits of ``limits/<cell>.json`` are set from; the
benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--fault half_probes]

For each seed, at the cell's own sizes: the program's set-up and its
compared output (the GP cell: the window's first steps, which the
reference follows; the VJP cell: one request of each pool entry), judged by the plain reference: the
lower readings. With ``--control``, the reference in the nearest precision
below the configuration's, put in the program's place and judged the same
way: the upper readings. With ``--fault half_probes`` (training), the
program with half of each step's probes left out, the mean over the rest.
Prints one JSON line a seed and reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


def half_probes():
    from lanczos_adjoints_tpu_torch.train import gp as train_gp

    assemble = train_gp.assemble

    def halved(**kwargs):
        kwargs["sample"] = lambda probes: probes[: len(probes) // 2]
        return assemble(**kwargs)

    train_gp.assemble = halved
    return lambda: setattr(train_gp, "assemble", assemble)


FAULTS = {"half_probes": half_probes}


def program_handoff(spec, seed, device):
    import torch

    run = spec.runner.Cell(spec.config, spec.traffic, seed, device)
    run.setup()
    run.window(0.0)  # the GP cell: the compared steps; the VJP cell: one request
    if spec.traffic["runner"] == "lanczos_vjp":
        for p in range(len(run.pool)):
            _s, _e, _end, outputs, grads = run.request(p)
            run.kept[-1 - p] = (p, [o.detach() for o in outputs], [g.detach() for g in grads])
    handoff = run.handoff()
    run.close()
    torch.cuda.empty_cache()
    return handoff


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = parser.parse_args(argv)
    core.use_cache_dirs(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = core.find_cell(ROOT, args.workload)
    device, _desc = core.card(spec.cell["chips"], True)
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        handoff = program_handoff(spec, seed, device)
        ref = spec.reference.reference(spec.config, spec.traffic, handoff, device)
        numbers, left_out = spec.reference.judge(spec.config, handoff, ref, handoff)
        print(json.dumps({"seed": seed, "reading": "program", "numbers": numbers, "left_out": left_out,
                          "seconds": time.perf_counter() - start}), flush=True)
        if args.control:
            start = time.perf_counter()
            numbers = spec.reference.control(spec.config, spec.traffic, seed, handoff, device, ref)
            print(json.dumps({"seed": seed, "reading": "control", "numbers": numbers,
                              "seconds": time.perf_counter() - start}), flush=True)
        del handoff
        if args.fault:
            start = time.perf_counter()
            undo = FAULTS[args.fault]()
            try:
                handoff = program_handoff(spec, seed, device)
            finally:
                undo()
            numbers, left_out = spec.reference.judge(spec.config, handoff, ref, handoff)
            print(json.dumps({"seed": seed, "reading": f"fault:{args.fault}", "numbers": numbers,
                              "seconds": time.perf_counter() - start}), flush=True)
            del handoff
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
