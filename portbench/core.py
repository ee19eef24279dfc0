"""One run of one cell: find its pieces by name, set up, measure, compare, report.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Each
piece is a file of its own, found by name:

- ``configs/<config>.json``: the sizes, as run;
- ``traffic/<mix>.json``: the mix's parameters, with ``"runner"``, the
  general runner that reads them;
- ``runners/<runner>.py``: ``Cell(config, traffic, seed, device)`` with
  ``setup()``, ``window(seconds)``, ``end_to_end()``, ``counts()``,
  ``facts()``, ``handoff()`` and ``close()``, and optionally
  ``diagnostics()`` (host-clock readings printed under ``host``);
- ``reference/<runner>.py``: ``compare(config, traffic, seed, handoff,
  device) -> (numbers, left_out)``, the plain reference's judgement;
- ``limits/<cell>.json``: each compared number's limit;
- ``metrics/<metric>.py``: ``read(run) -> float | None`` for a per-layer
  metric.
"""

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

from portbench.yardstick import compare, guard

HERE = Path(__file__).resolve().parent


class NoCard(RuntimeError):
    """The run needs more cards than the machine has."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a piece of the benchmark from its file (names may hold dots and dashes)."""
    if not path.is_file():
        msg = f"no file {path}"
        raise FileNotFoundError(msg)
    spec = importlib.util.spec_from_file_location(f"portbench_piece_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with every piece it names, loaded."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        msg = f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}"
        raise KeyError(msg)
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / bench["paths"][0]
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return SimpleNamespace(
        name=name, cell=cell, config=config, traffic=traffic, limits=limits["limits"], base=base,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        runner=load_module(base / "runners" / f"{traffic['runner']}.py", traffic["runner"]),
        reference=load_module(base / "reference" / f"{traffic['runner']}.py", f"ref_{traffic['runner']}"),
    )


def use_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.

    The port builds its CUDA sources into ``lanczos_adjoints_tpu_torch/_build/``
    itself; these cover what PyTorch, Triton and CUDA would cache, and the
    GP reference's elementwise expressions (``PYTORCH_KERNEL_CACHE_PATH``,
    which PyTorch uses only if the directory exists).
    """
    cache = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
        os.environ[var] = str(cache / sub)
    (cache / "kernels").mkdir(parents=True, exist_ok=True)


def card(chips: int, require: bool) -> tuple:
    """``(device, description)``; raises ``NoCard`` when ``require`` and the chips are missing."""
    import torch

    if not require:
        return "cpu", {"platform": "cpu", "kind": "cpu", "count": 1}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        msg = f"the cell needs {chips} CUDA device(s); this machine has {have}"
        raise NoCard(msg)
    return "cuda", {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def run_cell(root: Path, name: str, *, seed: int, seconds: float, trace: bool, t0: float,
             require_card: bool = True, found=None) -> tuple:
    """Run one cell once; returns ``(result, check_lines)``.

    ``found`` (a ``find_cell`` result) may replace the lookup, as the tests
    do to run a cell at a size the CPU holds; ``require_card=False`` runs
    it on the CPU.
    """
    import torch

    # The configurations state float32 with TF32 off, for the program and
    # the reference alike.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = found or find_cell(root, name)
    device, desc = card(spec.cell["chips"], require_card)
    run = spec.runner.Cell(spec.config, spec.traffic, seed, device)
    run.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"portbench: {name} seed {seed}: set-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    trace_data = None
    if trace:
        if device != "cuda":
            msg = "a traced run reads the device's profile; it needs the card"
            raise NoCard(msg)
        from portbench.yardstick.trace import profiled

        with profiled() as holder:
            run.window(min(seconds, spec.traffic.get("trace_seconds", seconds)))
        trace_data = holder.trace
    else:
        run.window(seconds)
    if device == "cuda":
        torch.cuda.synchronize()
        desc["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        desc["memory_peak_bytes"] = 0
    found_mods = guard.forbidden_loaded()
    if found_mods:
        msg = f"forbidden modules loaded in the benchmark process: {found_mods}"
        raise RuntimeError(msg)

    end_to_end = {"setup_s": setup_s, **run.end_to_end()}
    attempted, failed = run.counts()
    facts = run.facts()
    diagnostics = run.diagnostics() if hasattr(run, "diagnostics") else {}
    handoff = run.handoff()
    run.close()
    del run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    print(f"portbench: window and its reading {t_ref - t0 - setup_s:.3f} s", file=sys.stderr, flush=True)
    numbers, left_out = spec.reference.compare(spec.config, spec.traffic, seed, handoff, device)
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    del handoff
    correct, checks = compare.verdict(numbers, spec.limits, left_out)

    if trace:
        ctx = SimpleNamespace(config=spec.config, traffic=spec.traffic, trace=trace_data, facts=facts)
        metrics = {}
        for m in spec.per_layer:
            value = load_module(spec.base / "metrics" / f"{m['name']}.py", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        desc["busy_s"] = trace_data.busy_s()
        desc["window_s"] = trace_data.window_s
    else:
        metrics = {m["name"]: {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": desc}
    if trace:
        result["breakdown"] = {"device_ops": trace_data.top_ops(), "idle_gaps": trace_data.idle_gaps()}
    result["host"] = diagnostics
    result["card"] = power_limit() if device == "cuda" else "cpu"
    result["left_out"] = sorted(left_out)
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines


def main(argv=None, *, t0: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = HERE.parent
    use_cache_dirs(root)
    try:
        result, lines = run_cell(root, args.workload, seed=args.seed, seconds=args.seconds,
                                 trace=bool(args.trace), t0=t0)
    except NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail, print no result
        traceback.print_exc()
        return 1
    found_mods = guard.forbidden_loaded()
    if found_mods:
        print(f"portbench: forbidden modules loaded: {found_mods}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

