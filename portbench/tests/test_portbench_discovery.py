"""A new cell, configuration, traffic mix, runner, reference and per-layer
metric need only new files and new entries: shown in a copy of the
benchmark to which a dummy of each is added, no file of it edited."""

import filecmp
import json
import shutil
import time

from portbench import core
from portbench.tests import tiny

DUMMY_RUNNER = '''
import time


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed

    def setup(self):
        self.value = self.config["size"] * self.traffic["rate"]

    def window(self, seconds):
        start = time.perf_counter()
        self.done = 0
        while time.perf_counter() - start < seconds:
            self.done += 1
        self.elapsed = time.perf_counter() - start

    def end_to_end(self):
        return {"dummy_per_s": self.done / self.elapsed}

    def counts(self):
        return self.done, 0

    def facts(self):
        return {"done": self.done}

    def handoff(self):
        return {"value": self.value}

    def close(self):
        pass
'''
DUMMY_REFERENCE = '''
def compare(config, traffic, seed, handoff, device):
    return {"gap": abs(handoff["value"] - config["size"] * traffic["rate"])}, []
'''
DUMMY_METRIC = '''
def read(run):
    return float(run.facts["done"])
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _add_dummy(root):
    base = root / "portbench"
    (base / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "size": 3}))
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps({"runner": "dummy", "rate": 2}))
    (base / "runners" / "dummy.py").write_text(DUMMY_RUNNER)
    (base / "reference" / "dummy.py").write_text(DUMMY_REFERENCE)
    (base / "limits" / "dummy.dummy-mix.json").write_text(json.dumps({"limits": {"gap": 0}}))
    (base / "metrics" / "dummy.done.py").write_text(DUMMY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["dummy.dummy-mix"]})
    bench["per_layer"].append({"name": "dummy.done", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "dummy", "moves": "dummy_per_s",
                               "workloads": ["dummy.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_files_make_a_cell_without_an_edit(tmp_path):
    root = _copy(tmp_path)
    _add_dummy(root)
    for sub in ("", "configs", "traffic", "runners", "reference", "limits", "metrics", "yardstick"):
        cmp = filecmp.dircmp(tiny.ROOT / "portbench" / sub, root / "portbench" / sub)
        assert not cmp.diff_files, sub
    spec = core.find_cell(root, "dummy.dummy-mix")
    assert [m["name"] for m in spec.per_layer] == ["dummy.done"]
    assert [m["name"] for m in spec.end_to_end] == ["setup_s", "dummy_per_s"]
    result, lines = core.run_cell(root, "dummy.dummy-mix", seed=1, seconds=0.05, trace=False,
                                  t0=time.perf_counter(), require_card=False)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"setup_s", "dummy_per_s"}
    metric = core.load_module(root / "portbench" / "metrics" / "dummy.done.py", "dummy.done")
    assert metric.read(type("Run", (), {"facts": {"done": 4}})) == 4.0


def test_existing_cells_keep_their_pieces(tmp_path):
    root = _copy(tmp_path)
    _add_dummy(root)
    for name in (tiny.GP, tiny.VJP):
        ours, theirs = core.find_cell(tiny.ROOT, name), core.find_cell(root, name)
        assert ours.config == theirs.config and ours.traffic == theirs.traffic
        assert [m["name"] for m in ours.per_layer] == [m["name"] for m in theirs.per_layer]
