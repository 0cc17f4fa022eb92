"""A model family added as files only (a family file, a configuration, a
traffic mix, a cell and a metric), found by the configuration's
``model.type`` and run through ``run_cell`` with no harness file edited."""

import json

from benchmark.harness.main import cell_files, load_family, run_cell
from benchmark.tests.tiny import make_tiny

TOY_FAMILY = '''"""A toy family: one linear layer; a request is a forward over one pool
entry; the check holds each checked output against a plain matmul."""

import contextlib

import torch


class Family:
    def __init__(self, cfg, traffic, seed, device, control=False, rank=0, ranks=1):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.kept = {}

    def build(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.w = torch.randn(self.cfg["model"]["width"], self.cfg["model"]["width"], generator=gen)
        self.model = lambda x: torch.nn.functional.linear(x, self.w)

    def make_inputs(self):
        gen = torch.Generator().manual_seed(self.seed + 1)
        self.pool = [torch.randn(self.traffic["batch"], self.cfg["model"]["width"], generator=gen)
                     for _ in range(self.traffic["pool"])]

    def make_client(self):
        self.client = lambda i: self.model(self.pool[i % len(self.pool)])
        return self.client

    def precision(self):
        return contextlib.nullcontext()

    def warm_up(self, timed):
        timed(0)

    def keep(self, i, res):
        self.kept[i] = res.clone()

    def reset_counters(self):
        pass

    def counters(self):
        return {"toy_requests_seen": 1}

    def info(self):
        return {}

    def record(self, to_host=False):
        return self.kept

    def free(self):
        self.model = self.client = None

    def readings(self, records, flops):
        with flops:
            refs = {j: self.pool[j % len(self.pool)] @ self.w.T for j in records[0]}
        return [{"out_gap": float((records[0][j] - refs[j]).abs().max())} for j in sorted(records[0])]

    def counts(self):
        return {}


FAULTS = {}
'''

TOY_METRIC = '''"""The toy cell's counter, read after the window."""

LAYER = "toy"
MOVES = "frames_per_s"
UNIT = "requests"


def read(run):
    return run.get("toy_requests_seen")
'''


def test_a_family_added_as_files_runs_through_the_harness(tmp_path):
    bench = make_tiny(tmp_path)
    (bench / "families" / "toy.py").write_text(TOY_FAMILY)
    (bench / "metrics" / "toy_requests_seen.py").write_text(TOY_METRIC)
    (bench / "configs" / "toy-linear.json").write_text(json.dumps(
        {"name": "toy-linear", "reduced": [], "model": {"type": "Toy", "width": 16}}))
    (bench / "traffic" / "toy-infer.json").write_text(json.dumps(
        {"kind": "infer", "batch": 3, "views": 1, "pool": 2, "checked": 2, "check_from": 2}))
    (bench / "workloads" / "toy-infer.json").write_text(json.dumps(
        {"config": "toy-linear", "traffic": "toy-infer", "chips": 1, "why": "CPU test",
         "limits": {"out_gap": 1e-5}}))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy-linear", "source": "a test", "file": "benchmark/configs/toy-linear.json",
                                "reduced": [], "why": "CPU test"})
    manifest["workloads"].append({"name": "toy-infer", "config": "toy-linear", "traffic": "toy-infer", "chips": 1,
                                  "why": "CPU test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("toy-infer")
    manifest["per_layer"].append({"name": "toy_requests_seen", "unit": "requests", "better": "higher",
                                  "source": "program_counter", "layer": "toy", "moves": "frames_per_s",
                                  "workloads": ["toy-infer"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    assert load_family(cell_files("toy-infer", bench)["config"], bench).__name__ == "benchmark_family_toy"
    res = run_cell("toy-infer", 2 ** 31 + 17, 0.2, False, device="cpu", bench=bench)
    assert res["correct"] and res["readings"]["out_gap"] < 1e-5, res["checks"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"} and res["metrics"]["frames_per_s"]["value"] > 0
    traced = run_cell("toy-infer", 2 ** 31 + 17, 0.2, True, device="cpu", bench=bench)
    assert traced["metrics"]["toy_requests_seen"] == {"value": 1.0, "unit": "requests"}
    assert res["device"]["count"] == 1 and res["run"]["frames_per_unit"] == 3


def test_the_configurations_name_their_family():
    for cell in ("occ-infer-b2", "det-infer-b1", "occ-train-b1"):
        fam = load_family(cell_files(cell)["config"])
        assert callable(fam.Family) and fam.FAULTS and fam.__name__ == "benchmark_family_resdet3d"
