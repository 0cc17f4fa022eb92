"""A configuration, a traffic mix, a cell and a per-layer metric are added as
files and entries only: the harness finds them by name, with no file of the
harness edited."""

import json

import torch

from benchmark.harness.main import cell_files, cell_metrics, run_cell
from benchmark.tests.tiny import make_tiny

NEW_METRIC = '''"""A metric added as a file: the window's requests."""

LAYER = "test layer"
MOVES = "frames_per_s"
UNIT = "requests"


def read(run):
    return float(run["units"])
'''


def test_files_added_by_name_are_found_and_run(tmp_path):
    torch.manual_seed(0)
    bench = make_tiny(tmp_path)
    (bench / "metrics" / "window_requests.py").write_text(NEW_METRIC)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["end_to_end"].append({"name": "window_requests", "unit": "requests", "better": "higher",
                                   "bound": 0.01, "source": "host_clock", "workloads": ["tiny-occ-infer"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    files = cell_files("tiny-occ-infer", bench)
    assert files["config"]["name"] == "tiny-occ" and files["traffic"]["batch"] == 2
    names = [n for n, _, _ in cell_metrics("tiny-occ-infer", manifest, bench)["end_to_end"]]
    assert {"setup_s", "frames_per_s", "window_requests"} <= set(names)
    res = run_cell("tiny-occ-infer", 2 ** 31 + 11, 0.2, False, device="cpu", bench=bench)
    assert res["metrics"]["window_requests"]["value"] == res["attempted"] >= 1
    assert res["metrics"]["window_requests"]["unit"] == "requests"
