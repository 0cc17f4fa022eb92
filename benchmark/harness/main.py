"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Everything that belongs to a cell is found by name: the cell's file
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``) and its traffic
(``benchmark/traffic/<traffic>.json``); ``BENCHMARK.json`` lists the metrics
the cell reports, and each metric is read by ``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark.counts.flops import FlopCount
from benchmark.harness import check as chk
from benchmark.harness.inputs import sub_seed
from benchmark.harness.ranks import Place, Ranks, agree, gather
from benchmark.harness.trace import profile_stretch

__all__ = ["ROOT", "BANNED", "banned_modules", "cell_files", "cell_metrics", "load_family", "load_reader", "run_cell",
           "main"]

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED = ("jax", "jaxlib", "flax", "recondet3d")


class NoDevice(RuntimeError):
    pass


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (default: the loaded
    modules), each module's name cut at its first dot and compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in BANNED})


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, bench: Path = BENCH) -> Dict:
    """The cell's workload, configuration and traffic files, read."""
    work = _json(bench / "workloads" / f"{cell}.json")
    return {"workload": work, "config": _json(bench / "configs" / f"{work['config']}.json"),
            "traffic": _json(bench / "traffic" / f"{work['traffic']}.json")}


def load_reader(name: str, bench: Path = BENCH):
    """The reader module of metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, manifest: Dict, bench: Path = BENCH) -> Dict[str, List]:
    """{'end_to_end': [(name, unit, reader)], 'per_layer': [...]}: the
    metrics ``BENCHMARK.json`` gives this cell (those without a
    ``workloads`` key go to every cell)."""
    out = {}
    for part in ("end_to_end", "per_layer"):
        out[part] = [(m["name"], m["unit"], load_reader(m["name"], bench)) for m in manifest[part]
                     if "workloads" not in m or cell in m["workloads"]]
    return out


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _smi() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def load_family(cfg: Dict, bench: Path = BENCH):
    """The family of a configuration: ``benchmark/families/<name>.py``, where
    the name is the configuration's ``model.type`` in lower case. Its
    ``Family`` drives the program, the control and the check (see
    ``families/resdet3d.py``), and ``FAULTS`` names the faults the harness's
    tests plant."""
    name = cfg["model"]["type"].lower()
    path = bench / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault: Optional[str] = None, t_start: Optional[float] = None, bench: Path = BENCH,
             control: bool = False, place: Place = Place()) -> Optional[Dict]:
    """One run of ``cell`` as the rank ``place`` says; returns, on rank 0,
    the result record (the result line's keys, and ``readings``, ``run``),
    and None on every other rank. ``fault`` (a name in the family's
    ``FAULTS``) breaks the timed path underneath (the harness's own tests);
    ``control`` puts the reference, computed one precision lower, in the
    program's place: for a cell of several ranks, in one process over the
    global batch."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {"imports": time.perf_counter() - t_start}

    def phase(name):  # seconds since the last phase ended, for the info line
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    files = cell_files(cell, bench)
    work, cfg, traffic = files["workload"], files["config"], files["traffic"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    need = 1 if control else int(work.get("chips", 1))
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < need):
        raise NoDevice(f"{cell} needs {need} CUDA device(s); torch.cuda.is_available()={torch.cuda.is_available()}")
    if on_card:
        dev = torch.device("cuda", place.rank)
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    manifest = _json(bench.parent / "BENCHMARK.json")
    metrics = cell_metrics(cell, manifest, bench)
    kind = traffic["kind"]
    lead = place.rank == 0

    family = load_family(cfg, bench)
    fam = family.Family(cfg, traffic, seed, dev, control=control, rank=place.rank, ranks=place.ranks)
    fam.build()
    sync()
    phase("model")
    fam.make_inputs()
    sync()
    phase("inputs")
    if place.ranks > 1:
        from recondet3d_torch.parallel.distributed import init_distributed

        init_distributed(device, init_method=place.init_method, world_size=place.ranks, rank=place.rank)
        if place.joined is not None:
            place.joined.set()
        phase("group")
    client = fam.make_client()
    if fault is not None:
        family.FAULTS[fault](fam.model, client)
    phase("client")

    def timed(i):
        with fam.precision():
            return client(i)

    checked = set()
    if "checked" in traffic:
        checked = sorted({int(i) for i in torch.randint(0, int(traffic.get("check_from", 4)),
                                                        (int(traffic["checked"]),),
                                                        generator=torch.Generator().manual_seed(sub_seed(seed, 3)))})
    fam.warm_up(timed)
    sync()
    fam.reset_counters()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    smi_before = _smi() if on_card and lead else None
    setup_s = time.perf_counter() - t_start
    phase("warmup")

    # the measured window: a closed loop of one client a rank; rank 0's clock ends it
    span_ctx = None
    if trace and on_card:
        from recondet3d_torch.utils import stage_timer

        span_ctx = stage_timer.collect()
    spans: Dict = {}
    lat: List[float] = []
    min_units = max(checked) + 1 if checked else 1
    with (span_ctx if span_ctx is not None else contextlib.nullcontext()) as spans_out:
        w0 = time.perf_counter()
        i = 0
        while True:
            r0 = time.perf_counter()
            res = timed(i)
            sync()
            r1 = time.perf_counter()
            lat.append(r1 - r0)
            if i in checked:
                fam.keep(i, res)
            i += 1
            stop = r1 - w0 >= seconds and i >= min_units
            if place.ranks > 1:
                stop = agree(stop, dev)
            if stop:
                break
        window_s = time.perf_counter() - w0
    if span_ctx is not None:
        spans = dict(spans_out)
    units = i
    counters = fam.counters()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    info = {"cell": cell, "seed": seed, "rank": place.rank, "units": units, "window_s": window_s,
            "setup_s": setup_s, "setup_phases_s": phases, "memory_peak_bytes": peak, "nvidia_smi_before": smi_before,
            "nvidia_smi_after": _smi() if on_card and lead else None, "spans_ms": spans, **counters, **fam.info()}
    ranks = place.ranks
    run = {"kind": kind, "units": units, "window_s": window_s, "setup_s": setup_s, "latencies_s": lat,
           "frames_per_unit": int(traffic["batch"]) * int(traffic["views"]) * ranks,
           "samples_per_unit": int(traffic["batch"]) * ranks, "chips": ranks, "spans_ms": spans, **counters}
    profile = None
    if trace and on_card:
        profile = run["profile"] = profile_stretch(lambda j: (timed(units + j), sync()),
                                                   int(traffic.get("profile_units", 3)))
        info["profile_kernels_top"] = sorted(profile["kernels_by_name"].items(), key=lambda kv: -kv[1])[:25]
        info["profile_annotations_left_out"] = profile["annotations_left_out"]
    print(json.dumps({"info": info}), flush=True)

    # the check: every rank's record on rank 0, the program freed, the reference at the stated precision
    busy = profile["busy_s"] if profile is not None else None
    shares = gather({"record": fam.record(to_host=ranks > 1), "peak": peak, "busy_s": busy}, place)
    fam.free()
    del client, timed
    sync()
    if on_card:
        torch.cuda.empty_cache()
    if ranks > 1:
        import torch.distributed as dist

        dist.barrier()
        if not lead:
            return None
    flops = FlopCount()
    t_ref = time.perf_counter()
    readings_all = fam.readings([s["record"] for s in shares], flops)
    ref_s = time.perf_counter() - t_ref
    readings = {k: max(r[k] for r in readings_all) for k in readings_all[0]}
    limits = {k: float(v) for k, v in work.get("limits", {}).items()}
    correct = bool(limits) and chk.verdict(readings, limits)

    # the counts behind rooflines and mfu, per request or step
    run.update(fam.counts())
    run["flops_per_unit"] = flops.total
    run["device_kind"] = torch.cuda.get_device_name(dev) if on_card else "cpu"

    part = "per_layer" if trace else "end_to_end"
    values = {}
    for name, unit, reader in metrics[part]:
        v = reader.read(run)
        if v is not None:
            values[name] = {"value": float(v), "unit": unit}
    device = {"platform": "gpu" if on_card else "cpu", "kind": run["device_kind"], "count": ranks,
              "memory_peak_bytes": int(max(s["peak"] for s in shares))}
    if profile is not None:
        device.update(busy_s=sum(s["busy_s"] for s in shares) / ranks, window_s=profile["window_s"])
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": values, "device": device}
    if profile is not None:
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {k: {"value": readings.get(k), "limit": limits[k]} for k in sorted(limits)}
    result["readings"] = readings
    result["reference_s"] = ref_s
    result["run"] = run
    return result


# a run's limit is 360 s, and 1200 s where it builds the kernels
DEADLINE_S = 1150.0


def main(argv=None, t_start: Optional[float] = None, bench: Path = BENCH, device: str = "cuda") -> int:
    """The command: one run of a cell, its result line last on standard
    output (rank 0's, for a cell of several ranks, which this process starts
    and is rank 0 of). ``bench`` and ``device`` are for the harness's tests."""
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run = dict(cell=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    files = cell_files(args.workload, bench)
    n = int(files["traffic"].get("ranks", 1))
    try:
        chips = int(files["workload"].get("chips", 1))
        if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
            raise NoDevice(f"{args.workload} needs {chips} CUDA devices; "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} are visible")
        with Ranks(n, [run], device, bench, DEADLINE_S) as group:
            res = run_cell(**run, device=device, t_start=t_start, bench=bench, place=group.place())
    except NoDevice as e:
        _log(f"benchmark: {e}")
        return 2
    found = banned_modules()
    if found:
        _log(f"benchmark: modules that must not load are loaded: {found}")
        return 3
    print(json.dumps({"readings": res["readings"], "reference_s": res["reference_s"]}), flush=True)
    for k, c in res["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps(line), flush=True)
    return 0
