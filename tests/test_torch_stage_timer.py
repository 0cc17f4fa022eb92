"""``utils/stage_timer.py`` on the CPU: the span records (parent, unit id,
host and host-self time), the do-nothing path, the host ranges a
``torch.profiler`` trace shows, the spans of a request, a pipelined step and a
train step of ``configs/resdet3d_tiny_centerhead_test.py`` (its any-view
DA3 joined to a ViT-S metric net, so that the nested net's alignment runs),
and the benchmark's readers of those spans on hand-made runs."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.main import load_reader
from recondet3d_torch.cli.train import build_model_from_cfg
from recondet3d_torch.core.config import load_py_config
from recondet3d_torch.models.da3.dpt import DPT
from recondet3d_torch.models.da3.net import DepthAnything3Net, NestedDepthAnything3Net
from recondet3d_torch.models.da3.vit import DinoViT
from recondet3d_torch.train import Trainer
from recondet3d_torch.utils import stage_timer
from recondet3d_torch.utils.stage_timer import collect, stage

CONFIG = "configs/resdet3d_tiny_centerhead_test.py"


def _tree(times):
    return [(s.name, None if s.parent is None else s.parent.name, s.unit) for s in times.records]


def test_nested_stages_record_parent_unit_and_host_times():
    with collect() as times:
        for _ in range(2):
            with stage("request", unit=True):
                with stage("a"):
                    torch.ones(64).cumsum(0)
                    with stage("b"):
                        torch.ones(64).sum()
                with stage("a"):
                    pass
        with stage("c"):
            pass
    assert _tree(times) == [("request", None, 0), ("a", "request", 0), ("b", "a", 0), ("a", "request", 0),
                            ("request", None, 1), ("a", "request", 1), ("b", "a", 1), ("a", "request", 1),
                            ("c", None, None)]
    assert (times["request/calls"], times["a/calls"], times["b/calls"], times["c/calls"]) == (2, 4, 2, 1)
    for s in times.records:
        children = sum(c.host_ms for c in times.records if c.parent is s)
        assert s.host_ms >= children >= 0.0
    assert times["request/host_self_ms"] == pytest.approx(times["request/host_ms"] - times["a/host_ms"], abs=1e-9)
    assert times["a/host_self_ms"] == pytest.approx(times["a/host_ms"] - times["b/host_ms"], abs=1e-9)
    assert times["c/host_self_ms"] == times["c/host_ms"] >= 0.0
    # device ms only where CUDA records them
    assert ("a" in times) == torch.cuda.is_available()


def test_stage_does_nothing_when_off_and_collect_closes_on_errors():
    assert stage_timer._recorder is None and not torch.autograd._profiler_enabled()
    off = stage("x")
    assert off is stage("y", unit=True)  # one shared do-nothing context, nothing allocated
    with off:
        pass
    with collect() as times:
        with pytest.raises(RuntimeError, match="not re-entrant"):
            with collect():
                pass
        with pytest.raises(ValueError):
            with stage("outer", unit=True):
                with stage("inner"):
                    raise ValueError
        with stage("after"):
            pass
    assert _tree(times) == [("outer", None, 0), ("inner", "outer", 0), ("after", None, None)]
    assert stage_timer._recorder is None
    with collect() as empty:
        pass
    assert empty == {} and empty.records == []


def test_stages_are_host_ranges_of_the_profiler_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collect() as times:
            with stage("outer", unit=True):
                with stage("inner"):
                    torch.ones(8).add_(1)
        with stage("alone"):
            torch.ones(8).mul_(2)
    events = {e.name: e for e in prof.events() if e.name in ("outer", "inner", "alone")}
    assert set(events) == {"outer", "inner", "alone"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
    assert events["inner"].cpu_parent is events["outer"] and events["alone"].cpu_parent is None
    outer, inner = events["outer"].time_range, events["inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert _tree(times) == [("outer", None, 0), ("inner", "outer", 0)]


@pytest.fixture(scope="module")
def tiny():
    """The tiny detection config on the CPU, its DA3 nested with a ViT-S metric net; B=1, two views."""
    model = build_model_from_cfg(load_py_config(CONFIG), device="cpu", generator=torch.Generator().manual_seed(0))
    bk = model.reconstruction_backbone
    torch.manual_seed(0)
    metric = DepthAnything3Net(net=DinoViT("vits", out_layers=(5, 7, 9, 11), cat_token=False, device="cpu"),
                               head=DPT(384, 1, 64, (48, 96, 192, 384), device="cpu"))
    bk.da3 = NestedDepthAnything3Net(bk.da3, metric).eval()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 2, 60, 80, 3)).astype(np.float32))
    c2l = torch.eye(4).expand(1, 2, 4, 4).clone()
    gt = torch.from_numpy((rng.uniform(-1, 1, (1, 512, 3)) * np.array([7.5, 7.5, 1.9])).astype(np.float32))
    return model, img, c2l, gt


# the spans of one request of the nested net at B=1 and their parents
REQUEST = {"request": (1, None), "da3": (1, "request"), "da3_input": (1, "da3"), "da3_trunk": (2, "da3"),
           "da3_heads": (2, "da3"), "da3_align": (1, "da3"), "unprojection": (1, "request"),
           "pre_reduce": (1, "request"), "ball_query_downsample": (1, "request"), "fps_downsample": (1, "request"),
           "voxelize_vfe": (1, "request"), "sparse_encoder": (1, "request"), "bev_unet": (1, "request"),
           "det_head": (1, "request")}


def test_requests_and_decode_give_every_span(tiny):
    model, img, c2l, _ = tiny
    model.eval()
    with collect() as times:
        for _ in range(2):
            out = model.simple_test(img, c2l)
            model.pts_bbox_head.decode(out["det_preds"])
    for name, (calls, parent) in REQUEST.items():
        assert times[name + "/calls"] == 2 * calls, name
        assert {p for n, p, _ in _tree(times) if n == name} == {parent}, name
    assert times["decode/calls"] == 2 and times["nms/calls"] == 2  # one scene a request, with boxes
    units = [(n, u) for n, _, u in _tree(times)]
    first = units.index(("request", 1))
    assert {u for n, u in units[:first] if n not in ("decode", "nms")} == {0}
    assert {u for n, u in units if n in ("decode", "nms")} == {None}  # decode runs outside the request
    assert 0.0 <= times["request/host_self_ms"] < times["request/host_ms"]


def test_a_pipelined_step_is_a_request(tiny):
    model, img, c2l, _ = tiny
    model.eval()
    bk = model.reconstruction_backbone
    with torch.no_grad():
        depth, intr, _ = bk.predict_depth(img)
    with collect() as times:
        model.pipelined_test_step(depth, intr, img, img, c2l)
    for name, (calls, parent) in REQUEST.items():
        assert times[name + "/calls"] == calls, name
        assert {p for n, p, _ in _tree(times) if n == name} == {parent}, name
    assert {u for _, _, u in _tree(times)} == {0}


def test_a_train_step_gives_every_span(tiny):
    model, img, c2l, gt = tiny
    trainer = Trainer(model=model, total_steps=10, frozen_patterns=("da3",))
    state = trainer.init_state()
    batch = dict(img=img, cam2lidar_rts=c2l, gt_points=gt)
    with collect() as times:
        state, history = trainer.run(state, iter([batch, batch]), max_steps=2)
    model.eval()
    parents = {"train_step": None, "forward": "train_step", "backward": "train_step", "optimizer": "train_step",
               "metrics_readback": "train_step", "da3": "forward", "da3_trunk": "da3", "da3_align": "da3",
               "gt_occupancy_map": "forward"}
    for name, parent in parents.items():
        assert {p for n, p, _ in _tree(times) if n == name} == {parent}, name
        assert times[name + "/calls"] == 2 * (1 + (name == "da3_trunk")), name
    assert [u for n, _, u in _tree(times) if n == "train_step"] == [0, 1]
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])
    assert 0.0 <= times["train_step/host_self_ms"] < times["train_step/host_ms"]


def _run(kind, spans, units=4):
    return {"kind": kind, "units": units, "window_s": 5.0, "setup_s": 1.0, "latencies_s": [0.5] * units,
            "frames_per_unit": 6, "samples_per_unit": 1, "spans_ms": spans, "hooks_ms": {}, "decode_s": []}


INFER_SPANS = {"da3": 40.0, "da3_input": 4.0, "da3_trunk": 20.0, "da3_heads": 12.0, "det_head": 2.0,
               "decode/host_ms": 6.0, "unprojection/host_ms": 1.0, "pre_reduce/host_ms": 2.0,
               "ball_query_downsample/host_ms": 3.0, "fps_downsample/host_ms": 4.0, "request/host_ms": 100.0,
               "request/host_self_ms": 5.0}
TRAIN_SPANS = {"da3": 80.0, "metrics_readback/host_ms": 12.0, "train_step/host_ms": 400.0,
               "train_step/host_self_ms": 8.0}


@pytest.mark.parametrize("name, kind, value", [
    ("da3_ms.infer", "infer", 10.0), ("da3_input_ms", "infer", 1.0), ("da3_trunk_span_ms", "infer", 5.0),
    ("da3_heads_span_ms", "infer", 3.0), ("det_head_span_ms", "infer", 0.5), ("decode_host_ms", "infer", 1.5),
    ("point_path_host_ms", "infer", 2.5), ("untraced_host_share.infer", "infer", 0.05),
    ("da3_ms.train", "train", 20.0), ("metrics_readback_host_ms", "train", 3.0),
    ("untraced_host_share.train", "train", 0.02),
])
def test_span_readers(name, kind, value):
    reader = load_reader(name)
    spans = INFER_SPANS if kind == "infer" else TRAIN_SPANS
    assert reader.read(_run(kind, spans)) == pytest.approx(value)
    other = "train" if kind == "infer" else "infer"
    assert reader.read(_run(other, dict(INFER_SPANS, **TRAIN_SPANS))) is None
    assert reader.read(_run(kind, {})) is None  # a program without the span: nothing to read, never 0
