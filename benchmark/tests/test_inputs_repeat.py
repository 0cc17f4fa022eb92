"""Inputs and weights repeat from a seed and differ between seeds."""

import json

import torch

from benchmark.harness.inputs import make_pool, rig_cam2lidar
from benchmark.families.resdet3d import build_program, build_reference
from benchmark.tests.tiny import TINY_TRAFFIC, make_tiny

SEED = 2 ** 31 + 5


def _cfg(tmp_path, name="tiny-det"):
    bench = make_tiny(tmp_path)
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def test_pools_repeat_from_a_seed(tmp_path):
    cfg = _cfg(tmp_path)
    for traffic in (TINY_TRAFFIC["tiny-infer"], TINY_TRAFFIC["tiny-train"]):
        a, b = make_pool(traffic, cfg, SEED, "cpu"), make_pool(traffic, cfg, SEED, "cpu")
        c = make_pool(traffic, cfg, SEED + 1, "cpu")
        assert len(a) == traffic["pool"]
        for x, y, z in zip(a, b, c):
            assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
            assert not torch.equal(x["img"], z["img"])
        assert not torch.equal(a[0]["img"], a[1]["img"])  # the requests of a pool differ
    assert rig_cam2lidar(2, 6).shape == (2, 6, 4, 4)


def test_weights_repeat_and_load_alike_into_program_and_reference(tmp_path):
    cfg = _cfg(tmp_path)
    p1, p2 = build_program(cfg, SEED, "cpu"), build_program(cfg, SEED, "cpu")
    ref, other = build_reference(cfg, SEED, "cpu"), build_program(cfg, SEED + 1, "cpu")
    s1, s2, sr, so = (m.state_dict() for m in (p1, p2, ref, other))
    assert s1.keys() == sr.keys()
    assert all(torch.equal(s1[k], s2[k]) and torch.equal(s1[k], sr[k]) for k in s1)
    assert any(not torch.equal(s1[k], so[k]) for k in s1)
