"""The metrics' arithmetic on hand-made runs: rates over the whole window,
the 90th percentile and the median over all requests, rooflines and mfu from counts."""

import pytest

from benchmark.counts import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_HBM_BYTES
from benchmark.counts import attention, fps
from benchmark.harness.main import load_reader
from benchmark.harness.trace import busy_intervals, kernel_class


def _run(**kw):
    run = {"kind": "infer", "units": 10, "window_s": 5.0, "setup_s": 12.5, "latencies_s": [0.5] * 10,
           "frames_per_unit": 12, "samples_per_unit": 1, "chips": 1, "spans_ms": {}}
    run.update(kw)
    return run


def test_rates_take_all_the_work_over_all_the_window():
    assert load_reader("frames_per_s").read(_run()) == pytest.approx(10 * 12 / 5.0)
    assert load_reader("frames_per_s").read(_run(kind="train")) is None
    assert load_reader("train_samples_per_s").read(_run(kind="train", units=7, window_s=3.5)) == pytest.approx(2.0)
    assert load_reader("setup_s").read(_run()) == 12.5


def test_p90_is_over_every_request():
    lat = [0.1 * i for i in range(1, 11)]  # 0.1 .. 1.0 s
    got = load_reader("latency_p90_ms").read(_run(latencies_s=lat))
    assert got == pytest.approx(910.0)  # inclusive method: 0.9 + 0.1 * (9 * 0.9 - 8)
    assert load_reader("latency_p90_ms").read(_run(latencies_s=[0.2] * 50 + [1.0] * 50)) == pytest.approx(1000.0)


def test_p50_is_over_every_request():
    lat = [0.1 * i for i in range(1, 11)]
    assert load_reader("latency_p50_ms").read(_run(latencies_s=lat)) == pytest.approx(550.0)
    assert load_reader("latency_p50_ms").read(_run(latencies_s=[0.2] * 9 + [5.0])) == pytest.approx(200.0)
    assert load_reader("latency_p50_ms").read(_run(kind="train")) is None


def test_attention_launches_of_the_nested_net():
    shapes = attention.launches("depth-anything/DA3NESTED-GIANT-LARGE", 2, 6, 280, 504)
    tok = 20 * 36 + 1
    assert shapes.count((12, 24, tok, tok, 64)) == 26 and shapes.count((2, 24, 6 * tok, 6 * tok, 64)) == 14
    assert shapes.count((12, 16, tok, tok, 64)) == 24 and len(shapes) == 64


def test_attention_least_time_by_hand():
    one = attention.least_seconds([(1, 1, 100, 100, 64)])
    assert one["flops"] == 4 * 100 * 100 * 64 and one["bytes"] == 2 * 64 * 400
    assert one["least_s"] == pytest.approx(max(one["flops"] / PEAK_BF16_FLOPS, one["bytes"] / PEAK_HBM_BYTES))
    big = attention.least_seconds([(2, 24, 4326, 4326, 64)])
    assert big["least_s"] == pytest.approx(4 * 2 * 24 * 4326 ** 2 * 64 / PEAK_BF16_FLOPS)


def test_fps_least_time_by_hand():
    assert fps.least_seconds([(846720, 97455, 25000)]) == pytest.approx(9 * 25000 * 97455 / PEAK_FP32_FLOPS)
    assert fps.least_seconds([(10 ** 8, 10, 2)]) == pytest.approx((13 * 10 ** 8 + 16) / PEAK_HBM_BYTES)


def test_rooflines_idle_and_mfu_from_a_profile():
    # the profiled stretch's own time (1.6 s for 2 requests) is the profiler's, and enters neither idle nor mfu:
    # both take the window's time a request (5.0 s / 10), idle with the trace's busy time a request (0.8 s / 2)
    prof = {"units": 2, "window_s": 1.6, "busy_s": 0.8,
            "kernels_by_name": {"void flash_fwd_kernel<1, false>(...)": 0.02, "fps_kernel": 0.1, "gemm": 0.5}}
    run = _run(profile=prof, attention={"least_s": 0.004}, fps_least_s=0.01, flops_per_unit=9.89e12)
    assert load_reader("attn_fwd_roofline_pct").read(run) == pytest.approx(100 * 0.004 / 0.01)
    assert load_reader("fps_roofline_pct").read(run) == pytest.approx(100 * 0.01 / 0.05)
    assert load_reader("idle_share.infer").read(run) == pytest.approx(1 - 0.4 / 0.5)
    assert load_reader("idle_share.train").read(run) is None
    assert load_reader("mfu_pct.infer").read(run) == pytest.approx(100 * 9.89e12 * 10 / 5.0 / PEAK_BF16_FLOPS)
    assert load_reader("mfu_pct.train").read(run) is None
    train = _run(kind="train", units=16, window_s=4.0, profile=dict(prof, units=3, busy_s=0.6), flops_per_unit=1e12)
    assert load_reader("idle_share.train").read(train) == pytest.approx(1 - 0.2 / 0.25)
    assert load_reader("mfu_pct.train").read(train) == pytest.approx(100 * 1e12 * 16 / 4.0 / PEAK_BF16_FLOPS)
    assert load_reader("mfu_pct.infer").read(train) is None
    assert load_reader("attn_fwd_roofline_pct").read(_run()) is None  # nothing to read: no value, never 0


def test_spans_and_hooks_per_request():
    run = _run(units=4, spans_ms={"unprojection": 4.0, "pre_reduce": 8.0, "ball_query_downsample": 20.0,
                                  "fps_downsample": 8.0, "voxelize_vfe": 2.0, "sparse_encoder": 6.0,
                                  "bev_unet": 8.0})
    assert load_reader("point_path_ms").read(run) == pytest.approx(10.0)
    assert load_reader("refinement_ms").read(run) == pytest.approx(4.0)
    train = _run(kind="train", units=2, spans_ms={"forward": 300.0, "backward": 100.0, "optimizer": 20.0})
    assert [load_reader(n).read(train) for n in ("train_forward_ms", "train_backward_ms", "optimizer_ms")] == \
        pytest.approx([150.0, 50.0, 10.0])


def test_fps_selections_per_exchange_from_the_counters():
    reader = load_reader("fps_selections_per_exchange")
    assert reader.read(_run(fps_exchange={"selections": 6000, "exchanges": 100})) == pytest.approx(60.0)
    assert reader.read(_run(fps_exchange={"selections": 0, "exchanges": 0})) is None  # no FPS ran: nothing to read
    assert reader.read(_run()) is None
    assert reader.read(_run(kind="train", fps_exchange={"selections": 6000, "exchanges": 100})) is None


def test_busy_time_leaves_the_collectives_out():
    # NCCL 0-10 us under a GEMM 0-6 us, NCCL 20-30 us alone, a GEMM 40-50 us: 16 us of work
    kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 10.0), ("sm90_gemm", 0.0, 6.0),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 20.0, 30.0), ("sm90_gemm", 40.0, 50.0)]
    assert kernel_class(kernels[0][0]) == "NCCL collectives"
    assert busy_intervals(kernels) == [(0.0, 6.0), (40.0, 50.0)]
    # idle over two traced steps of 16 us busy, against 0.5 s a step in the window
    prof = {"units": 2, "window_s": 1.0, "busy_s": 16e-6, "kernels_by_name": {}}
    train = _run(kind="train", units=10, window_s=5.0, chips=4, profile=prof)
    assert load_reader("idle_share.train").read(train) == pytest.approx(1 - (16e-6 / 2) / 0.5)


def test_mfu_of_several_cards_is_over_their_peak():
    prof = {"units": 2, "window_s": 1.6, "busy_s": 0.8, "kernels_by_name": {}}
    one = _run(kind="train", units=16, window_s=4.0, profile=prof, flops_per_unit=4e12)
    four = dict(one, chips=4)
    assert load_reader("mfu_pct.train").read(four) == pytest.approx(load_reader("mfu_pct.train").read(one) / 4)
