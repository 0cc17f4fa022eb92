"""The whole step's share of the cards' peak: the operations of one global
step, counted once on the benchmark's plain reference at the cell's shapes
(benchmark/counts/flops.py: forward, and the backward of what trains), times
those completed in the traced run's measured window, over the window's
time, against 989 TFLOP/s (dense bf16) a card of the run. The window runs
without the profiler, which runs only after it."""

from benchmark.counts import PEAK_BF16_FLOPS

LAYER = "whole step"
MOVES = "train_samples_per_s"
UNIT = "%"


def read(run):
    if run.get("profile") is None or run["kind"] != "train" or not run.get("flops_per_unit"):
        return None
    return 100.0 * run["flops_per_unit"] * run["units"] / run["window_s"] / (PEAK_BF16_FLOPS * run.get("chips", 1))
