"""Sweep the FPS kernel's launch shape on the card.

    python -m recondet3d_torch.tools.fps_sweep [--n 393216] [--valid 78000] [--k 25000]

For every (blocks, threads) pair it times the grid-wide exchange alone
(``exchange_probe``) and the kernel on a synthetic street-sized cloud, and
checks that every launch shape returns the index sequence of the plain
PyTorch version. One JSON line per pair; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from recondet3d_torch.ops import fps as fps_ops
from recondet3d_torch.ops.sampling import furthest_point_sample_plain


def _time_ms(fn, iters=2):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=393216)
    ap.add_argument("--valid", type=int, default=78000)
    ap.add_argument("--k", type=int, default=25000)
    ap.add_argument("--blocks", type=int, nargs="+", default=[27, 33, 44, 66, 88, 132])
    ap.add_argument("--threads", type=int, nargs="+", default=[256, 512, 1024])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fps_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32) * np.array([54.0, 54.0, 5.5], np.float32)
    pts = torch.from_numpy(pts).cuda()
    valid = torch.arange(args.n, device="cuda") < args.valid
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    ref = furthest_point_sample_plain(pts, args.k, valid).to(torch.int32)
    for blocks in args.blocks:
        for threads in args.threads:
            row = dict(N=args.n, n_valid=args.valid, K=args.k, blocks=blocks, threads=threads)
            try:
                got = fps_ops.furthest_point_sample_cuda(pts, valid, start, args.k, threads=threads, blocks=blocks)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(json.dumps(dict(row, error=str(e))), flush=True)
                continue
            row["identical_to_plain"] = bool(torch.equal(got, ref))
            row["exchange_us"] = 1e3 * _time_ms(
                lambda: fps_ops.exchange_probe(args.k, threads=threads, blocks=blocks)) / (args.k - 1)
            row["kernel_ms"] = _time_ms(
                lambda: fps_ops.furthest_point_sample_cuda(pts, valid, start, args.k, threads=threads, blocks=blocks))
            row["us_per_selection"] = 1e3 * row["kernel_ms"] / args.k
            print(json.dumps(row), flush=True)
            if not row["identical_to_plain"]:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
