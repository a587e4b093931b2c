#!/usr/bin/env python3
"""Time ``csrc/lstm_layer_bwd.cu`` over batch and hidden widths at one T,
to show how a step of its recurrence splits between the serial exchange
(the cluster barrier, which does not grow with the work) and the block's
partial product (which grows with the rows a cluster walks and with H).

    python3 tools/lstm_layer_bwd_scaling.py [--T 128]

Run from the root of a checkout on a machine with a CUDA card; builds the
kernels as ``chip_smoke.py`` does. Prints one line per (B, H): the median
device time of one launch over 30 (CUDA events) and that time per step,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 256), (2, 256), (4, 256), (8, 256), (16, 256), (32, 256), (64, 256), (32, 8),
          (32, 64), (32, 128)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_layer_bwd_scaling: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.lstm_cell import ops

    gen = torch.Generator().manual_seed(0)
    T = args.T
    for B, H in SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen).cuda()

        gates = torch.rand(T, B, 4 * H, generator=gen).cuda()
        inputs = (rnd(T, B, H), rnd(B, H), rnd(B, H), gates, rnd(T + 1, B, H), rnd(H, 4 * H) * 0.05)
        for _ in range(3):
            ops.lstm_layer_bwd(*inputs)
        torch.cuda.synchronize()
        times = []
        for _ in range(30):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ops.lstm_layer_bwd(*inputs)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        print(json.dumps({"T": T, "B": B, "H": H, "ms": ms, "us_a_step": ms * 1e3 / T}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
