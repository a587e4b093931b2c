#!/usr/bin/env python3
"""Split the two training forwards' and the mLSTM backward's device time
by kernel.

    python3 tools/train_forward_profile.py [--src DIR] [--label NAME]

Times ``flash_attention_train`` (``csrc/flash_attention_train.cu``) at
StableLM-3B's training shape, RecurrentGemma-9B's checked step and 8 x 512
positions, ``mlstm_chunk_train`` (``csrc/mlstm_chunk_train.cu``: its
slices, scores and rows kernels) at the launcher's training step and a
200-step prefill, and ``mlstm_chunk_bwd`` (``csrc/mlstm_chunk_bwd.cu``)
at the same two shapes with a cotangent of h alone, as a train step gives
it, each from seeded inputs on the card: one call by CUDA events (the
median of 50), and ``torch.profiler``'s device time of each kernel over 10
calls, divided by 10. Each result is held to its plain version first (the
backward's as the largest error of each gradient over its largest
element). ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's), so an earlier commit's kernels, unpacked
by ``git archive``, can be split on the same card in the same session.
Run from the root of a checkout on a machine with a CUDA card; the kernels
are built as ``chip_smoke.py`` builds them. Prints one JSON line per shape,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (b, s, nq, nkv, hd, causal, window)
FLASH_SHAPES = [(8, 64, 32, 32, 80, True, 0), (2, 64, 16, 1, 256, True, 2048),
                (8, 512, 32, 32, 80, True, 0)]
# (b, s, H, dh)
MLSTM_SHAPES = [(8, 64, 4, 512), (1, 200, 4, 512)]


def event_ms(fn, n: int = 50) -> float:
    """The median of ``n`` calls, each between two CUDA events, queued
    behind a spin kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(50_000_000)
    for i in range(n):
        events[i].record()
        fn()
    events[n].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(n))


def kernel_us(fn, n: int = 10) -> dict[str, float]:
    """Each kernel's device time in one call (µs), over ``n`` profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", 0.0)
        if us:
            # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
            m = re.search(r"::([A-Za-z_]\w*(?:<[^>]*>)?)\(", event.key)
            name = m.group(1) if m else event.key[:60]
            out[name] = out.get(name, 0.0) + us / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_forward_profile: needs a CUDA card")
    sys.path.insert(0, str(opts.src.resolve()))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_train_ref
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref, mlstm_chunk_train_ref

    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + shift

    for shape in FLASH_SHAPES:
        b, s, nq, nkv, hd, causal, window = shape
        q, k, v = rnd(b, s, nq, hd), rnd(b, s, nkv, hd), rnd(b, s, nkv, hd)

        def fwd():
            return flash_ops.flash_attention_train(q, k, v, causal=causal, window=window)

        got = fwd()
        want = flash_attention_train_ref(q, k, v, causal=causal, window=window)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(json.dumps({"label": opts.label, "kernel": "flash_attention_train",
                          "shape": list(shape),
                          "ev_ms": event_ms(fwd), "kernel_us": kernel_us(fwd),
                          "max_abs_err": err}), flush=True)
    for shape in MLSTM_SHAPES:
        b, s, H, dh = shape
        args = (rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5),
                rnd(b, s, H, dh, scale=0.5), rnd(b, s, H), rnd(b, s, H, shift=2.0),
                rnd(b, H, dh, dh), rnd(b, H, dh), rnd(b, H))

        def fwd():
            return mlstm_ops.mlstm_chunk_train(*args)

        got = fwd()
        want = mlstm_chunk_train_ref(*args)
        print(json.dumps({"label": opts.label, "kernel": "mlstm_chunk_train",
                          "shape": list(shape),
                          "ev_ms": event_ms(fwd), "kernel_us": kernel_us(fwd),
                          "h_max_abs_err": (got[0] - want[0]).abs().max().item()}), flush=True)
        h, c_st, n_st, m_st = got[0], *got[4:]
        saved = (*args[:5], c_st, n_st, m_st, h, rnd(b, s, H, dh), None, None, None)

        def bwd():
            return mlstm_ops.mlstm_chunk_bwd(*saved)

        err = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                  for g, w in zip(bwd(), mlstm_chunk_bwd_ref(*saved)))
        print(json.dumps({"label": opts.label, "kernel": "mlstm_chunk_bwd", "shape": list(shape),
                          "ev_ms": event_ms(bwd), "kernel_us": kernel_us(bwd),
                          "max_err_of_max": err}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
