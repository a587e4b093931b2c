#!/usr/bin/env python3
"""Time ``flash_attention_bwd`` where the keys span several of the
backward's key tiles, beside the training shape, whose keys fit one; and
the training forward (``flash_attention_train``) at the same shapes; in
fp32 at ``SHAPES`` and in bf16 (the bf16 kernels) at ``BF16_SHAPES``.

    python3 tools/flash_bwd_shapes.py [--src DIR] [--label NAME] [--dtype fp32|bf16|all]

Past one key tile the fp32 kernel runs its multi-tile path: a D pass,
then per round of ``bwd_part_tiles`` tiles the main kernel and the sum of
the tiles' partial dQ in a scratch of up to ``BWD_PART_BYTES``; the bf16
backward is ``bwd_bf16_plan``'s two kernels (three with a head split) at
every length. ``--src`` names the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's), so two versions of the kernel can be
timed on one card in one session: run the script once per version,
alternating (A, B, B, A), e.g. against ``git archive`` of an earlier
commit's ``src`` unpacked under ``build/``.
Run from the root of a checkout on a machine with a CUDA card; the
kernels are built as ``chip_smoke.py`` builds them.

Prints one JSON line per shape: the device time of one backward call by
CUDA events (``ev``, the median of 20) and back to back (``b2b``, 20 calls
between two events), the largest error against the plain version over
the largest element of each gradient, the forward's two times and its
largest error (out and lse) against its plain version over the largest
element, ``scaled_dot_product_attention``'s forward on the same inputs
(a yardstick the port never calls; ``sdpa_fwd_ms``, by events, at the
causal shapes whose window, if any, cuts no key) and its forward and
backward together (``sdpa_fwd_bwd_ms``, the same inputs with ``dout`` as
the cotangent; the difference of the two is SDPA's backward), the memory
the backward allocates at its peak (the gradients, D and the scratch),
and, for a version that has them, the scratch's tiles and rounds and the
head split (the bf16 rows: ``bwd_bf16_plan``'s split and launches where
the version has it); for bf16 each kernel's device time in one backward
and one forward call (``kernel_us``, ``fwd_kernel_us``: ``torch.profiler``
over 5 calls, divided by 5) and the number of kernels a backward call
launches (the library's own count where the version keeps one, else
``torch.profiler``'s); then the card's name and power limit. Each row names its
dtype; a version without the bf16 kernels prints no bf16 rows. The plain
versions run one batch row at a time past ``PLAIN_ROW_SCORES`` scores
(StableLM-3B's 8 x 4,096 would be 17 GB of fp32 scores at once).
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
# (b, s, nq, nkv, hd, causal, window): StableLM-3B's training shape (one
# key tile), RecurrentGemma-9B's checked step (two 32-key tiles at hd 256),
# StableLM-3B at 512 and 2048 positions, RecurrentGemma-9B at 2048
SHAPES = [(8, 64, 32, 32, 80, True, 0), (2, 64, 16, 1, 256, True, 2048),
          (8, 512, 32, 32, 80, True, 0), (8, 2048, 32, 32, 80, True, 0),
          (2, 2048, 16, 1, 256, True, 2048)]
# bf16: StableLM-3B's heads at 64, 512, 2,048 and 4,096 positions (the last
# the JAX dry run's train_4k microbatch, 8 rows), and RecurrentGemma-9B's
# multi-query 16/1 heads of 256 at 2,048
BF16_SHAPES = [(8, s, 32, 32, 80, True, 0) for s in (64, 512, 2048, 4096)] + \
    [(2, 2048, 16, 1, 256, True, 2048)]
PLAIN_ROW_SCORES = 1 << 30


def timed(fn, n: int = 20) -> tuple[float, float]:
    """(ev, b2b) ms of one call: the median of ``n`` calls each between two
    events, and ``n`` calls back to back over ``n``; both queued behind a
    spin kernel, so the host's launch cost is hidden."""
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
    ev = statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(n))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return ev, start.elapsed_time(end) / n


def kernel_us(fn, n: int = 5) -> tuple[dict[str, float], int]:
    """Each kernel's device time in one call of ``fn`` (µs) over ``n``
    profiled calls, and the kernels one call launches."""
    from torch.autograd import DeviceType
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # one call's kernels
        fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def by_rows(fn, b, s, nq, *tensors):
    """``fn`` over the batch, one row at a time past ``PLAIN_ROW_SCORES``
    scores; the outputs concatenated."""
    if b * nq * s * s <= PLAIN_ROW_SCORES:
        return fn(*tensors)
    parts = [fn(*(t[i:i + 1] for t in tensors)) for i in range(b)]
    return [torch.cat(ts) for ts in zip(*parts)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", choices=("fp32", "bf16", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_shapes: needs a CUDA card")
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_train_ref)

    runs = []
    if args.dtype in ("fp32", "all"):
        runs += [(shape, torch.float32) for shape in SHAPES]
    if args.dtype in ("bf16", "all") and torch.bfloat16 in getattr(ops, "_TRAIN_ENTRY", {}):
        runs += [(shape, torch.bfloat16) for shape in BF16_SHAPES]
    for shape, dtype in runs:
        b, s, nq, nkv, hd, causal, window = shape
        kw = dict(causal=causal, window=window)
        gen = torch.Generator("cuda").manual_seed(0)
        q, dout = (torch.randn(b, s, nq, hd, device="cuda", generator=gen).to(dtype)
                   for _ in range(2))
        k, v = (torch.randn(b, s, nkv, hd, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        def fwd():
            return ops.flash_attention_train(q, k, v, **kw)

        out, lse = fwd()
        fwd_err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                      for g, w in zip((out, lse), by_rows(
                          lambda q, k, v: flash_attention_train_ref(q, k, v, **kw), b, s, nq,
                          q, k, v)))
        fwd_ev, fwd_b2b = timed(fwd)
        sdpa = sdpa_pair = None
        if causal and (window == 0 or window >= s):  # a window past the keys cuts none
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            dt = dout.transpose(1, 2)

            def sdpa_fwd():
                with torch.no_grad():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=nq != nkv)

            def sdpa_fwd_bwd():
                o = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=nq != nkv)
                return torch.autograd.grad(o, (qt, kt, vt), dt)

            sdpa = timed(sdpa_fwd)[0]
            sdpa_pair = timed(sdpa_fwd_bwd)[0]
            del qt, kt, vt, dt

        def bwd():
            return ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)

        got = bwd()
        want = by_rows(lambda *t: flash_attention_bwd_ref(*t, **kw), b, s, nq,
                       q, k, v, out, lse, dout)
        err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for g, w in zip(got, want))
        del got, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ev, b2b = timed(bwd)
        row = {"label": args.label, "dtype": str(dtype).removeprefix("torch."),
               "shape": list(shape), "ev_ms": ev, "b2b_ms": b2b,
               "max_err_of_max": err, "peak_bytes": peak, "fwd_ev_ms": fwd_ev,
               "fwd_b2b_ms": fwd_b2b, "fwd_max_err_of_max": fwd_err, "sdpa_fwd_ms": sdpa,
               "sdpa_fwd_bwd_ms": sdpa_pair}
        if hasattr(ops, "bwd_part_tiles"):
            tile = ops.bwd_key_tile(hd)
            tiles = -(-s // tile)
            part = ops.bwd_part_tiles(b, s, s, nq, hd)
            row.update(key_tile=tile, tiles=tiles, part_tiles=part,
                       rounds=-(-tiles // part) if part else 1,
                       scratch_bytes=4 * part * b * s * nq * hd)
        if hasattr(ops, "bwd_head_split"):
            row["head_split"] = ops.bwd_head_split(b, s, s, nq, nkv, hd)
        if dtype == torch.bfloat16:
            row["kernel_us"], row["kernels_a_call"] = kernel_us(bwd)
            row["fwd_kernel_us"] = kernel_us(fwd)[0]
            if hasattr(ops, "bwd_bf16_plan"):
                plan = ops.bwd_bf16_plan(b, s, s, nq, nkv, hd)
                before = ops.bwd_bf16_kernels()  # the library's own count
                bwd()
                row.update(head_split=plan.head_split, plan_launches=plan.launches,
                           kernels_a_call=ops.bwd_bf16_kernels() - before)
                for key in ("key_tile", "tiles", "part_tiles", "rounds", "scratch_bytes"):
                    row.pop(key, None)
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
