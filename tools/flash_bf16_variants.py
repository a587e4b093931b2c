#!/usr/bin/env python3
"""Build flash attention's bf16 training kernels alone, as they stand and
with named edits of their sources, and time each build on the card.

    python3 tools/flash_bf16_variants.py [VARIANT ...]     # default: all of VARIANTS

Each variant copies ``csrc/flash_attention_train_bf16.cu``,
``csrc/flash_attention_bwd_bf16.cu`` and their headers into
``build/flash_bf16_variants/<name>/`` with the variant's text
substitutions (``base`` has none), compiles them with nvcc for ``sm_90a``
into a library of their own, all variants in parallel, and prints what
ptxas says of each kernel: registers, local-memory loads and stores (from
``cuobjdump -sass``), and any "Potential Performance Loss" note, where it
serializes the warpgroup products. Then, in a process of its own,
``flash_attention_train`` and ``flash_attention_bwd`` run on that
library: against their plain versions at ``CASES`` (the largest error of
each output over the output's largest element, and two backward launches
equal bit for bit), then timed at ``TIMED`` (the median of 10 calls, each
between two CUDA events, queued behind a spin kernel) with the
backward's device time split by kernel (``torch.profiler``). One JSON
line per case and timed shape, then the card's name and power limit. Run
from the root of a checkout on a machine with a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_bf16_variants"
SOURCES = ("flash_attention_train_bf16.cu", "flash_attention_bwd_bf16.cu")
HEADERS = ("hopper_bf16.cuh", "flash_masks.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
# name -> [(text, replacement)] applied to every source and header
VARIANTS = {
    "base": [],
    # hd 80 in 64- and 128-byte swizzled tiles (padded to 96 and 128 in
    # shared memory) in place of 32-byte ones
    "sw64": [("launch_as<80, 32, ", "launch_as<80, 64, ")],
    "sw128": [("launch_as<80, 32, ", "launch_as<80, 128, ")],
    # hd 80 with two consumer warpgroups of 240 registers (128-key tiles in
    # the forward) in place of three of 160
    "wg2": [(": launch_as<80, 32, 64, 3>", ": launch_as<80, 32, 128, 2>"),
            (": launch_as<80, 32, 64, 3, 32, 3, false>",
             ": launch_as<80, 32, 64, 2, 32, 2, false>")],
}
# (b, s, nq, nkv, hd, causal, window)
CASES = [(1, 128, 2, 2, 64, False, 0), (2, 200, 8, 2, 80, True, 0), (2, 65, 32, 32, 80, True, 0),
         (1, 300, 4, 4, 128, False, 0), (1, 129, 16, 1, 256, True, 0),
         (3, 63, 16, 1, 256, True, 20), (2, 513, 32, 32, 80, True, 100),
         (1, 100, 4, 1, 36, True, 0), (8, 65, 4, 1, 256, False, 9)]
TIMED = [(8, s, 32, 32, 80, True, 0) for s in (64, 512, 2048, 4096)] + \
    [(2, 2048, 16, 1, 256, True, 2048), (2, 2048, 64, 8, 128, True, 0)]


def nvcc() -> str:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    return _build.nvcc()


def build(names: list[str]) -> dict[str, bool]:
    """Compile every variant's sources in parallel; print ptxas's notes."""
    tool = nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in SOURCES + HEADERS:
            text = (CSRC / f).read_text()
            for old, new in VARIANTS[name]:
                text = text.replace(old, new)
            (d / f).write_text(text)
        for f in SOURCES:
            procs[name, f] = subprocess.Popen(
                [tool, *NVCC_FLAGS, "-c", str(d / f), "-o", str(d / f"{f}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ok = {name: True for name in names}
    for (name, f), proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            ok[name] = False
            print(f"{name}: {f} failed to build\n{err[-4000:]}", flush=True)
        for line in err.splitlines():
            if "Performance Loss" in line:
                kernel = re.search(r"(flash_\w+?_kernel\w*)", line)
                print(f"{name}: {line.split(':', 1)[1].split(' in the function')[0].strip()} "
                      f"({kernel.group(1) if kernel else '?'})", flush=True)
    for name in names:
        d = OUT / name
        if ok[name]:
            link = subprocess.run([tool, *NVCC_FLAGS[:2], "-shared",
                                   *(str(d / f"{f}.o") for f in SOURCES), "-o", str(d / "lib.so")],
                                  capture_output=True, text=True)
            ok[name] = link.returncode == 0
            if ok[name]:
                print(f"{name}: " + "; ".join(sass_summary(tool, d / "lib.so")), flush=True)
    return ok


def sass_summary(tool: str, lib: Path) -> list[str]:
    """Per kernel: the highest register index and the local loads and stores."""
    sass = subprocess.run([str(Path(tool).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    out, kernel, top, local = [], None, 0, 0
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if kernel:
                short = re.search(r"\d(flash_\w+?_kernel\w*?)E(vNS_|NS_)", kernel)
                out.append(f"{short.group(1) if short else kernel[-40:]} R{top} local {local}")
            kernel, top, local = m.group(1), 0, 0
            continue
        top = max([top, *(int(r) for r in re.findall(r"\bR(\d+)\b", line))])
        local += ("STL" in line) + ("LDL" in line)
    return out


def timed_ms(fn, n: int = 10) -> float:
    for _ in range(2):
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


def kernel_us(fn) -> dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        if getattr(event, "device_time_total", 0.0):
            m = re.search(r"::(\w+)", event.key)
            out[m.group(1) if m else event.key[:40]] = event.device_time_total
    return out


def run(name: str) -> None:
    """Check and time one built variant (in a process of its own)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_train_ref)

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in ("flash_attention_train_bf16", "flash_attention_bwd_bf16"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int

    def check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    _build.library, _build.check = (lambda: lib), check
    gen = torch.Generator().manual_seed(0)

    def inputs(case):
        b, s, nq, nkv, hd = case[:5]
        return [torch.randn(*shape, generator=gen).cuda().bfloat16()
                for shape in ((b, s, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd), (b, s, nq, hd))]

    def rel(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    for case in CASES:
        kw = dict(causal=case[5], window=case[6])
        q, k, v, dout = inputs(case)
        out, lse = ops.flash_attention_train(q, k, v, **kw)
        grads = ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)
        again = ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)
        want_out, want_lse = flash_attention_train_ref(q, k, v, **kw)
        want = flash_attention_bwd_ref(q, k, v, None, lse, dout, **kw)
        print(json.dumps({"variant": name, "case": case, "out": rel(out, want_out),
                          "lse_abs": (lse - want_lse).abs().max().item(),
                          "dq_dk_dv": [rel(g, w) for g, w in zip(grads, want)],
                          "repeat_equal": all(torch.equal(g, a) for g, a in zip(grads, again))}),
              flush=True)
    for case in TIMED:
        kw = dict(causal=case[5], window=case[6])
        q, k, v, dout = inputs(case)
        out, lse = ops.flash_attention_train(q, k, v, **kw)

        def bwd():
            return ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)

        print(json.dumps({"variant": name, "timed": case,
                          "fwd_ms": timed_ms(lambda: ops.flash_attention_train(q, k, v, **kw)),
                          "bwd_ms": timed_ms(bwd), "bwd_kernel_us": kernel_us(bwd)}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        sys.exit("flash_bf16_variants: needs a CUDA card")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"flash_bf16_variants: no variant {unknown}; there are {list(VARIANTS)}")
    t0 = time.perf_counter()
    ok = build(names)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        if ok[name]:
            try:
                subprocess.run([sys.executable, __file__, "--run", name], timeout=600, check=False)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
