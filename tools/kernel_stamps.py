#!/usr/bin/env python3
"""Where a launch of a hand-written kernel spends its time, phase by phase.

    python3 tools/kernel_stamps.py            # on a machine with an H100

Builds instrumented copies of ``csrc/lstm_cell.cu``,
``csrc/mlstm_chunk.cu``, ``csrc/flash_attention.cu`` and
``csrc/text_clean.cu`` and ``csrc/text_scan.cu`` (with ``byte_scan.cuh``
inlined) with nvcc into
``build/kernel_stamps/``: thread 0 of every block writes the card's
``%globaltimer`` (ns) at the start of the kernel and after each phase. It
runs each kernel at the served shapes (``lstm_cell`` at B=64, H=256, d_in
128 and 256; the chunked mLSTM pass on a 10-step prompt at 4 heads of 512;
flash decode steps at StableLM-3B's and RecurrentGemma-9B's heads over 16
keys, and over 1,901 keys split over a cluster; ``text_clean`` over a
4,096 x 512 matrix and over an abstract column of the corpus that
``chip_smoke.py`` cleans; ``text_scan`` over one served batch of 64
abstracts with all three flags), after three warm-up launches, and prints for
every phase the min, median and max over blocks of its time in µs after
the earliest block's start, and the median launch time of ``lstm_cell``,
flash and the byte kernels by CUDA events; every block's stamps and the
SM it ran on go to ``build/kernel_stamps/<label>.json``. The byte kernels' stamps of
their first tile are written once a launch (``unset``): their stamps are
cleared before the launch that is read. The sources in the checkout stay as they
are; the stamps go in before or after anchor lines of them, which
``tests/test_torch_kernel_stamps.py`` checks are there.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (inputs and timing of the smoke script)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import plan  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref  # noqa: E402

OUT = ROOT / "build" / "kernel_stamps"
SLOTS = 16  # stamps a block may write; the last holds its SM
STAMP = r'''
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long sm_id() {
  unsigned int id;
  asm volatile("mov.u32 %0, %smid;" : "=r"(id));
  return id;
}
// slot 15 of a block holds the SM it ran on
#define STAMP(i) do { if (threadIdx.x == 0) { \
  g_stamps[(blockIdx.x + blockIdx.y * gridDim.x) * 16 + (i)] = global_ns(); \
  if ((i) == 0) g_stamps[(blockIdx.x + blockIdx.y * gridDim.x) * 16 + 15] = sm_id(); } } while (0)
extern "C" int read_stamps(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, n * 8));
}
// slot i of this block not yet written since the last clear_stamps()
__device__ __forceinline__ bool unset(int i) {
  return g_stamps[(blockIdx.x + blockIdx.y * gridDim.x) * 16 + i] == 0;
}
extern "C" int clear_stamps() {
  static unsigned long long zero[1 << 16];
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zero, sizeof zero));
}
'''
# (anchor in the source, stamp inserted before it or after it, condition)
LSTM_STAMPS = [
    ("  cluster_arrive_relaxed();  // waited for", "before", ""),
    ("    const T* st = stages + (t % kStages) * L::kStageElems;", "before", "t == 0"),
    ('  asm volatile("cp.async.wait_all;\\n" ::);', "before", ""),
    ("  cluster_wait();  // every partial of this block's rows has landed\n", "after", ""),
    ("        gr[3 * static_cast<size_t>(H)] = go;\n      }\n    }\n  }\n", "after", ""),
]
LSTM_PHASES = ["start", "first tile staged", "K loop done", "partials landed", "rows finished"]
MLSTM_STAMPS = [
    ("  const int tid = threadIdx.x, warp = tid / 32, side", "before", ""),
    ("  for (int c0 = 0; c0 < s; c0 += kChunk) {\n", "before", ""),
    ("    __syncthreads();  // the gates are written\n", "after", ""),
    ("    // Scores q_t . k_j (j <= t)", "before", ""),
    ("    // W = D * scores; the block's v rows;", "before", ""),
    ("    // State update: C[row] in registers", "before", ""),
    ("    __syncthreads();  // the next chunk's gates overwrite s_out, wj and friends\n", "after", ""),
]
MLSTM_PHASES = ["start", "C rows loaded", "gates", "q . C", "scores", "outputs", "state updated"]
FLASH_STAMPS = [
    ("  // Which rows and keys: the positions are read once, here.", "before", ""),
    ("  // Lane r keeps row r's running max and sum;", "before", ""),
    ("    __syncwarp();  // every lane's copies (or stores) of this round are in\n", "after",
     "rnd == 0"),
    ("    __syncwarp();  // the round's scores are in sc\n", "after", "rnd == 0"),
    ("    __syncwarp();  // the ring slot and sc are consumed", "before", "rnd == 0"),
    ("  // The warp's partial over the ring's bytes", "before", ""),
    ("  // Rows rank, rank + split, .. of the tile", "before", ""),
    ("  float4 o[kRW][kC];", "before", ""),
    ("  T* ob = static_cast<T*>(p.out);", "before", ""),
    ("  if (split > 1) cluster_sync();  // no block leaves", "before", ""),
]
FLASH_PHASES = ["start", "q staged", "first round landed (warp 0)", "its scores in (warp 0)",
                "its rows updated (warp 0)", "walk done (warp 0)", "partials in",
                "weights (warp 0)", "sums (warp 0)", "rows written"]
# decode steps (b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len)
FLASH_CASES = {"decode hd 80": (1, 1, 128, 32, 32, 80, True, 0, 15, 16),
               "decode hd 256": (1, 1, 128, 16, 1, 256, True, 2048, 15, 16),
               "decode hd 80 over 1,901 keys": (1, 1, 2048, 32, 32, 80, True, 0, 1900, 1901)}
CLEAN_STAMPS = [
    ("  uint4* const my_map = reinterpret_cast<uint4*>(map) + threadIdx.x * kVecs;", "before",
     ""),
    ("  if (r.begin >= r.end) return;  // uniform: no row starts in this block's share\n",
     "after", ""),
    ("        pair = thread_pair(v, starts);\n", "after",
     "unset(2) && pair != 0x7fffffff"),  # waits for the tile's bytes
    ("      carry = depth_from(total, carry);\n", "after",
     "unset(3) && depth != 0x7fffffff"),  # waits for the scan
    ("    store_bytes<kAligned, kVecs>(out, pos, w, r);\n  }\n", "after", ""),
]
CLEAN_PHASES = ["start", "split found", "first tile loaded", "first tile scanned",
                "last tile stored"]
SCAN_STAMPS = [CLEAN_STAMPS[0], CLEAN_STAMPS[1],
               ("      starts.mark(base, map);\n", "after", "unset(2)"),
               ("      span(delim, closer, starts, warp_total, html_carry, alive);\n    }\n", "after",
                "unset(3) && alive[0] != 1u"),  # waits for the HTML span's scan
               CLEAN_STAMPS[4]]
SCAN_PHASES = ["start", "split found", "first tile's row starts marked", "HTML span done",
               "last tile stored"]
LSTM_BLOCKS = 4 * (256 // 8)  # clusters of kSplit = 4 blocks over kUnits = 8 of H = 256


def source_text(name: str) -> str:
    """A source of ``csrc/`` with its local headers inlined."""
    src = (_build.CSRC / name).read_text()
    for header in sorted(_build.CSRC.glob("*.cuh")):
        src = src.replace(f'#include "{header.name}"', header.read_text())
    return src


def instrument(src: str, stamps) -> str:
    head = min(i for i in (src.find("namespace {"), src.find("namespace byte_scan {")) if i >= 0)
    src = src[:head] + STAMP + src[head:]
    for i, (anchor, where, condition) in enumerate(stamps):
        if anchor not in src:
            raise SystemExit(f"kernel_stamps: anchor {anchor!r} not in the source")
        at = src.index(anchor) + (len(anchor) if where == "after" else 0)
        stamp = f"if ({condition}) STAMP({i});" if condition else f"STAMP({i});"
        src = src[:at] + f"  {stamp}\n" + src[at:]
    return src


def build(name: str, src: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    p = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"kernel_stamps: nvcc failed for {name}:\n{p.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def report(lib, n_blocks: int, names: list[str], label: str) -> dict:
    buf = (ctypes.c_ulonglong * (1 << 16))()
    if lib.read_stamps(buf, 1 << 16):
        raise SystemExit("kernel_stamps: reading the stamps failed")
    rows = [[buf[b * SLOTS + i] for i in range(len(names))] for b in range(n_blocks)]
    # every block's stamps (ns after the first start) and its SM, for a closer look
    t0 = min(r[0] for r in rows)
    name = "".join(c if c.isalnum() else "_" for c in label)
    (OUT / f"{name}.json").write_text(json.dumps(
        {"phases": names, "blocks": [{"sm": buf[b * SLOTS + SLOTS - 1],
                                      "ns": [x - t0 if x else None for x in r]}
                                     for b, r in enumerate(rows)]}))
    t0 = min(r[0] for r in rows)
    out = {}
    for i, name in enumerate(names):  # a cleared stamp (0) is a phase the block never reached
        us = [(r[i] - t0) / 1e3 for r in rows if r[i]]
        out[name] = [round(min(us), 3), round(statistics.median(us), 3), round(max(us), 3)]
    print(f"{label}: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_stamps: needs a CUDA card")
    from repro_torch.device import card

    print(f"card: {card()}; phases as [min, median, max] us over blocks after the first start")
    P, I = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator().manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream

    lib = build("lstm_cell", instrument((_build.CSRC / "lstm_cell.cu").read_text(), LSTM_STAMPS))
    fn = lib.lstm_cell_f32
    fn.argtypes, fn.restype = (P,) * 8 + (I,) * 3 + (P,), I
    for d_in in (128, 256):
        args = cs.lstm_inputs(cs.BATCH, d_in, 256, torch.float32, gen)
        x, h, c, wx, wh, b = args
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)

        def run():
            err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
                     b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), cs.BATCH, d_in, 256, stream)
            if err:
                raise SystemExit(f"kernel_stamps: lstm_cell launch failed ({err})")

        for _ in range(4):
            run()
        torch.cuda.synchronize()
        for got, want in zip((h_out, c_out), lstm_cell_ref(*args)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        label = f"lstm_cell d_in={d_in}"
        report(lib, LSTM_BLOCKS, LSTM_PHASES, label)
        print(f"{label}: {LSTM_BLOCKS} blocks, {cs.device_ms(run):.5f} ms a launch (CUDA events)")

    src = instrument((_build.CSRC / "mlstm_chunk.cu").read_text(), MLSTM_STAMPS)
    lib = build("mlstm_chunk", src)
    fn = lib.mlstm_chunk_f32
    fn.argtypes, fn.restype = (P,) * 11 + (I,) * 4 + (P,), I
    b, s, H, dh = 1, 10, 4, 512
    args = cs.mlstm_inputs(b, s, H, dh, gen)
    c, n, m = cs.mlstm_state(b, H, dh, gen)
    want = mlstm_chunk_ref(*args, c, n, m)
    out, n_out, m_out = torch.empty_like(args[0]), torch.empty_like(n), torch.empty_like(m)
    for i in range(4):
        c_run = c.clone()
        err = fn(*(t.data_ptr() for t in args), c_run.data_ptr(), n.data_ptr(), m.data_ptr(),
                 n_out.data_ptr(), m_out.data_ptr(), out.data_ptr(), b, s, H, dh, stream)
        if err:
            raise SystemExit(f"kernel_stamps: mlstm_chunk launch failed ({err})")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want[0], rtol=2e-5, atol=2e-5)
    report(lib, b * H * (dh // 16), MLSTM_PHASES,
           f"mlstm_chunk chunked pass, {s} steps at {H} heads of {dh}")

    lib = build("flash_attention", instrument((_build.CSRC / "flash_attention.cu").read_text(),
                                              FLASH_STAMPS))
    fn = lib.flash_attention_f32
    fn.argtypes, fn.restype = _build.SIGNATURES["flash_attention_f32"], I
    for label, case in FLASH_CASES.items():
        b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
        q, k, v = cs.flash_inputs(case, torch.float32, gen)
        out = torch.empty_like(q)
        launch = plan(b, sq, nq, nkv, causal=causal, window=window, q_offset=q_offset,
                      n_keys=kv_len)

        def run():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, nq,
                     nkv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
                     window, q_offset, kv_len, launch.rows, launch.split, hd ** -0.5, stream)
            if err:
                raise SystemExit(f"kernel_stamps: flash_attention launch failed ({err})")

        for _ in range(4):
            run()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, flash_attention_ref(q, k, v, **cs.flash_kwargs(case)),
                                   rtol=2e-5, atol=2e-5)
        n_blocks = b * nkv * launch.split * launch.tiles
        report(lib, n_blocks, FLASH_PHASES, f"flash_attention {label}")
        print(f"flash_attention {label}: {n_blocks} blocks ({launch}), {cs.device_ms(run):.5f} "
              f"ms a launch (CUDA events), {cs.device_ms_burst(run):.5f} back to back")

    stamp_text_clean(gen, stream)
    stamp_text_scan(stream)
    return 0


def stamp_text_scan(stream) -> None:
    """``text_scan`` over one served batch of 64 abstracts, all three flags."""
    from repro_torch.data.synthetic import abstracts_and_titles
    from repro_torch.kernels.text_clean.ref import text_scan_ref
    from repro_torch.kernels.text_clean.tiles import grid_blocks

    lib = build("text_scan", instrument(source_text("text_scan.cu"), SCAN_STAMPS))
    fn = lib.text_scan
    fn.argtypes, fn.restype = _build.SIGNATURES["text_scan"], ctypes.c_int
    abstracts, _ = abstracts_and_titles(cs.N_CORPUS, seed=cs.SEED)
    buf, offsets = cs.flat_rows(abstracts[:cs.BATCH])
    out = torch.empty_like(buf)
    n_rows = offsets.numel() - 1

    def run():
        err = fn(buf.data_ptr(), out.data_ptr(), offsets.data_ptr(), n_rows, 1, 1, 1, stream)
        if err:
            raise SystemExit(f"kernel_stamps: text_scan launch failed ({err})")

    for _ in range(3):
        run()
    lib.clear_stamps()
    run()
    torch.cuda.synchronize()
    flags = dict(lower=True, strip_html=True, strip_parens=True)
    if not torch.equal(out, text_scan_ref(buf, offsets, **flags)):
        raise SystemExit("kernel_stamps: text_scan differs from its plain version")
    n_blocks = grid_blocks(n_rows, torch.cuda.get_device_properties(0).multi_processor_count)
    label = f"text_scan batch ({n_rows} rows, {buf.numel()} bytes)"
    report(lib, n_blocks, SCAN_PHASES, label)
    print(f"{label}: {n_blocks} blocks, {cs.device_ms(run):.5f} ms a launch (CUDA events), "
          f"{cs.device_ms_burst(run):.5f} back to back")


def stamp_text_clean(gen, stream) -> None:
    """``text_clean`` with strip_html at the 4,096 x 512 matrix and over an
    abstract column: the corpus of ``chip_smoke.py``'s preprocessing phase,
    written, ingested and pre-cleaned as there."""
    from repro_torch.core.ingest import ingest, pre_clean
    from repro_torch.data.synthetic import write_corpus
    from repro_torch.kernels.text_clean.ref import text_clean_flat_ref, text_clean_ref
    from repro_torch.kernels.text_clean.tiles import grid_blocks

    lib = build("text_clean", instrument(source_text("text_clean.cu"), CLEAN_STAMPS))
    fn = lib.text_clean
    fn.argtypes, fn.restype = _build.SIGNATURES["text_clean"], ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mat = torch.randint(32, 127, (4096, 512), generator=gen, dtype=torch.uint8).cuda()
    corpus = ROOT / "build" / "kernel_stamps_corpus"
    write_corpus(corpus, cs.CORPUS_BYTES, n_files=cs.CORPUS_FILES, seed=cs.SEED)
    buf, offsets = cs.flat_column(pre_clean(ingest([corpus], cs.FIELDS),
                                            list(cs.FIELDS))["abstract"])
    n_abs = offsets.numel() - 1
    cases = {"matrix 4,096 x 512": (mat.view(-1), None, 4096, 512,
                                    lambda out: torch.equal(out.view(4096, 512),
                                                            text_clean_ref(mat))),
             f"abstract column ({n_abs} rows, {buf.numel()} bytes)":
                 (buf, offsets, n_abs, 0,
                  lambda out: torch.equal(out, text_clean_flat_ref(buf, offsets)))}
    for label, (src, offs, n_rows, width, same) in cases.items():
        out = torch.empty_like(src)

        def run():
            err = fn(src.data_ptr(), out.data_ptr(), None if offs is None else offs.data_ptr(),
                     n_rows, width, 1, stream)
            if err:
                raise SystemExit(f"kernel_stamps: text_clean launch failed ({err})")

        for _ in range(3):
            run()
        lib.clear_stamps()
        run()
        torch.cuda.synchronize()
        if not same(out):
            raise SystemExit(f"kernel_stamps: text_clean differs from its plain version ({label})")
        n_blocks = grid_blocks(n_rows, sms)
        report(lib, n_blocks, CLEAN_PHASES, f"text_clean {label}")
        print(f"text_clean {label}: {n_blocks} blocks, {cs.device_ms(run):.5f} ms a launch "
              f"(CUDA events), {cs.device_ms_burst(run):.5f} back to back")


if __name__ == "__main__":
    sys.exit(main())
