#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX and nothing of
the JAX package ``repro``; any failure exits non-zero. Phases:

1. the card, torch and CUDA versions, capability (CUDA and sm_90 required);
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (fp32 at 1e-5, bf16 at 2e-2, bytes
   identical); ``lstm_cell`` also at its tiling's edges and unaligned
   inputs; ``flash_attention`` also at long caches split over a cluster,
   prefills whose planned splits leave ranges empty or fully masked for
   some rows, and strided K/V; ``rg_lru`` in fp32 and bf16; ``mlstm_chunk``
   over three draws of a grid of lengths (the decode path at 1), head
   widths and (batch, head) counts, and pinned draws (generator states in
   ``chip_smoke_pins/``) that an earlier design failed or that hold the
   kernel and the plain version against fp64; the byte kernels also at the
   row layouts chosen against their work split (``tiles.layouts``), on a
   buffer at an odd address and on one 8 MB row;
   ``lstm_cell``, ``flash_attention``, ``mlstm_chunk``, ``text_scan`` and
   ``text_clean`` launched twice and the two results held equal bit for bit;
4. time every kernel, its plain version and a library yardstick with CUDA
   events (median of 60 calls queued behind a spin kernel, so the host's
   launch cost is hidden), beside the least time the card could take and
   each kernel's time before its last redesign; the LM kernels, the byte
   kernels and the LM kernels' yardsticks also by a second timer that
   resolves launches below the events' floor of about 5 us (200 calls back
   to back between two events); and the host's cost of one ``lstm_cell_op``
   call;
5. serve 512 raw abstracts at the published width (``CONFIG``) in batches
   of 64 through ``serve_abstracts``, with the launch counters set to 0
   just before and read just after; then rerun one batch on the CPU with
   the plain versions and compare logits and tokens;
6. for each LM of ``LM_ARCHS`` (StableLM-3B, RecurrentGemma-9B, xLSTM-1.3B)
   at its published width and depth (random weights from seed 0 built on
   the card): serve 8 requests through ``serve_requests``, 4 slots, 12 new
   tokens, a 128-long cache, with the LM kernels' launch counters set to 0
   just before and read just after (each layer launches its kind's kernel
   once per generated token); then a model of the same width cut to
   ``CARD_VS_CPU_LAYERS`` layers (enough for one layer of every kind) at
   ``init_scale=1`` (so that its layers move the logits) on the card and
   on the CPU with the same weights: what the layers add to the residual,
   ``forward`` logits and served tokens compared, and ``decode_step`` on
   the card held against ``forward``;
7. the paper's preprocessing (Algorithm 1) on the card: write a 64 MB
   JSONL corpus from the seed with ``write_corpus``, ``ingest`` it,
   ``pre_clean`` it and clean titles and abstracts with
   ``device_case_study_cleaner`` (the ``text_clean`` kernel, counters set to
   0 just before and read just after: one launch per column), every value
   held against the same path on the CPU;
8. the paper's comparison (Tables 2-6) on the same corpus: the abstract
   column's scan pass on the card (``scan_flat``) held byte for byte
   against the host's ``_run_scan`` of the same ``ScanPass`` and the
   kernel against its plain version at that column, and timed; then
   ``run_conventional`` (CA, Algorithm 2), ``run_p3sapp`` on the card
   (Algorithm 1 on the ``Dataset`` planner, one worker) at ``optimize``
   False and True with the ``text_scan`` counter set to 0 just before each
   and read just after (exactly ``P3SAPP_SCANS``: 4 unfused, 2 fused, the
   JAX package's planner's counts), and ``run_p3sapp`` on the host
   (``loops``, CPU); every run's records equal to CA's, 100% record
   match for both fields, each run's ``StageTimings`` and the ingestion,
   preprocessing and cumulative reductions (eq. 7) against CA;
9. the ``Dataset`` planner on the same corpus (``dataset``), the counters
   set to 0 just before each part and read just after: the reference
   example's chain (where, drop_duplicates, transform, where) whole-frame
   with ``execute(optimize=True)`` (records equal to ``run_p3sapp``'s,
   exactly 2 ``text_scan`` launches); its streamed token path on 4
   executor threads with the shard cache on (``fit_vocab`` and an epoch
   of ``device_batches(overlap=True)``, exactly 2 launches a shard each,
   every batch on the ``bucket_grid_spec()`` grid and equal bit for bit to
   the same chain under ``loops`` on the host, the cross-shard dedup
   touching the cache nowhere); the chain without dedup through the shard
   cache (``fit_vocab``, a cold and a warm epoch: 2 launches a shard, 0,
   0, and the reference's hit and miss pattern; warm batches equal to
   cold); 20 ``TrainController`` steps at CONFIG width fed by
   ``make_input_pipeline(overlap=True)`` with exact ``lstm_cell`` and
   ``lstm_cell_bwd`` counts; each part's wall time, ``StageTimings`` and
   the feeds' ``OverlapReport``;
10. the feed: 32 batches of 64 cleaned abstracts, tokenized and snapped
   onto a ``BucketGrid`` in ``DeviceFeed``'s fill thread, copied to the
   card and run through ``Seq2Seq.encode`` at CONFIG width inside
   ``feed.step``; the ``OverlapReport`` and the exact ``lstm_cell`` launch
   count (snapped width x 3 encoder layers, summed);
11. training (the example's, ``examples/train_summarizer_torch.py``):
   ``lstm_cell_bwd`` against its plain version at the training shape and
   its grid's edges, two launches bit for bit, the training entry of
   ``lstm_cell`` bit-equal to the serving entry, and both timed; one train
   step at CONFIG width (``init_scale=1``) on the card against the CPU
   (loss, every gradient present and within 1e-4 of its tensor's largest
   element, grad norm, updated params); then 40 steps of 32 cleaned
   records through ``DeviceFeed`` on the 2-D bucket grid under
   ``TrainController`` (checkpoint at step 20), the counters set to 0 just
   before and read just after (``lstm_cell`` and ``lstm_cell_bwd`` each
   exactly the sum of snapped encoder width x 3 + decoder width - 1), the
   loss falling; a second controller resumes at step 20 with the saved
   state bit for bit and tracks the first run's losses at 1e-4;
12. print the ``kernels`` line, one ``serve`` line and one ``serve_lm``
   line per LM, the ``preprocess``, ``feed``, ``train``, ``p3sapp`` and
   ``dataset`` lines, the card line from nvidia-smi, and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CORPUS = 2000
N_REQUESTS = 512
BATCH = 64
# LM serving: the JAX launcher's defaults (src/repro/launch/serve.py:25-28)
LM_ARCHS = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b")
LM_REQUESTS, LM_SLOTS, LM_MAX_NEW, LM_MAX_SEQ = 8, 4, 12, 128
# layers of the card-vs-CPU model: one layer of every kind of the pattern
CARD_VS_CPU_LAYERS = {"stablelm_3b": 2, "recurrentgemma_9b": 3, "xlstm_1_3b": 8}
# the kernel each kind of LM layer launches once per model pass
KERNEL_OF_KIND = {"attn": "flash_attention", "rglru": "rg_lru", "mlstm": "mlstm_chunk"}
# Per-card peaks from NVIDIA's data sheets: (name substring, device memory
# bytes/s, fp32 FLOP/s outside the tensor cores). First match wins.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
# Adversarial rows from the JAX package's own scan tests, plus non-ASCII,
# an empty row and rows longer than one 1024-byte tile of the kernel.
ADVERSARIAL = [
    "Hello <b>World</b> 42!", "(paren) and <tag> together", "<a(b>c)d adversarial nesting",
    "(a(b<c)d>e stray ) closer", "unclosed <span swallows", ">> leading closers ((",
    "nested ((deep (er))) out", "<<< (((", ")))) >>>>", "naïve café 漢字 🙂 (ñé) <Ω>", "",
    "Giant <b>Row</b> " + "Lorem IPSUM (drop me) " * 200, "<" + "x" * 3000 + ">tail",
]
# Per-launch times before the current designs of flash_attention and
# rg_lru and the fp64 state sum of mlstm_chunk's chunked pass (PERF.md §6
# lists them; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's:
# (kernel, timed row) -> ms.
BEFORE_MS = {("lstm_cell", None): 0.01327, ("text_scan", None): 0.006816,
             ("flash_attention", "decode"): 0.01395, ("flash_attention", "prefill"): 0.01411,
             ("flash_attention", "decode_hd256"): 0.02643,
             ("flash_attention", "prefill_hd256"): 0.02603, ("rg_lru", "decode"): 0.005248,
             ("rg_lru", "prefill"): 0.005824, ("mlstm_chunk", "decode"): 0.007040,
             ("mlstm_chunk", "prefill"): 0.02070, ("text_clean", "matrix"): 0.01133,
             ("text_clean", "abstracts"): 0.10571}
# The byte kernels before their current designs by the back-to-back timer
# (tools/byte_kernel_times.py against a git archive of the tree before
# them; PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W): (kernel, row) -> ms.
BEFORE_BURST_MS = {("text_scan", None): 0.003862, ("text_clean", "matrix"): 0.008276,
                   ("text_clean", "abstracts"): 0.103428}
# The preprocessing phase: corpus size, shards and the columns cleaned.
CORPUS_BYTES, CORPUS_FILES = 64 << 20, 8
FIELDS = ("title", "abstract")
# The feed phase: host batches of cleaned abstracts onto a bucket ladder.
FEED_BATCHES, FEED_LADDER, FEED_VOCAB = 32, (32, 64, 128), 8000
# text_scan launches of one run_p3sapp over the two columns, by optimize:
# the planner's unfused executor runs each column's strip_html and
# strip_parens...collapse_spaces stages as two kernel scans (its lowercase
# is a scan pass with no span, which the kernel does not compute); the
# fused one makes one scan a column. The JAX package's planner makes the
# same counts of scan_flat calls (tests/test_torch_dataset.py).
P3SAPP_SCANS = {False: 2 * len(FIELDS), True: len(FIELDS)}
# The dataset phase: the reference example's chain on the phase-7 corpus,
# 4 executor threads, batches of 64 on the 2-D grid, 20 planner-fed steps.
DATASET_WORKERS, DATASET_BATCH, DATASET_STEPS = 4, 64, 20
# The character cleaning kernel's rows from the JAX suite
# (tests/test_kernels.py:178-183) and the stray-'>', NUL and non-ASCII cases.
CLEAN_ROWS = ["Hello <b>World</b> 42!", "plain text only", "UPPER and (kept by kernel) 123",
              "", "x > yy zz <b>q", "A\x00B c", "café Naïve"]
CLEAN_WIDTHS = (1, 2, 3, 31, 255, 256, 511, 512, 1023, 1024, 1025, 2047, 2048, 2049, 3072,
                4095, 4096, 4097, 5000)


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAIL: {msg}")


def peaks(name: str) -> tuple[float, float]:
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    fail(f"no peak figures for card {name!r}")


def device_ms(fn, n: int = 60) -> float:
    """Median device time of one call of ``fn``: ``n`` calls queued behind
    a spin kernel, one CUDA event between consecutive calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(100_000_000)  # tens of ms: the host queues all n calls meanwhile
    for i in range(n):
        events[i].record()
        fn()
    events[n].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(n))


def device_ms_burst(fn, n: int = 200) -> float:
    """Device time of one call of ``fn`` below the events' floor: ``n``
    calls back to back between two CUDA events, divided by ``n``. The calls
    are queued behind a spin kernel, lengthened until it outlasts the
    host's queueing, so the host's launch cost is hidden."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(4):
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / n
        cycles *= 4
    fail(f"the host took {queued_ms:.1f} ms to queue {n} calls: longer than any spin tried")


def lstm_inputs(B, d_in, H, dtype, gen):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    return (rnd(B, d_in), rnd(B, H), rnd(B, H), rnd(d_in, 4 * H, scale=0.05),
            rnd(H, 4 * H, scale=0.05), rnd(4 * H, scale=0.1))


# The tiling's edges (clusters of 8 hidden units x 64 rows, the contraction
# split four ways in tiles of 32): batch, hidden and input widths on both
# sides of each boundary.
LSTM_EDGE_B, LSTM_EDGE_H, LSTM_EDGE_D = (1, 5, 64, 65, 130), (8, 48, 256, 264), \
    (1, 24, 128, 256, 2048)
# Shapes the 16-byte copies cannot take (H not a multiple of 8, d_in not of
# the vector width) and d_in + H at the old limit of 7,264.
LSTM_PLAIN_LOADS = [(3, 7, 13), (2, 9, 250), (66, 130, 36), (2, 7000, 264)]


def check_lstm_cell(gen) -> float:
    """Kernel vs plain version at the served shapes, the JAX suite's, the
    tiling's edges and the unaligned shapes, fp32 and bf16; inputs that are
    not 16-byte aligned; two launches on the same inputs bit for bit.
    Returns the fp32 max abs error at the served shapes."""
    import itertools

    from repro_torch.kernels.lstm_cell.ops import lstm_cell_op
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    err = 0.0
    served = [(BATCH, 128, 256), (BATCH, 256, 256)]
    # ragged tiles (the JAX suite's shapes) and a long contraction
    edges = [(5, 24, 48), (4, 16, 32), (3, 2048, 256)]
    grid = list(itertools.product(LSTM_EDGE_B, LSTM_EDGE_D, LSTM_EDGE_H))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for B, d_in, H in served + edges + grid + LSTM_PLAIN_LOADS:
            args = lstm_inputs(B, d_in, H, dtype, gen)
            got = lstm_cell_op(*args)
            again = lstm_cell_op(*args)
            torch.cuda.synchronize()
            want = lstm_cell_ref(*args)
            for g, a, w in zip(got, again, want):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)
                if not torch.equal(g, a):
                    fail(f"lstm_cell {dtype} B={B} d_in={d_in} H={H}: two launches differ")
                if dtype == torch.float32 and (B, d_in, H) in served:
                    err = max(err, (g - w).abs().max().item())
            if (B, d_in, H) in served + edges:
                print(f"lstm_cell {dtype} B={B} d_in={d_in} H={H}: matches plain (tol {tol})")
        # every input one element past a 16-byte boundary
        B, d_in, H = 5, 24, 48
        shifted = [torch.empty(t.numel() + 1, dtype=dtype, device="cuda")[1:].view(t.shape)
                   .copy_(t) for t in lstm_inputs(B, d_in, H, dtype, gen)]
        for g, w in zip(lstm_cell_op(*shifted), lstm_cell_ref(*shifted)):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        print(f"lstm_cell {dtype}: matches plain at {len(grid)} edge shapes (B {LSTM_EDGE_B}, "
              f"d_in {LSTM_EDGE_D}, H {LSTM_EDGE_H}), {len(LSTM_PLAIN_LOADS)} shapes of plain "
              f"loads and unaligned inputs (tol {tol}); two launches identical bit for bit")
    return err


def time_lstm_cell(gen, bw: float, flops: float) -> dict:
    """Times at the two served shapes, weighted by the serving mix: per
    batch 128 encoder layer-0 steps and 24 decoder steps at d_in=128, 256
    steps of encoder layers 1-2 at d_in=256."""
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_op
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    mix = {128: 128 + 24, 256: 2 * 128}
    B, H = BATCH, 256
    rows = {}
    for d_in in mix:
        x, h, c, wx, wh, b = lstm_inputs(B, d_in, H, torch.float32, gen)
        w_ih, w_hh = wx.t().contiguous(), wh.t().contiguous()
        b_ih = b.clone()
        b_ih[H : 2 * H] += 1.0  # the +1 forget bias folded in
        b_hh = torch.zeros_like(b)
        lib = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
        for g, w in zip(lib, lstm_cell_ref(x, h, c, wx, wh, b)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        n_bytes = 4 * (B * d_in + 2 * B * H + (d_in + H) * 4 * H + 4 * H + 2 * B * H)
        n_ops = 2 * B * (d_in + H) * 4 * H + 2 * B * 4 * H
        rows[d_in] = {
            "ms": device_ms(lambda: lstm_cell_op(x, h, c, wx, wh, b)),
            "plain_ms": device_ms(lambda: lstm_cell_ref(x, h, c, wx, wh, b)),
            "library_ms": device_ms(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)),
            "bytes_ms": n_bytes / bw * 1e3,
            "ops_ms": n_ops / flops * 1e3,
        }
        print(f"lstm_cell fp32 d_in={d_in}: {json.dumps(rows[d_in])}")
    total = sum(mix.values())

    def mean(key):
        return sum(n * rows[d][key] for d, n in mix.items()) / total

    bytes_ms, ops_ms = mean("bytes_ms"), mean("ops_ms")
    return {"ms": mean("ms"), "plain_ms": mean("plain_ms"), "library_ms": mean("library_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "by_d_in": rows, **host_cost_lstm_cell(gen)}


def host_cost_lstm_cell(gen, n: int = 200, n_loop: int = 2000) -> dict:
    """The host's cost of one ``lstm_cell_op`` call at the served shape
    (B=64, d_in=256, H=256, fp32): the wall clock of ``n`` calls queued
    behind a spin kernel, so that only the host's work is timed; and of
    ``n_loop`` calls back to back, synchronised at the end, the rate at
    which a loop of cell steps runs when nothing else is in the way. Then
    the issue cost of the library's entry point alone (pointers and stream
    ready: ctypes and the launch, without the wrapper's Python) and of one
    ``torch.lstm_cell`` call, as yardsticks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_op

    args = lstm_inputs(BATCH, 256, 256, torch.float32, gen)
    x, h, c, wx, wh, b = args
    entry = _build.library().lstm_cell_f32
    outs = torch.empty_like(h), torch.empty_like(c)
    ptrs = [t.data_ptr() for t in (x, h, c, wx, wh, b, *outs)]
    stream = _build.current_stream(x.device)
    _build.check(entry(*ptrs, BATCH, 256, 256, stream), "lstm_cell")
    w_ih, w_hh = wx.t().contiguous(), wh.t().contiguous()
    for _ in range(10):
        lstm_cell_op(*args)
    torch.cuda.synchronize()

    def issue_cost(call) -> float:
        """µs a call takes to issue, ``n`` calls queued behind a spin kernel
        (~0.1 s)."""
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / n * 1e6

    issue_us = issue_cost(lambda: lstm_cell_op(*args))
    t0 = time.perf_counter()
    for _ in range(n_loop):
        lstm_cell_op(*args)
    torch.cuda.synchronize()
    loop_us = (time.perf_counter() - t0) / n_loop * 1e6
    entry_us = issue_cost(lambda: entry(*ptrs, BATCH, 256, 256, stream))
    library_us = issue_cost(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b))
    print(f"lstm_cell_op host cost: {issue_us:.2f} us a call to issue ({n} calls behind a spin "
          f"kernel; the library entry alone {entry_us:.2f} us; torch.lstm_cell "
          f"{library_us:.2f} us); {loop_us:.2f} us a call back to back ({n_loop} calls, "
          f"synchronised)")
    return {"host_issue_us": issue_us, "back_to_back_us": loop_us,
            "entry_host_issue_us": entry_us, "library_host_issue_us": library_us}


def flat_rows(rows):
    from repro_torch.core.bytesops import flatten

    buf = torch.from_numpy(flatten([r.replace("\x00", " ") for r in rows])).cuda()
    ends = torch.nonzero(buf == 0).flatten() + 1
    return buf, torch.cat([ends.new_zeros(1), ends])


def flat_column(values):
    """A column of strings as one flat buffer and its row offsets on the
    card, without terminators."""
    enc = [v.encode() for v in values]
    lens = torch.tensor([len(e) for e in enc])
    return (torch.frombuffer(bytearray(b"".join(enc)), dtype=torch.uint8).cuda(),
            torch.cat([lens.new_zeros(1), lens.cumsum(0)]).cuda())


def at_odd_address(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the card that starts 1 byte past an aligned one,
    so the kernels take their instance for unaligned buffers."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 1
    return out


def byte_layouts() -> dict:
    """The row layouts chosen against the byte kernels' work split
    (``tiles.layouts``), the 300 ragged rows again at an odd address, and
    one 8 MB row of nested '<'/'>' noise, which one block walks."""
    from repro_torch.kernels.text_clean.tiles import layouts

    cases = {name: (torch.from_numpy(b).cuda(), torch.from_numpy(o).cuda())
             for name, (b, o) in layouts(SEED).items()}
    buf, offsets = cases["ragged_300_rows"]
    cases["ragged_300_rows_at_odd_address"] = (at_odd_address(buf), offsets)
    gen = torch.Generator().manual_seed(SEED)
    alphabet = torch.tensor(list(b"<<<>>>aZ( ).\x00"), dtype=torch.uint8)
    giant = alphabet[torch.randint(0, alphabet.numel(), (8 << 20,), generator=gen)].cuda()
    cases["giant_row_8mb"] = (giant, torch.tensor([0, giant.numel()], device="cuda"))
    return cases


def print_resources(source: str) -> None:
    """ptxas's registers and shared memory of each kernel of ``source``,
    where this process built the library."""
    from repro_torch.kernels import _build

    kernels = _build.build_report.get(source, {}).get("kernels", {})
    for kernel, resources in kernels.items():
        print(f"  {source} {kernel}: {resources}")
    if not kernels:
        print(f"  {source}: no ptxas report (the library was built by another process)")


def check_text_scan(abstracts, titles) -> float:
    import itertools

    from repro_torch.kernels.text_clean.ops import scan_flat, text_scan_op
    from repro_torch.kernels.text_clean.ref import text_scan_ref

    rows = abstracts[:256] + titles[:256] + ADVERSARIAL
    buf, offsets = flat_rows(rows)
    gen = torch.Generator().manual_seed(SEED)
    alphabet = torch.tensor(list(b"<>()aZ \x00\xff"), dtype=torch.uint8)
    noise = alphabet[torch.randint(0, alphabet.numel(), (64 * 1500,), generator=gen)].cuda()
    noise_offsets = torch.arange(65, dtype=torch.int64, device="cuda") * 1500
    err = 0
    for lower, html, parens in itertools.product((False, True), repeat=3):
        flags = dict(lower=lower, strip_html=html, strip_parens=parens)
        for b, o in ((buf, offsets), (noise, noise_offsets)):
            got = text_scan_op(b, o, **flags)
            torch.cuda.synchronize()
            diff = (got.int() - text_scan_ref(b, o, **flags).int()).abs().max().item()
            err = max(err, diff)
            if diff:
                fail(f"text_scan differs from its plain version with {flags}")
        np_buf = buf.cpu().numpy()
        if scan_flat(np_buf, device="cuda", **flags).tobytes() != \
                scan_flat(np_buf, device="cpu", **flags).tobytes():
            fail(f"scan_flat on the card differs from the CPU with {flags}")
    cases = {"served_rows_at_odd_address": (at_odd_address(buf), offsets), **byte_layouts()}
    for name, (b, o) in cases.items():
        for lower, html, parens in itertools.product((False, True), repeat=3):
            flags = dict(lower=lower, strip_html=html, strip_parens=parens)
            got, again = text_scan_op(b, o, **flags), text_scan_op(b, o, **flags)
            torch.cuda.synchronize()
            if not torch.equal(got, text_scan_ref(b, o, **flags)):
                fail(f"text_scan differs from its plain version on {name} with {flags}")
            if not torch.equal(got, again):
                fail(f"two text_scan launches differ on {name} with {flags}")
    print(f"text_scan: bytes identical to plain for all 8 flag sets "
          f"({buf.numel()} + {noise.numel()} bytes), and at {len(cases)} layouts "
          f"({', '.join(cases)}); two launches identical")
    print_resources("text_scan.cu")
    return float(err)


def time_text_scan(abstracts, bw: float) -> dict:
    """One served batch: 64 raw abstracts, all three flags on; by both
    timers."""
    from repro_torch.kernels.text_clean.ops import text_scan_op
    from repro_torch.kernels.text_clean.ref import text_scan_ref

    buf, offsets = flat_rows(abstracts[:BATCH])
    flags = dict(lower=True, strip_html=True, strip_parens=True)
    n_bytes = 2 * buf.numel() + 8 * offsets.numel()
    print(f"text_scan timed on one batch: {offsets.numel() - 1} rows, {buf.numel()} bytes")
    def kernel():
        return text_scan_op(buf, offsets, **flags)

    row = {"ms": device_ms(kernel), "ms_burst": device_ms_burst(kernel),
           "plain_ms": device_ms(lambda: text_scan_ref(buf, offsets, **flags)),
           "library_ms": None, "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes"}
    print(f"text_scan batch: {json.dumps(row)}")
    return row


def clean_noise(gen, n: int, width: int) -> torch.Tensor:
    """Random bytes on the card, 70% of them drawn from '<', '>', NUL,
    uppercase, lowercase, space and bytes above 127."""
    alphabet = torch.tensor(list(b"<<>>\x00AZaz \xc3\xa9\xff."), dtype=torch.uint8)
    mat = torch.randint(0, 256, (n, width), generator=gen, dtype=torch.uint8)
    pick = torch.rand(n, width, generator=gen) < 0.7
    mat[pick] = alphabet[torch.randint(0, alphabet.numel(), (int(pick.sum()),), generator=gen)]
    return mat.cuda()


def check_text_clean(gen) -> float:
    """The character cleaning kernel against its plain version, with and
    without the HTML span: the JAX suite's rows, random bytes at widths 1
    to 5,000 (one matrix per width, and ragged rows of every length up to
    5,000 by offsets), 4,096 x 512 random printable bytes; then
    ``clean_rows`` on the card against the CPU."""
    from repro_torch.kernels.text_clean.ops import (clean_rows, pack_rows, text_clean_flat,
                                                    text_clean_op)
    from repro_torch.kernels.text_clean.ref import text_clean_flat_ref, text_clean_ref

    mats = [torch.from_numpy(pack_rows(CLEAN_ROWS * 7)).cuda(),
            torch.randint(32, 127, (4096, 512), generator=gen, dtype=torch.uint8).cuda()]
    mats += [clean_noise(gen, 9, w) for w in CLEAN_WIDTHS]
    lens = torch.randint(0, 5001, (300,), generator=gen)
    lens[:3] = torch.tensor([0, 1, 5000])
    flat = clean_noise(gen, 1, int(lens.sum())).view(-1)
    offsets = torch.cat([lens.new_zeros(1), lens.cumsum(0)]).cuda()
    n_bytes = 0
    for html in (True, False):
        for mat in mats:
            got = text_clean_op(mat, strip_html=html)
            torch.cuda.synchronize()
            if not torch.equal(got, text_clean_ref(mat, strip_html=html)):
                fail(f"text_clean differs from its plain version at {tuple(mat.shape)}, "
                     f"strip_html={html}")
            n_bytes += mat.numel()
        got = text_clean_flat(flat, offsets, strip_html=html)
        torch.cuda.synchronize()
        if not torch.equal(got, text_clean_flat_ref(flat, offsets, strip_html=html)):
            fail(f"text_clean differs from its plain version on ragged rows, strip_html={html}")
        rows = ADVERSARIAL + CLEAN_ROWS
        if clean_rows(rows, strip_html=html, device="cuda") != \
                clean_rows(rows, strip_html=html, device="cpu"):
            fail(f"clean_rows on the card differs from the CPU, strip_html={html}")
    mat = mats[1]
    cases = {"matrix_4096x512_at_odd_address": (at_odd_address(mat), None), **byte_layouts()}
    for name, (b, o) in cases.items():
        for html in (True, False):
            if o is None:
                got, again = text_clean_op(b, strip_html=html), text_clean_op(b, strip_html=html)
                want = text_clean_ref(b, strip_html=html)
            else:
                got = text_clean_flat(b, o, strip_html=html)
                again = text_clean_flat(b, o, strip_html=html)
                want = text_clean_flat_ref(b, o, strip_html=html)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"text_clean differs from its plain version on {name}, strip_html={html}")
            if not torch.equal(got, again):
                fail(f"two text_clean launches differ on {name}, strip_html={html}")
    print(f"text_clean: bytes identical to plain with and without strip_html at "
          f"{len(mats)} matrices ({n_bytes // 2} bytes) and {lens.numel()} ragged rows of "
          f"0-5000 bytes, and at {len(cases)} layouts ({', '.join(cases)}); two launches "
          f"identical; clean_rows on the card equals the CPU")
    print_resources("text_clean.cu")
    return 0.0


def time_text_clean(gen, abstracts_flat, bw: float) -> dict:
    """The kernel at 4,096 x 512 (``benchmarks/bench_kernels.py:111``) and
    over the preprocessing phase's abstract column (flat, by offsets), by
    both timers: each byte read once and written once, plus the offsets."""
    from repro_torch.kernels.text_clean.ops import text_clean_flat, text_clean_op
    from repro_torch.kernels.text_clean.ref import text_clean_flat_ref, text_clean_ref

    mat = torch.randint(32, 127, (4096, 512), generator=gen, dtype=torch.uint8).cuda()
    buf, offsets = abstracts_flat
    rows = {}
    for label, fn, plain, n_bytes, shape in (
            ("matrix", lambda: text_clean_op(mat), lambda: text_clean_ref(mat),
             2 * mat.numel(), list(mat.shape)),
            ("abstracts", lambda: text_clean_flat(buf, offsets),
             lambda: text_clean_flat_ref(buf, offsets), 2 * buf.numel() + 8 * offsets.numel(),
             [offsets.numel() - 1, buf.numel()])):
        rows[label] = {"ms": device_ms(fn), "ms_burst": device_ms_burst(fn),
                       "plain_ms": device_ms(plain), "library_ms": None,
                       "bound_ms": n_bytes / bw * 1e3, "bound_by": "bytes", "shape": shape}
        print(f"text_clean {label}: {json.dumps(rows[label])}")
    return rows


def preprocess(workdir: Path):
    """Algorithm 1 on the card: corpus -> ingest -> pre_clean -> device
    cleaning of both columns, held against the CPU. Returns the cleaned
    frame, the pre-cleaned frame, the abstract column as a flat buffer
    with offsets on the card (for timing), the launches and the
    ``preprocess`` line. The corpus stays in ``workdir`` for the
    ``p3sapp`` phase."""
    from repro_torch.core.device_pipeline import device_case_study_cleaner
    from repro_torch.core.ingest import ingest, pre_clean
    from repro_torch.data.synthetic import write_corpus
    from repro_torch.kernels.text_clean import ops as clean_ops

    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_corpus(workdir, CORPUS_BYTES, n_files=CORPUS_FILES, seed=SEED)
    corpus_bytes = sum(p.stat().st_size for p in paths)
    times = {"write_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    # one process: a pool's spawned workers import this script, and torch, again
    frame = ingest([workdir], FIELDS)
    times["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clean = pre_clean(frame, list(FIELDS))
    times["pre_clean_s"] = time.perf_counter() - t0

    cleaner = device_case_study_cleaner()
    clean_ops.LAUNCHES["text_clean"] = 0
    t0 = time.perf_counter()
    out = cleaner.transform(clean, list(FIELDS))
    times["clean_s"] = time.perf_counter() - t0
    launches = clean_ops.LAUNCHES["text_clean"]
    times.update({f"{k}_s": v for k, v in cleaner.seconds.items()})
    if launches != len(FIELDS):
        fail(f"cleaning {len(FIELDS)} columns made {launches} text_clean launches")
    cpu = device_case_study_cleaner("cpu").transform(clean, list(FIELDS))
    n_values = same = 0
    for f in FIELDS:
        same += sum(a == b for a, b in zip(out[f], cpu[f]))
        n_values += len(cpu[f])
    if len(out) != len(clean) or same != n_values:
        fail(f"device cleaning equals the CPU in {same} of {n_values} values")
    if not all(set(v) <= set("abcdefghijklmnopqrstuvwxyz ") for v in out["abstract"][:1000]):
        fail("a cleaned abstract holds a byte outside [a-z ]")
    print(f"preprocess: {corpus_bytes} bytes of JSONL in {len(paths)} shards written in "
          f"{times['write_s']:.3f} s, {len(frame)} records")
    print(f"preprocess: ingest (1 process) {times['ingest_s']:.3f} s")
    print(f"preprocess: pre_clean {times['pre_clean_s']:.3f} s -> {len(clean)} records")
    print(f"preprocess: device cleaning of {len(FIELDS)} columns {times['device_clean_s']:.3f} s "
          f"({launches} text_clean launches)")
    print(f"preprocess: word tail {times['word_tail_s']:.3f} s; cleaned values equal to the CPU "
          f"path: {same} of {n_values}")
    abstracts_flat = flat_column(clean["abstract"])
    line = {"corpus_bytes": corpus_bytes, "shards": len(paths), "records": len(frame),
            "records_clean": len(clean), **times, "text_clean_launches": launches,
            "equal_to_cpu": same / n_values}
    return out, clean, abstracts_flat, launches, line


def reductions(pa, ca) -> dict:
    """Per cent of CA's time that P3SAPP saves, by stage (paper eq. 7)."""
    return {stage: 100 * (1 - getattr(pa, stage) / getattr(ca, stage))
            for stage in ("ingestion", "preprocessing", "cumulative")}


def check_p3sapp_scan(clean) -> tuple[dict, tuple]:
    """The abstract column's scan pass (the pre-cleaned frame's flat
    buffer, as ``run_p3sapp`` gives it to the kernel): ``scan_flat`` on the
    card byte for byte against the host's ``_run_scan`` of the same
    ``ScanPass``, and ``text_scan`` against its plain version on the card.
    Returns what was held and the column on the card (for timing)."""
    from repro_torch.core import bytesops as B
    from repro_torch.core.pipeline import compile_column_plans
    from repro_torch.core.stages import abstract_stages
    from repro_torch.kernels.text_clean.ops import scan_flat, text_scan_op
    from repro_torch.kernels.text_clean.ref import text_scan_ref

    scans = []
    for optimize in (False, True):
        (_, _, ops), = compile_column_plans(abstract_stages(), optimize)
        scans.append([p for kind, p in B.compile_megapass(ops) if kind == "scan"])
    (sp,), (sp_fused,) = scans
    flags = B._kernel_scan_args(sp)
    if flags != dict(lower=True, strip_html=True, strip_parens=True) or \
            B._kernel_scan_args(sp_fused) != flags:
        fail(f"the abstract chain's scan pass is not the kernel's: {flags}")
    buf = clean.flat("abstract")
    t0 = time.perf_counter()
    got = scan_flat(buf, device="cuda", **flags)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = B._run_scan(buf, sp)
    host_s = time.perf_counter() - t0
    if got.tobytes() != want.tobytes():
        n = min(got.size, want.size)
        diff = np.flatnonzero(got[:n] != want[:n])
        first = int(diff[0]) if diff.size else n
        fail(f"p3sapp: the abstract column's scan on the card differs from the host's "
             f"_run_scan ({got.size} vs {want.size} bytes, first difference at byte {first})")
    t = torch.from_numpy(buf).cuda()
    offsets = torch.cat([t.new_zeros(1, dtype=torch.int64),
                         torch.nonzero(t == 0).flatten() + 1])
    if not torch.equal(text_scan_op(t, offsets, **flags), text_scan_ref(t, offsets, **flags)):
        fail("p3sapp: text_scan differs from its plain version over the abstract column")
    held = {"bytes": int(buf.size), "rows": int(offsets.numel() - 1), "bytes_out": int(got.size),
            "identical_to_host_run_scan": True, "identical_to_plain": True,
            "scan_flat_s": card_s, "host_run_scan_s": host_s}
    print(f"p3sapp: the abstract column's scan ({held['rows']} rows, {buf.size} bytes -> "
          f"{got.size}) on the card identical to the host's _run_scan "
          f"({card_s:.3f} s vs {host_s:.3f} s, host clock) and to the plain version")
    return held, (t, offsets)


def time_text_scan_column(column, bw: float) -> dict:
    """``text_scan`` over the abstract column as ``run_p3sapp`` gives it,
    all three flags on, by both timers: each byte read once and written
    once, plus the offsets."""
    from repro_torch.kernels.text_clean.ops import text_scan_op
    from repro_torch.kernels.text_clean.ref import text_scan_ref

    buf, offsets = column
    flags = dict(lower=True, strip_html=True, strip_parens=True)
    def kernel():
        return text_scan_op(buf, offsets, **flags)

    row = {"ms": device_ms(kernel), "ms_burst": device_ms_burst(kernel),
           "plain_ms": device_ms(lambda: text_scan_ref(buf, offsets, **flags)),
           "library_ms": None, "bound_ms": (2 * buf.numel() + 8 * offsets.numel()) / bw * 1e3,
           "bound_by": "bytes", "shape": [offsets.numel() - 1, buf.numel()]}
    print(f"text_scan p3sapp column: {json.dumps(row)}")
    return row


def p3sapp(workdir: Path, scan_held: dict) -> tuple[dict, dict, list]:
    """The paper's comparison on the corpus in ``workdir``: CA (Algorithm
    2), P3SAPP on the card at both ``optimize`` values (exactly
    ``P3SAPP_SCANS`` ``text_scan`` launches each, one worker), P3SAPP on the
    host (``loops``, CPU); records equal to CA's and 100% record match.
    Returns the launches of each card run, the ``p3sapp`` line and the
    records."""
    from repro_torch.core.p3sapp import record_match_accuracy, run_conventional, run_p3sapp
    from repro_torch.kernels.text_clean import ops as clean_ops

    records_ca, t_ca = run_conventional([workdir])
    print(f"p3sapp: CA {len(records_ca)} records, {json.dumps(t_ca.as_dict())}")
    runs, launches = {}, {}
    for optimize in (False, True):
        clean_ops.LAUNCHES["text_scan"] = 0
        records, t = run_p3sapp([workdir], workers=1, optimize=optimize)
        key, label = f"optimize_{str(optimize).lower()}", f"card, optimize={optimize}"
        n = launches[key] = clean_ops.LAUNCHES["text_scan"]
        if n != P3SAPP_SCANS[optimize]:
            fail(f"p3sapp ({label}) made {n} text_scan launches, not {P3SAPP_SCANS[optimize]}")
        if records != records_ca:
            same = sum(a == b for a, b in zip(records, records_ca))
            fail(f"p3sapp ({label}): {len(records)} records, {same} equal to CA's "
                 f"{len(records_ca)}")
        match = {f: record_match_accuracy(records_ca, records, f)["percentage"] for f in FIELDS}
        if any(v != 100.0 for v in match.values()):
            fail(f"p3sapp ({label}): record match {match}")
        runs[f"card_{key}"] = {**t.as_dict(), "text_scan_launches": n, "record_match": match,
                               "reductions_vs_ca": reductions(t, t_ca)}
        print(f"p3sapp: {label}: {n} text_scan launches, records equal to CA's, "
              f"{json.dumps(runs[f'card_{key}'])}")
        card_records = records
    clean_ops.LAUNCHES["text_scan"] = 0
    records, t = run_p3sapp([workdir], workers=1, backend="loops", device="cpu")
    if clean_ops.LAUNCHES["text_scan"]:
        fail("p3sapp on the host launched text_scan")
    if records != card_records:
        fail("p3sapp: the host path's records differ from the card's")
    runs["host_loops"] = {**t.as_dict(), "reductions_vs_ca": reductions(t, t_ca)}
    print(f"p3sapp: host (loops, CPU): records equal to the card's, "
          f"{json.dumps(runs['host_loops'])}")
    line = {"records": len(records_ca), "ca": t_ca.as_dict(), **runs,
            "records_equal_to_ca": True, "abstract_scan": scan_held}
    return launches, line, records_ca


def dataset(workdir: Path, p3sapp_records: list) -> tuple[dict, dict]:
    """The ``Dataset`` planner on the card over the corpus in ``workdir``:
    the reference example's chain whole-frame (records equal to
    ``run_p3sapp``'s, 2 ``text_scan`` launches); its streamed token path on
    4 executor threads (``fit_vocab`` and an epoch of ``device_batches``
    into ``DeviceFeed``, 2 launches a shard each, every batch on the grid
    and equal bit for bit to the same chain under ``loops`` on the host;
    with the cache on, the cross-shard dedup touches it nowhere); the chain
    without dedup through the shard cache (``fit_vocab``, a cold and a
    warm epoch: 16, 0 and 0 launches, the reference's hit and miss
    pattern); and ``make_input_pipeline`` feeding 20 ``TrainController``
    steps at CONFIG width, exact ``lstm_cell``/``lstm_cell_bwd`` counts.
    Returns the launches and the ``dataset`` line."""
    import tempfile

    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.expr import abstract_expr, col, title_expr
    from repro_torch.core.ingest import list_shards
    from repro_torch.data.batching import seq2seq_specs
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.text_clean import ops as clean_ops
    from repro_torch.models.seq2seq import Seq2Seq
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.fault_tolerance import TrainController
    from repro_torch.runtime.train_loop import (functional_loss, make_input_pipeline,
                                                make_train_step, params_of)

    started = time.perf_counter()
    shards = len(list_shards([workdir]))
    per_pass = len(FIELDS) * shards  # one kernel scan a column and shard
    keep = col("title").not_empty() & col("abstract").not_empty()
    specs = seq2seq_specs(CONFIG.max_abstract_len, CONFIG.max_title_len)
    walls, launches, line = {}, {}, {"shards": shards, "workers": DATASET_WORKERS}

    def chain(dedup=True):
        ds = Dataset.from_json_dirs([workdir]).where(keep)
        if dedup:
            ds = ds.drop_duplicates()
        return ds.transform(abstract=abstract_expr(), title=title_expr()).where(keep)

    def batched(ds, tok):
        return (ds.tokenize(tok, specs)
                .batched(DATASET_BATCH, shuffle=False,
                         bucket_by=("encoder_tokens", "decoder_tokens"))
                .prefetch(2))

    def scans(label, want, fn):
        """``fn()`` with the text_scan counter set to 0 just before and
        read just after; its wall time; fails unless ``want`` launches."""
        clean_ops.LAUNCHES["text_scan"] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        n = launches[label] = clean_ops.LAUNCHES["text_scan"]
        if n != want:
            fail(f"dataset ({label}) made {n} text_scan launches, expected {want}")
        return out

    def counters(stats):
        return {k: stats.get(k, 0) for k in ("cache_hits", "cache_misses",
                                             "token_cache_hits", "token_cache_misses")}

    # 1. whole frame, optimized: one kernel scan a column
    records, timings = scans("whole_frame", len(FIELDS), lambda: chain().execute(optimize=True))
    if records != p3sapp_records:
        fail(f"dataset: the example chain's {len(records)} records differ from run_p3sapp's "
             f"{len(p3sapp_records)}")
    line["whole_frame"] = {"records": len(records), "timings": timings.as_dict()}
    print(f"dataset: whole frame {walls['whole_frame']:.3f} s, {len(records)} records equal "
          f"to run_p3sapp's, {launches['whole_frame']} text_scan launches; "
          f"{json.dumps(timings.as_dict())}")

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache_root:
        # 2. the streamed token path of the dedup chain: nothing memoized
        src = chain().workers(DATASET_WORKERS).cache(Path(cache_root) / "dedup")
        fit_stats, stats = {}, {}
        tok = scans("fit_vocab", per_pass,
                    lambda: src.fit_vocab(vocab_size=CONFIG.vocab_size, stats=fit_stats))
        stream = batched(src, tok)
        grid = stream.bucket_grid_spec()

        def epoch():
            feed = stream.device_batches(overlap=True, stats=stats)
            got = []
            try:
                for batch in feed:
                    with feed.step(batch):
                        got.append({k: batch[k].cpu().numpy() for k in batch})
            finally:
                feed.close()
            return got, feed.report()

        card, report = scans("epoch", per_pass, epoch)
        t0 = time.perf_counter()
        host = list(batched(chain().workers(DATASET_WORKERS).backend("loops").device("cpu"),
                            tok).iter_batches())
        walls["host_loops_epoch"] = time.perf_counter() - t0
        if len(card) != len(host):
            fail(f"dataset: {len(card)} batches on the card, {len(host)} on the host")
        for i, (a, b) in enumerate(zip(card, host)):
            want = grid.snap(b)
            if a.keys() != want.keys() or not all(
                    a[k].dtype == want[k].dtype and np.array_equal(a[k], want[k]) for k in a):
                fail(f"dataset: streamed batch {i} differs from the host's under loops")
            if grid.cell_key(a) != grid.cell_key(want) or any(
                    a[k].shape[1] not in grid.widths[k] for k in grid.widths):
                fail(f"dataset: streamed batch {i} left the bucket grid")
        for label, st in (("fit_vocab", fit_stats), ("epoch", stats)):
            if st.get("executor") != "thread" or any(counters(st).values()):
                fail(f"dataset: the dedup chain's {label} reports {st.get('executor')} and "
                     f"cache counters {counters(st)}, expected thread and all 0")
        line["stream"] = {"batches": len(card), "vocab": len(tok),
                          "executor": stats["executor"], "fit_vocab_cache": counters(fit_stats),
                          "epoch_cache": counters(stats),
                          "epoch_timings": stats["timings"].as_dict(),
                          "fit_vocab_timings": fit_stats["timings"].as_dict(),
                          "feed": report.as_dict(), "equal_to_host_loops": True}
        print(f"dataset: streamed fit_vocab {walls['fit_vocab']:.3f} s and epoch "
              f"{walls['epoch']:.3f} s on {DATASET_WORKERS} threads ({launches['fit_vocab']} "
              f"and {launches['epoch']} text_scan launches, {len(card)} batches of "
              f"{DATASET_BATCH} on the grid, each equal bit for bit to the host's under loops, "
              f"{walls['host_loops_epoch']:.3f} s); cache counters all 0 with the dedup; "
              f"epoch StageTimings {json.dumps(stats['timings'].as_dict())}; feed report "
              f"{json.dumps(report.as_dict())}")

        # 3. the chain without dedup through the shard cache
        cached = chain(dedup=False).workers(DATASET_WORKERS).cache(Path(cache_root) / "cache")
        fit_stats = {}
        ctok = scans("cache_fit_vocab", per_pass,
                     lambda: cached.fit_vocab(vocab_size=CONFIG.vocab_size, stats=fit_stats))
        cstream = batched(cached, ctok)
        cold_stats, warm_stats = {}, {}
        cold = scans("cache_cold", 0, lambda: list(cstream.iter_batches(stats=cold_stats)))
        warm = scans("cache_warm", 0, lambda: list(cstream.iter_batches(stats=warm_stats)))
        pattern = [counters(fit_stats), counters(cold_stats), counters(warm_stats)]
        want = [dict(cache_hits=0, cache_misses=0, token_cache_hits=0,
                     token_cache_misses=shards),
                dict(cache_hits=per_pass, cache_misses=0, token_cache_hits=0,
                     token_cache_misses=per_pass),
                dict(cache_hits=0, cache_misses=0, token_cache_hits=per_pass,
                     token_cache_misses=0)]
        if pattern != want:
            fail(f"dataset: cache counters {pattern}, expected {want}")
        if len(warm) != len(cold) or not all(
                np.array_equal(a[k], b[k]) for a, b in zip(warm, cold) for k in a):
            fail("dataset: the warm epoch's batches differ from the cold epoch's")
        line["cache"] = {"counters": pattern, "batches": len(cold),
                         "cold_timings": cold_stats["timings"].as_dict(),
                         "warm_timings": warm_stats["timings"].as_dict()}
        print(f"dataset: cache fit_vocab {walls['cache_fit_vocab']:.3f} s, cold epoch "
              f"{walls['cache_cold']:.3f} s, warm epoch {walls['cache_warm']:.3f} s; "
              f"text_scan launches {launches['cache_fit_vocab']}/{launches['cache_cold']}/"
              f"{launches['cache_warm']}; counters {json.dumps(pattern)}; warm batches equal "
              f"to cold")

    # 4. make_input_pipeline feeds the train step at CONFIG width
    model = Seq2Seq(CONFIG, "cuda", seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 5, DATASET_STEPS), weight_decay=1e-4)
    train_step = make_train_step(functional_loss(model), opt)
    train_stats = {}
    feed = make_input_pipeline(batched(chain().workers(DATASET_WORKERS), tok), epochs=None,
                               overlap=True, stats=train_stats)
    widths = []

    def fed_step(params, opt_state, batch):
        with feed.step(batch):
            widths.append((batch["encoder_tokens"].shape[1], batch["decoder_tokens"].shape[1]))
            out = train_step(params, opt_state, batch)
            torch.cuda.synchronize()
        return out

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        controller = TrainController(ckpt_dir, fed_step, init_state, save_every=10 ** 6)
        lstm_ops.LAUNCHES["lstm_cell"] = lstm_ops.LAUNCHES["lstm_cell_bwd"] = 0
        t0 = time.perf_counter()
        try:
            history = controller.run(iter(feed), n_steps=DATASET_STEPS)
        finally:
            feed.close()
        walls["train"] = time.perf_counter() - t0
        step_launches = dict(lstm_ops.LAUNCHES)
    want_steps = sum(e * CONFIG.n_encoder_layers + d - 1 for e, d in widths)
    if len(history) != DATASET_STEPS or step_launches != {"lstm_cell": want_steps,
                                                          "lstm_cell_bwd": want_steps}:
        fail(f"dataset: {len(history)} planner-fed steps and launches {step_launches}, "
             f"expected {DATASET_STEPS} and {want_steps} of each")
    losses = [h["loss"] for h in history]
    if not np.isfinite(losses).all():
        fail(f"dataset: a non-finite loss {losses}")
    report = feed.report()
    walls["phase"] = time.perf_counter() - started
    line["train"] = {"steps": len(history), "batch": DATASET_BATCH, "widths": widths,
                     "lstm_cell_launches": step_launches["lstm_cell"],
                     "lstm_cell_bwd_launches": step_launches["lstm_cell_bwd"],
                     "losses": losses, "feed": report.as_dict(),
                     "executor": train_stats.get("executor", "thread")}
    line.update({"seconds": walls, "text_scan_launches": launches})
    print(f"dataset: {len(history)} steps of {DATASET_BATCH} fed by make_input_pipeline in "
          f"{walls['train']:.3f} s; lstm_cell and lstm_cell_bwd launches "
          f"{step_launches['lstm_cell']} each (= sum of encoder width x "
          f"{CONFIG.n_encoder_layers} + decoder width - 1); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; feed report {json.dumps(report.as_dict())}")
    print(f"dataset: phase wall {walls['phase']:.3f} s")
    return {"text_scan": launches, "lstm_cell": step_launches["lstm_cell"],
            "lstm_cell_bwd": step_launches["lstm_cell_bwd"]}, line


def feed(cleaned):
    """32 batches of cleaned abstracts through ``DeviceFeed`` into
    ``Seq2Seq.encode`` at CONFIG width; returns the ``feed`` line."""
    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.core.device_pipeline import BucketGrid, DeviceFeed
    from repro_torch.data.tokenizer import PAD, WordTokenizer
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models.seq2seq import Seq2Seq

    abstracts = list(cleaned["abstract"])
    tok = WordTokenizer.fit(abstracts, vocab_size=FEED_VOCAB)
    grid = BucketGrid(BATCH, {"encoder_tokens": FEED_LADDER})
    hosts = []

    def batches():
        """Tokenized in the feed's fill thread, each trimmed to its longest row."""
        for i in range(FEED_BATCHES):
            ids = np.stack([tok.encode(t, CONFIG.max_abstract_len)
                            for t in abstracts[i * BATCH : (i + 1) * BATCH]])
            width = max(1, int((ids != PAD).sum(1).max()))
            hosts.append(ids[:, :width])
            yield {"encoder_tokens": ids[:, :width]}

    model = Seq2Seq(CONFIG, "cuda", seed=SEED)
    with torch.no_grad():
        model.encode(torch.ones(BATCH, 4, dtype=torch.int32, device="cuda"))  # warm-up
    torch.cuda.synchronize()
    lstm_ops.LAUNCHES["lstm_cell"] = 0
    widths = []
    t0 = time.perf_counter()
    the_feed = DeviceFeed(batches(), grid=grid, prefetch=2)
    try:
        for batch in the_feed:
            with the_feed.step(batch), torch.no_grad():
                enc = batch["encoder_tokens"]
                widths.append(enc.shape[1])
                hs, _, _ = model.encode(enc)
                torch.cuda.synchronize()
    finally:
        the_feed.close()
    seconds = time.perf_counter() - t0
    launches = lstm_ops.LAUNCHES["lstm_cell"]
    want = sum(widths) * CONFIG.n_encoder_layers
    if len(widths) != FEED_BATCHES or launches != want:
        fail(f"the feed ran {len(widths)} batches and {launches} lstm_cell launches, expected "
             f"{FEED_BATCHES} and {want}")
    if any(w not in FEED_LADDER for w in widths):
        fail(f"a batch left the bucket grid: widths {widths}")
    try:
        batch["encoder_tokens"]
        fail("a consumed DeviceBatch could still be read")
    except RuntimeError:
        pass
    # the last batch again: card vs CPU encoder states, same weights
    cpu = Seq2Seq(CONFIG, "cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    last = torch.from_numpy(grid.snap({"encoder_tokens": hosts[-1]})["encoder_tokens"])
    with torch.no_grad():
        hs_cpu = cpu.encode(last)[0]
    if not torch.isfinite(hs).all():
        fail("non-finite encoder states on the card")
    torch.testing.assert_close(hs.cpu(), hs_cpu, rtol=1e-4, atol=1e-4)
    err = (hs.cpu() - hs_cpu).abs().max().item()
    report = the_feed.report().as_dict()
    print(f"feed: {len(widths)} batches of {BATCH} in {seconds:.3f} s, snapped widths "
          f"{dict(sorted((w, widths.count(w)) for w in set(widths)))}; report {json.dumps(report)}")
    print(f"feed: lstm_cell launches {launches} = {sum(widths)} x {CONFIG.n_encoder_layers}; "
          f"last batch card vs CPU encoder states max abs err {err:.3e} (tol 1e-4); a consumed "
          f"batch raises on access")
    return {"batches": len(widths), "batch": BATCH, "seconds": seconds,
                      "widths": widths, "lstm_cell_launches": launches,
                      "encoder_max_abs_err": err, **report,
                      "loader": the_feed.loader_stats.as_dict()}


# The train phase: the example's training at CONFIG width on the cleaned
# corpus, batches of 32 on the 2-D bucket grid, 40 steps with a checkpoint at
# step 20 that a second controller resumes.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT, TRAIN_ROWS = 32, 40, 20, 4096
# lstm_cell_bwd at the training shape (B 32, H 256) and the edges of its
# grid of one thread per (row, unit): odd H, B x H off a 256-thread block.
BWD_SHAPES = [(TRAIN_BATCH, 256)] + [(B, H) for B in (1, 5, 64, 65, 130)
                                     for H in (8, 33, 256, 264)]
# the training entry of lstm_cell against the serving entry, bit for bit
TRAIN_ENTRY_SHAPES = [(TRAIN_BATCH, 128, 256), (TRAIN_BATCH, 256, 256), (5, 24, 48),
                      (3, 7, 13), (130, 256, 264), (65, 9, 33)]


def bwd_inputs(B, H, gen, d_in=24):
    """dh', dc' and what a training forward saves (its activated gates, c
    and c'), from the plain forward on random inputs on the card."""
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_train_ref

    x, h, c, wx, wh, b = lstm_inputs(B, d_in, H, torch.float32, gen)
    _, c_new, gates = lstm_cell_train_ref(x, h, c, wx, wh, b)
    dh, dc = (torch.randn(B, H, generator=gen).to("cuda") for _ in range(2))
    return dh, dc, gates, c, c_new


def check_lstm_cell_bwd(gen) -> float:
    """``lstm_cell_bwd`` against ``lstm_cell_bwd_ref`` on the card (fp32,
    1e-5; with dh' or dc' None too), two launches bit for bit; the training
    entry of ``lstm_cell`` against the serving entry bit for bit; one
    cell's six gradients through ``LSTMCellFunction`` on the card against
    the fp64 algebra, the CPU's beside them. Returns the max abs error at
    the training shape."""
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref, lstm_cell_train_ref

    err = 0.0
    for B, H in BWD_SHAPES:
        dh, dc, gates, c, c_new = bwd_inputs(B, H, gen)
        for a, b in ((dh, dc), (None, dc), (dh, None)):
            got = ops.lstm_cell_bwd(a, b, gates, c, c_new)
            again = ops.lstm_cell_bwd(a, b, gates, c, c_new)
            torch.cuda.synchronize()
            for g, r, w in zip(got, again, lstm_cell_bwd_ref(a, b, gates, c, c_new)):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
                if not torch.equal(g, r):
                    fail(f"lstm_cell_bwd B={B} H={H}: two launches differ")
                if (B, H) == (TRAIN_BATCH, 256):
                    err = max(err, (g - w).abs().max().item())
    print(f"lstm_cell_bwd: matches plain at {len(BWD_SHAPES)} shapes (B 1-130, H 8-264), with "
          f"dh' or dc' absent too (tol 1e-5); two launches identical bit for bit")
    for B, d_in, H in TRAIN_ENTRY_SHAPES:
        args = lstm_inputs(B, d_in, H, torch.float32, gen)
        h_t, c_t, gates = ops.lstm_cell_train(*args)
        h_s, c_s = ops.lstm_cell_op(*args)
        if not (torch.equal(h_t, h_s) and torch.equal(c_t, c_s)):
            fail(f"lstm_cell B={B} d_in={d_in} H={H}: the training entry's h', c' differ from "
                 f"the serving entry's")
        torch.testing.assert_close(gates, lstm_cell_train_ref(*args)[2], rtol=1e-5, atol=1e-5)
    print(f"lstm_cell training entry: h', c' equal to the serving entry bit for bit and gates "
          f"match plain (tol 1e-5) at {len(TRAIN_ENTRY_SHAPES)} shapes")
    args = lstm_inputs(TRAIN_BATCH, 128, 256, torch.float32, gen)
    cotangents = [torch.randn(TRAIN_BATCH, 256, generator=gen) for _ in range(2)]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in args]
        torch.autograd.backward(ops.lstm_cell_op(*leaves), [d.to(dev) for d in cotangents])
        grads[dev] = [t.grad.cpu() for t in leaves]
    # Held to the fp64 algebra: the host's fp32 CPU result has missed it by
    # 4.6e-5 in one row of dx in some calls, where the card's was 3.4e-7.
    # Printed beside each error: the tensor's largest |g| and the worst-case
    # fp32 rounding of its sum, K * 2^-24 * max (|A| @ |B|).
    errs = {}
    for name, g, w, t, bound in zip(("x", "h", "c", "wx", "wh", "b"), grads["cuda"],
                                    grads["cpu"], *cell_grads_fp64(args, cotangents)):
        errs[name] = {"card": (g.double() - t).abs().max().item(),
                      "cpu": (w.double() - t).abs().max().item(),
                      "max_abs": t.abs().max().item(), "fp32_sum_bound": bound}
        if not torch.allclose(g.double(), t, rtol=1e-5, atol=1e-5):
            fail(f"LSTMCellFunction d{name}: the card's gradient misses the fp64 algebra by "
                 f"{errs[name]['card']:.3e} (tol 1e-5; the CPU's by {errs[name]['cpu']:.3e})")
    print(f"LSTMCellFunction: one cell's six gradients on the card match the fp64 algebra "
          f"(tol 1e-5); host CPU {torch.backends.cpu.get_cpu_capability()}, "
          f"{torch.get_num_threads()} threads; errors against it: {json.dumps(errs)}")
    return err


def cell_grads_fp64(args, cotangents) -> tuple[list[torch.Tensor], list[float | None]]:
    """The six gradients of one cell in fp64 on the CPU (autograd of the
    plain algebra), and for each the worst-case rounding of its fp32 sum
    given dz: ``K * 2^-24 * max (|A| @ |B|)`` over the K terms of each
    product (None for dc, which is pointwise)."""
    x, h, c, wx, wh, b = leaves = [t.detach().cpu().double().requires_grad_(True) for t in args]
    z = x @ wx + h @ wh + b
    z.retain_grad()
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
    torch.autograd.backward((torch.sigmoid(o) * torch.tanh(c_new), c_new),
                            [d.double() for d in cotangents])
    dz = z.grad.abs()
    u = 2.0 ** -24

    def bound(a, b_):
        return a.shape[1] * u * (a @ b_).max().item()

    bounds = [bound(dz, wx.detach().abs().t()), bound(dz, wh.detach().abs().t()), None,
              bound(x.detach().abs().t(), dz), bound(h.detach().abs().t(), dz),
              dz.shape[0] * u * dz.sum(0).max().item()]
    return [t.grad for t in leaves], bounds


def time_lstm_cell_bwd(gen, bw: float, flops: float) -> dict:
    """The backward kernel at the training shape, both timers, beside its
    plain version, its bound and PyTorch's fused LSTM cell backward (given
    the same activated gates); and the training entry of the forward beside
    the serving entry at B 32, d_in 256."""
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref

    B, H = TRAIN_BATCH, 256
    dh, dc, gates, c, c_new = bwd_inputs(B, H, gen)

    def library():
        return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dh, dc, c, c_new, gates, True)

    want = lstm_cell_bwd_ref(dh, dc, gates, c, c_new)
    for g, w in zip(library()[:2], want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # reads dh', dc', the gates (4 per unit), c, c'; writes dz (4) and dc_prev
    n_bytes = 4 * B * H * (2 + 4 + 2 + 4 + 1)
    n_ops = 24 * B * H  # the kernel's multiplies, adds and one tanh per (row, unit)
    fwd = lstm_inputs(B, 256, H, torch.float32, gen)
    row = {"ms": device_ms(lambda: ops.lstm_cell_bwd(dh, dc, gates, c, c_new)),
           "ms_burst": device_ms_burst(lambda: ops.lstm_cell_bwd(dh, dc, gates, c, c_new)),
           "plain_ms": device_ms(lambda: lstm_cell_bwd_ref(dh, dc, gates, c, c_new)),
           "library_ms": device_ms(library), "library_ms_burst": device_ms_burst(library),
           "bound_ms": max(n_bytes / bw, n_ops / flops) * 1e3,
           "bound_by": "bytes" if n_bytes / bw >= n_ops / flops else "operations",
           "shape": [B, H],
           "train_forward_ms": device_ms(lambda: ops.lstm_cell_train(*fwd)),
           "serve_forward_ms": device_ms(lambda: ops.lstm_cell_op(*fwd))}
    print(f"lstm_cell_bwd fp32 B={B} H={H}: {json.dumps(row)}")
    return row


def train_card_vs_cpu(host_batch, grid) -> dict:
    """One train step at CONFIG width, ``init_scale=1``, the same weights
    and batch on the card and on the CPU: the loss at 1e-5, every gradient
    present and non-zero within 1e-4 of its tensor's largest element, the
    gradient norm and the updated params at 1e-4."""
    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.models.seq2seq import Seq2Seq
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    cfg = dataclasses.replace(CONFIG, init_scale=1.0)
    snapped = grid.snap(host_batch)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, TRAIN_STEPS), weight_decay=1e-4)
    out = {}
    for dev in ("cuda", "cpu"):
        model = Seq2Seq(cfg, dev, seed=SEED)
        params = params_of(model)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in snapped.items()}
        loss, grads = value_and_grad(functional_loss(model))(params, batch)
        new, _, gnorm = opt.update(grads, opt.init(params), params)
        out[dev] = {"loss": loss.item(), "grads": {k: g.cpu() for k, g in grads.items()},
                    "params": {k: p.cpu() for k, p in new.items()}, "gnorm": gnorm.item()}
    card, cpu = out["cuda"], out["cpu"]
    if not np.isfinite(card["loss"]) or abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        fail(f"train step loss card {card['loss']} vs CPU {cpu['loss']} (rtol 1e-5)")
    worst = 0.0
    for path, w in cpu["grads"].items():
        g = card["grads"][path]
        scale = w.abs().max().item()
        if g.abs().max().item() == 0 or scale == 0:
            fail(f"train step: the gradient of {path} is zero on the card")
        ratio = (g - w).abs().max().item() / scale
        worst = max(worst, ratio)
        if ratio > 1e-4:
            fail(f"train step: {path}'s gradient differs from the CPU's by {ratio:.3e} of its "
                 f"largest element (limit 1e-4)")
    torch.testing.assert_close(torch.tensor(card["gnorm"]), torch.tensor(cpu["gnorm"]),
                               rtol=1e-4, atol=0)
    for path, w in cpu["params"].items():
        torch.testing.assert_close(card["params"][path], w, rtol=1e-4, atol=1e-4)
    print(f"train step card vs CPU (CONFIG, init_scale 1, batch {snapped['encoder_tokens'].shape} "
          f"/ {snapped['decoder_tokens'].shape}): loss {card['loss']:.6f} vs {cpu['loss']:.6f}; "
          f"all {len(cpu['grads'])} gradients present and non-zero, worst max|dg|/max|g| "
          f"{worst:.3e} (limit 1e-4); grad_norm and updated params within 1e-4")
    return {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "grad_worst_rel": worst,
            "grad_norm_card": card["gnorm"], "grad_norm_cpu": cpu["gnorm"]}


def train(cleaned):
    """The example's training at CONFIG width on the cleaned corpus: 40
    steps of 32 through ``DeviceFeed`` on the 2-D grid with
    ``TrainController`` (checkpoint at step 20), launch counters set to 0
    just before and read just after; then a second controller resumes at
    step 20 and replays steps 21-40. Returns the ``train`` line."""
    import itertools
    import tempfile

    from repro_torch.checkpoint.tree import flatten_with_paths, map_with_paths
    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.core.device_pipeline import BucketGrid, DeviceFeed
    from repro_torch.data.batching import derive_buckets, seq2seq_arrays, shuffled_batches
    from repro_torch.data.tokenizer import PAD, WordTokenizer
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models.seq2seq import Seq2Seq
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.fault_tolerance import TrainController
    from repro_torch.runtime.train_loop import functional_loss, make_train_step, params_of

    rows = [i for i, (t, a) in enumerate(zip(cleaned["title"], cleaned["abstract"])) if t and a]
    tok = WordTokenizer.fit([cleaned["title"][i] for i in rows]
                            + [cleaned["abstract"][i] for i in rows], vocab_size=CONFIG.vocab_size)
    rows = rows[:TRAIN_ROWS]
    arrays = seq2seq_arrays([cleaned["abstract"][i] for i in rows],
                            [cleaned["title"][i] for i in rows], tok,
                            CONFIG.max_abstract_len, CONFIG.max_title_len)
    hosts = list(itertools.islice(shuffled_batches(arrays, TRAIN_BATCH, seed=SEED), TRAIN_STEPS))
    grid = BucketGrid(TRAIN_BATCH, {"encoder_tokens": derive_buckets(CONFIG.max_abstract_len),
                                    "decoder_tokens": derive_buckets(CONFIG.max_title_len)})
    line = {"card_vs_cpu": train_card_vs_cpu(hosts[0], grid)}
    torch.cuda.empty_cache()

    model = Seq2Seq(CONFIG, "cuda", seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, TRAIN_STEPS), weight_decay=1e-4)
    train_step = make_train_step(functional_loss(model), opt)

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    def controller_over(ckpt_dir, batches, saved=None):
        """A ``TrainController`` on ``ckpt_dir`` whose steps take ``batches``
        through a fresh feed, each timed by ``feed.step`` and ended by a
        synchronize; with ``saved``, the state after step 20 is cloned
        there. Returns the controller, the feed and the snapped widths."""
        feed = DeviceFeed(iter(batches), grid=grid, prefetch=2)
        widths = []

        def fed_step(params, opt_state, batch):
            with feed.step(batch):
                widths.append((batch["encoder_tokens"].shape[1],
                               batch["decoder_tokens"].shape[1]))
                params, opt_state, metrics = train_step(params, opt_state, batch)
                torch.cuda.synchronize()
            if saved is not None and len(widths) == TRAIN_SAVE_AT:
                saved.update(state=map_with_paths(lambda _, t: t.clone(), (params, opt_state)))
            return params, opt_state, metrics

        controller = TrainController(ckpt_dir, fed_step, init_state, save_every=TRAIN_SAVE_AT)
        return controller, feed, widths

    def run(controller, feed):
        """-> (history, the feed's report, seconds)."""
        t0 = time.perf_counter()
        try:
            history = controller.run(iter(feed), n_steps=TRAIN_STEPS)
        finally:
            feed.close()
        return history, feed.report(), time.perf_counter() - t0

    def want_launches(widths):
        return sum(w_enc * CONFIG.n_encoder_layers + w_dec - 1 for w_enc, w_dec in widths)

    # warm-up: the first step's kernels, cuBLAS handles and allocator
    warm = {k: torch.from_numpy(v).cuda() for k, v in grid.snap(hosts[0]).items()}
    params, state = init_state()
    train_step(params, state, warm)
    torch.cuda.synchronize()
    del warm, params, state

    with tempfile.TemporaryDirectory() as ckpt_dir:
        saved = {}
        controller, feed, widths = controller_over(ckpt_dir, hosts, saved)
        lstm_ops.LAUNCHES["lstm_cell"] = lstm_ops.LAUNCHES["lstm_cell_bwd"] = 0
        history, report, seconds = run(controller, feed)
        launches = dict(lstm_ops.LAUNCHES)
        want = want_launches(widths)
        if len(history) != TRAIN_STEPS or launches != {"lstm_cell": want, "lstm_cell_bwd": want}:
            fail(f"the train run made {len(history)} steps and launches {launches}, expected "
                 f"{TRAIN_STEPS} steps and {want} of each")
        losses = [h["loss"] for h in history]
        if not np.isfinite(losses).all():
            fail(f"a non-finite training loss: {losses}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            fail(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        # resume: as if the run had died before committing step 40
        shutil.rmtree(Path(ckpt_dir) / f"step_{TRAIN_STEPS:010d}")
        resumed, feed2, widths2 = controller_over(ckpt_dir, hosts[TRAIN_SAVE_AT:])
        if not resumed.resumed or resumed.step != TRAIN_SAVE_AT:
            fail(f"the second controller resumed at step {resumed.step}, expected "
                 f"{TRAIN_SAVE_AT}")
        restored = flatten_with_paths((resumed.params, resumed.opt_state))
        for (path, got), (_, want_t) in zip(restored, flatten_with_paths(saved["state"]),
                                            strict=True):
            if got.dtype != want_t.dtype or not torch.equal(got, want_t):
                fail(f"the restored {path} differs from the state saved at step {TRAIN_SAVE_AT}")
        lstm_ops.LAUNCHES["lstm_cell"] = lstm_ops.LAUNCHES["lstm_cell_bwd"] = 0
        history2, _, seconds2 = run(resumed, feed2)
        resume_launches = dict(lstm_ops.LAUNCHES)
    if [h["step"] for h in history2] != list(range(TRAIN_SAVE_AT + 1, TRAIN_STEPS + 1)):
        fail(f"the resumed run took steps {[h['step'] for h in history2]}")
    want2 = want_launches(widths2)
    if resume_launches != {"lstm_cell": want2, "lstm_cell_bwd": want2}:
        fail(f"the resumed run made launches {resume_launches}, expected {want2} of each")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(history2, history[TRAIN_SAVE_AT:]))
    if rel > 1e-4:
        fail(f"the resumed steps' losses differ from the uninterrupted run's by {rel:.3e} "
             f"(rtol 1e-4)")
    n_tokens = sum(int((h[k] != PAD).sum()) for h in hosts for k in h)
    line.update({
        "steps": len(history), "batch": TRAIN_BATCH, "seconds": seconds,
        "seconds_per_step": seconds / len(history), "train_tokens_per_s": n_tokens / seconds,
        "train_tokens": n_tokens, "widths": widths,
        "wall_idle_share": 1 - report.device_s / seconds,
        **{k: v for k, v in report.as_dict().items() if k != "device_idle_fraction"},
        "feed_wait_share": report.device_idle_fraction,
        "lstm_cell_launches": launches["lstm_cell"],
        "lstm_cell_bwd_launches": launches["lstm_cell_bwd"],
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "resumed_at": TRAIN_SAVE_AT, "resume_max_rel_loss_diff": rel,
        "resume_seconds": seconds2, "resume_launches": resume_launches,
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
    })
    print(f"train: {len(history)} steps of {TRAIN_BATCH} at CONFIG width in {seconds:.3f} s "
          f"({seconds / len(history) * 1e3:.1f} ms a step, {n_tokens / seconds:.0f} training "
          f"tokens/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}; feed wait "
          f"{report.device_idle_fraction:.2%} of the steps (the feed's OverlapReport; the "
          f"card's idle share is traced by examples/train_summarizer_torch.py --profile), "
          f"{line['wall_idle_share']:.2%} of the wall clock outside the steps")
    print(f"train: lstm_cell launches {launches['lstm_cell']} and lstm_cell_bwd launches "
          f"{launches['lstm_cell_bwd']} = sum of snapped (encoder width x "
          f"{CONFIG.n_encoder_layers} + decoder width - 1) over the steps")
    print(f"train: resumed at step {TRAIN_SAVE_AT} with params, moments and count equal bit "
          f"for bit to those saved; steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS} track the "
          f"uninterrupted run's losses within {rel:.3e} relative (rtol 1e-4: the run does not "
          f"set torch.use_deterministic_algorithms, so no bit equality is asked)")
    return line


# (b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len); kv_len None = skv
FLASH_SERVED = (
    # block prefill of a 4-16 token prompt into a 128-long cache
    [(1, sq, LM_MAX_SEQ, 32, 32, 80, True, 0, 0, sq) for sq in (4, 9, 16)]
    # one-token decode at position pos over pos + 1 cached keys
    + [(1, 1, LM_MAX_SEQ, 32, 32, 80, True, 0, pos, pos + 1) for pos in (0, 4, 15, 31, 77, 126)]
    # RecurrentGemma-9B's local attention: 16 query heads of 256 over one kv
    # head, window 2048, into its ring of min(128, 2048) slots, which holds
    # position i in slot i until it wraps
    + [(1, sq, LM_MAX_SEQ, 16, 1, 256, True, 2048, 0, sq) for sq in (4, 9, 15)]
    + [(1, 1, LM_MAX_SEQ, 16, 1, 256, True, 2048, pos, pos + 1) for pos in (0, 4, 15, 26, 126)]
    # a wrapped ring: every slot holds one of the last 128 positions, all visible
    + [(1, 1, LM_MAX_SEQ, 16, 1, 256, False, 0, 0, LM_MAX_SEQ)]
)
FLASH_EDGES = [
    # the JAX suite's FLASH_CASES (tests/test_kernels.py:47-54)
    (2, 128, 128, 4, 4, 64, True, 0, 0, None),
    (1, 256, 256, 8, 2, 32, True, 0, 0, None),
    (2, 128, 128, 4, 1, 64, True, 64, 0, None),  # MQA + sliding window
    (1, 96, 96, 4, 4, 64, False, 0, 0, None),  # non-causal, ragged
    (1, 200, 200, 2, 2, 128, True, 0, 0, None),  # padded sequence
    # narrow windows: early key tiles fully masked for late rows
    (1, 256, 256, 2, 1, 32, True, 16, 0, None),
    (2, 100, 100, 4, 2, 8, False, 8, 0, None),
    (2, 12, 12, 8, 2, 8, True, 0, 0, None),  # the SMOKE configs' head_dim
    # kv_len > 1024: decode and a block prefill deep into a long cache
    (1, 1, 2048, 32, 32, 80, True, 0, 1500, 1501),
    (1, 64, 2048, 8, 2, 128, True, 0, 1200, 1264),
    (1, 3, 600, 4, 2, 64, True, 100, 450, 453),  # a windowed block deep in a cache
]
# Shapes at which flash_attention/ops.py:plan splits each tile's keys over a
# cluster (b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len)
FLASH_SPLITS = [
    # long caches, 8 blocks a tile: decode at both head widths,
    # RecurrentGemma-9B's 16 heads x a 15-row prefill deep in its window,
    # and a 100-row prefill at hd 80 over 8 heads
    (1, 1, 2048, 32, 32, 80, True, 0, 1900, 1901),
    (1, 1, 2048, 16, 1, 256, True, 2048, 1800, 1801),
    (1, 15, 2048, 16, 1, 256, True, 2048, 1700, 1715),
    (1, 100, 1024, 8, 8, 80, True, 0, 600, 700),
    # causal MQA and GQA prefills from position 0 past 64 keys, 3 blocks a
    # tile: tile 0's 4 keys cut into [0, 2), [2, 4), [4, 4), an empty range
    # and one wholly masked for the rows at positions 0 and 1
    (1, 130, 256, 4, 1, 64, True, 0, 0, 130),
    (1, 130, 256, 8, 2, 80, True, 0, 0, 130),
    # a window over such a prefill, and a narrow non-causal window whose
    # early blocks lie wholly before the window of a tile's later rows
    (1, 130, 256, 4, 1, 64, True, 72, 0, 130),
    (2, 130, 256, 4, 2, 80, False, 3, 0, 130),
    # a wrapped ring (no mask), and a ragged head (the plain-load path,
    # zero-padded to 32 in shared memory) with a partial last tile
    (1, 1, 2048, 16, 1, 256, False, 0, 0, 2048),
    (1, 7, 512, 6, 2, 30, True, 0, 400, 407),
]
# timed shapes: StableLM-3B's heads (hd 80), then RecurrentGemma-9B's (MQA, hd 256)
FLASH_TIMED = {
    "decode": (1, 1, LM_MAX_SEQ, 32, 32, 80, True, 0, 15, 16),
    "prefill": (1, 10, LM_MAX_SEQ, 32, 32, 80, True, 0, 0, 10),
    "decode_hd256": (1, 1, LM_MAX_SEQ, 16, 1, 256, True, 2048, 15, 16),
    "prefill_hd256": (1, 10, LM_MAX_SEQ, 16, 1, 256, True, 2048, 0, 10),
}


def flash_inputs(case, dtype, gen, strided=False):
    """q, k, v on the card; with ``strided`` k and v are views of a
    (b, nkv, skv, hd) buffer, so their strides are not the contiguous ones."""
    b, sq, skv, nq, nkv, hd = case[:6]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    q = rnd(b, sq, nq, hd)
    if strided:
        return q, rnd(b, nkv, skv, hd).transpose(1, 2), rnd(b, nkv, skv, hd).transpose(1, 2)
    return q, rnd(b, skv, nkv, hd), rnd(b, skv, nkv, hd)


def flash_kwargs(case) -> dict:
    causal, window, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)


def check_flash_attention(gen) -> float:
    """Kernel vs plain version at every listed shape, each launched twice
    and the two results held equal bit for bit; the split shapes must be
    planned over a cluster. Returns the fp32 max abs error at the serving
    shapes."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op, plan
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    err = 0.0
    cases = [(c, False) for c in FLASH_SERVED + FLASH_EDGES + FLASH_SPLITS] + \
        [(FLASH_SERVED[-1], True), (FLASH_EDGES[1], True), (FLASH_SPLITS[1], True)]
    for case in FLASH_SPLITS:
        b, sq, skv, nq, nkv = case[:5]
        launch = plan(b, sq, nq, nkv, causal=case[6], window=case[7], q_offset=case[8],
                      n_keys=case[9])
        if launch.split < 2:
            fail(f"flash_attention {case}: the plan does not split its keys over a cluster")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case, strided in cases:
            q, k, v = flash_inputs(case, dtype, gen, strided)
            got = flash_attention_op(q, k, v, **flash_kwargs(case))
            again = flash_attention_op(q, k, v, **flash_kwargs(case))
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **flash_kwargs(case))
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if not torch.equal(got, again):
                fail(f"flash_attention {dtype} {case} strided {strided}: two launches differ")
            if dtype == torch.float32 and case in FLASH_SERVED:
                err = max(err, (got - want).abs().max().item())
        print(f"flash_attention {dtype}: matches plain at {len(cases)} shapes (tol {tol}), "
              f"{len(FLASH_SPLITS) + 1} of them at a cluster split; two launches identical "
              f"bit for bit")
    return err


def flash_work(case) -> tuple[int, int]:
    """(bytes, operations) the call needs in fp32: q read, the keys and
    values the masks leave visible to some row read once, out written;
    4 * hd operations per visible (query, key) pair (q.k and p.v)."""
    b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
    n_keys = min(skv, kv_len or skv)
    q_pos = torch.arange(sq)[:, None] + q_offset
    k_pos = torch.arange(n_keys)[None, :]
    mask = torch.ones(sq, n_keys, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    read_keys = int(mask.any(0).sum())
    n_bytes = 4 * (2 * b * sq * nq * hd + 2 * b * read_keys * nkv * hd)
    return n_bytes, 4 * hd * b * nq * int(mask.sum())


def time_flash_attention(gen, bw: float, flops: float) -> dict:
    """Times at decode and prefill shapes of the serving paths, fp32; the
    library yardstick is ``scaled_dot_product_attention`` over the whole
    cache with an explicit boolean mask and the kv heads expanded to the
    query heads (the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rows = {}
    for label, case in FLASH_TIMED.items():
        q, k, v = flash_inputs(case, torch.float32, gen)
        kw = flash_kwargs(case)
        sq, skv, nq, window, q_offset, kv_len = (case[i] for i in (1, 2, 3, 7, 8, 9))
        q_pos = torch.arange(sq, device="cuda")[:, None] + q_offset
        k_pos = torch.arange(skv, device="cuda")[None, :]
        mask = (k_pos <= q_pos) & (k_pos < kv_len)
        if window:
            mask &= k_pos > q_pos - window
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).expand(-1, nq, -1, -1) for t in (k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        torch.testing.assert_close(library().transpose(1, 2), flash_attention_ref(q, k, v, **kw),
                                   rtol=1e-4, atol=1e-4)
        n_bytes, n_ops = flash_work(case)
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / flops * 1e3
        rows[label] = {
            "ms": device_ms(lambda: flash_attention_op(q, k, v, **kw)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
            "library_ms": device_ms(library),
            "ms_burst": device_ms_burst(lambda: flash_attention_op(q, k, v, **kw)),
            "library_ms_burst": device_ms_burst(library),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": list(case),
        }
        print(f"flash_attention fp32 {label}: {json.dumps(rows[label])}")
    return rows


def rg_inputs(b, s, d, gen):
    """Decays a in (0, 0.98), inputs b of 0.1 and a state h0, on the card."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    return 0.98 * torch.sigmoid(rnd(b, s, d)), 0.1 * rnd(b, s, d), rnd(b, d)


# (b, s, d): RecurrentGemma-9B's d_rnn at batch 1, a decode step and prompts
RG_SERVED = [(1, s, 4096) for s in (1, 4, 9, 15)]
RG_EDGES = [(3, 7, 33), (2, 1000, 300), (4, 1, 4096)]  # ragged d, a long sequence, batch
# d % 4 != 0 on the scalar path, a row's tail, steps past the kernel's
# 8-step register chunk and a seq of exactly two chunks
RG_MORE = [(2, 17, 4098), (1, 16, 4096), (2, 9, 7), (1, 3, 1)]


def check_rg_lru(gen) -> float:
    """Kernel vs plain version, with and without h0: fp32 in at 1e-5; bf16
    in (read and written in bf16 by the kernel) with h_last, fp32, at 1e-5
    and h, bf16, within one bf16 rounding of the plain version's fp32 h
    (1e-2 relative); inputs one element past a 16-byte boundary. Returns
    the max abs error at the serving shapes."""
    from repro_torch.kernels.rg_lru.ops import rg_lru_op
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref

    err = 0.0
    cases = RG_SERVED + RG_EDGES + RG_MORE
    for case in cases:
        a, b, h0 = rg_inputs(*case, gen)
        for init in (None, h0):
            got = rg_lru_op(a, b, init)
            torch.cuda.synchronize()
            want = rg_lru_ref(a, b, init)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
                if case in RG_SERVED:
                    err = max(err, (g - w).abs().max().item())
            a16, b16 = a.bfloat16(), b.bfloat16()
            h16, last16 = rg_lru_op(a16, b16, init)
            torch.cuda.synchronize()
            want, want_last = rg_lru_ref(a16, b16, init)
            if h16.dtype != torch.bfloat16 or last16.dtype != torch.float32:
                fail(f"rg_lru bf16 {case}: outputs are {h16.dtype} and {last16.dtype}")
            torch.testing.assert_close(last16, want_last, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(h16.float(), want, rtol=1e-2, atol=1e-5)
    a, b, h0 = rg_inputs(2, 9, 4096, gen)
    shifted = [torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape).copy_(t)
               for t in (a, b, h0)]
    for g, w in zip(rg_lru_op(*shifted), rg_lru_ref(*shifted)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # other dtypes, and a and b of two dtypes, go through the fp32 kernel
    # (cast around it, as the JAX op casts); h comes back in a's dtype
    others = ((torch.float16, torch.float16, 1e-3), (torch.float32, torch.bfloat16, 1e-5),
              (torch.float64, torch.float64, 1e-5))
    for da, db, tol in others:
        h, last = rg_lru_op(a.to(da), b.to(db), h0)
        want, want_last = rg_lru_ref(a.to(da), b.to(db), h0)
        if h.dtype != da or last.dtype != torch.float32:
            fail(f"rg_lru {da}/{db}: outputs are {h.dtype} and {last.dtype}")
        torch.testing.assert_close(last, want_last, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h.float(), want, rtol=tol, atol=1e-5)
    print(f"rg_lru: matches plain at {len(cases)} shapes with and without h0, fp32 (tol "
          f"1e-5) and bf16 (h_last 1e-5, h within one bf16 rounding), on unaligned inputs, "
          f"and in fp16, fp64 and fp32 with bf16 b through the fp32 kernel")
    return err


def time_rg_lru(gen, bw: float, flops: float) -> dict:
    """Times of a decode step and a 10-token prefill at RecurrentGemma-9B's
    d_rnn, from a state. The library yardstick, for the decode step only,
    is ``torch.addcmul(b, a, h0)``: one PyTorch call that computes the same
    step; a prefill has none."""
    from repro_torch.kernels.rg_lru.ops import rg_lru_op
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref

    rows = {}
    for label, (b_, s, d) in (("decode", (1, 1, 4096)), ("prefill", (1, 10, 4096))):
        a, b, h0 = rg_inputs(b_, s, d, gen)
        library = library_burst = None
        if s == 1:
            a0, b0 = a[:, 0], b[:, 0]
            torch.testing.assert_close(torch.addcmul(b0, a0, h0), rg_lru_ref(a, b, h0)[1],
                                       rtol=1e-5, atol=1e-5)
            library = device_ms(lambda: torch.addcmul(b0, a0, h0))
            library_burst = device_ms_burst(lambda: torch.addcmul(b0, a0, h0))
        # a and b read, h0 read, every h written and the last one again
        bytes_ms = 4 * (3 * b_ * s * d + 2 * b_ * d) / bw * 1e3
        ops_ms = 2 * b_ * s * d / flops * 1e3
        rows[label] = {
            "ms": device_ms(lambda: rg_lru_op(a, b, h0)),
            "plain_ms": device_ms(lambda: rg_lru_ref(a, b, h0)),
            "library_ms": library,
            "ms_burst": device_ms_burst(lambda: rg_lru_op(a, b, h0)),
            "library_ms_burst": library_burst,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": [b_, s, d],
        }
        print(f"rg_lru fp32 {label}: {json.dumps(rows[label])}")
    return rows


def mlstm_inputs(b, s, H, dh, gen):
    """q, k, v of 0.5, input gates of 1, forget gates around 2 (the JAX
    suite's draws), on the card."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).cuda()

    return (rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5),
            rnd(b, s, H), rnd(b, s, H, shift=2.0))


def mlstm_state(b, H, dh, gen):
    """A state carried in: the plain version's after a 20-step prefix."""
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

    zero = (torch.zeros(b, H, dh, dh, device="cuda"), torch.zeros(b, H, dh, device="cuda"),
            torch.full((b, H), -1e30, device="cuda"))
    return mlstm_chunk_ref(*mlstm_inputs(b, 20, H, dh, gen), *zero)[1:]


# (b, s, H, dh): xLSTM-1.3B's 4 heads of 512 at batch 1, a decode step,
# prompts, a full chunk and several chunks; then narrow heads
MLSTM_SERVED = [(1, s, 4, 512) for s in (1, 7, 15, 64, 200)]
MLSTM_EDGES = [(2, 65, 2, 16), (1, 130, 4, 64), (3, 1, 2, 64), (2, 15, 4, 16)]


# The decode path (L = 1) and the prefill's chunk edges, at head widths
# from 64 to the kernel's limit, for 1, 4 and 8 (batch, head) pairs.
MLSTM_EDGE_L, MLSTM_EDGE_DH, MLSTM_EDGE_BH = (1, 2, 10, 63, 64, 65, 130), (64, 128, 512, 1024), \
    {1: (1, 1), 4: (1, 4), 8: (2, 4)}


# The grid runs over this many draws from the one generator.
MLSTM_DRAWS = 3
PINS = ROOT / "chip_smoke_pins"  # CPU generator states, each just before a pinned draw
# Pinned draws: (b, s, H, dh), the q sum that the restored generator must
# give, and what the draw is. Each state was recorded by replaying, on the
# CPU generator, every draw that came before the case in the run that met it.
MLSTM_PINNED = {
    "mlstm_grid_l65_dh512_bh8": (
        (2, 65, 4, 512), 64.95704051039377,
        "the grid's second draw, where an earlier chunked pass missed C's tolerance against "
        "fp64 (kernel 1.97e-6 from fp64, plain 1.64e-6)"),
    "mlstm_served_l200_dh512_bh4": (
        (1, 200, 4, 512), 244.28161654489077,
        "a 200-step draw of the serving shapes, where the kernel's h differed from the plain "
        "version's by 2.28e-5 relative, over the first loop's 2e-5"),
}


def pinned_mlstm_inputs(name: str):
    """The pinned draw's inputs and carried state, from its recorded
    generator state; fails if the restored generator does not give the
    recorded draw."""
    (b, s, H, dh), q_sum, _ = MLSTM_PINNED[name]
    gen = torch.Generator()
    gen.set_state(torch.frombuffer(bytearray((PINS / f"{name}.state").read_bytes()),
                                   dtype=torch.uint8))
    args = mlstm_inputs(b, s, H, dh, gen)
    got = args[0].double().sum().item()
    if abs(got - q_sum) > 1e-9 * abs(q_sum):
        fail(f"the pinned mlstm_chunk draw {name} changed: q sums to {got!r}, not {q_sum!r}")
    return args, mlstm_state(b, H, dh, gen)


def check_mlstm_chunk(gen) -> tuple[float, float]:
    """Kernel vs plain version from a carried state, output and returned
    state (C, n, m) at fp32 2e-5; returns the max abs error of the output
    and the max relative error of the state (C grows to hundreds) at the
    serving shapes. Then ``MLSTM_DRAWS`` draws of the grid of lengths, head
    widths and (batch, head) counts, and the pinned draws (``MLSTM_PINNED``,
    each also against fp64 in a printed line), at the CPU tests'
    tolerances (output 2e-5, state 1e-4 relative and 1e-6 absolute), a
    decode step also against ``mlstm_step_ref``, and two launches from the
    same state bit for bit."""
    import itertools

    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk_op
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref, mlstm_step_ref

    err = state_err = 0.0
    for case in MLSTM_SERVED + MLSTM_EDGES:
        b, s, H, dh = case
        args = mlstm_inputs(b, s, H, dh, gen)
        c, n, m = mlstm_state(b, H, dh, gen)
        want = mlstm_chunk_ref(*args, c, n, m)
        c_card = c.clone()
        got = mlstm_chunk_op(*args, c_card, n, m)
        torch.cuda.synchronize()
        if got[1] is not c_card:
            fail("mlstm_chunk_op did not update C in place")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        if case in MLSTM_SERVED:
            err = max(err, (got[0] - want[0]).abs().max().item())
            for g, w in zip(got[1:], want[1:]):
                state_err = max(state_err, ((g - w).abs() / w.abs().clamp(min=1.0)).max().item())
    print(f"mlstm_chunk fp32: output and state match plain at "
          f"{len(MLSTM_SERVED + MLSTM_EDGES)} shapes from a carried state (tol 2e-5); at the "
          f"serving shapes output max abs err {err:.3e}, state max rel err {state_err:.3e}")

    def held(s, dh, bh, args, state, label):
        """Returns the comparisons made and those decided through fp64."""
        c, n, m = state
        wants = [mlstm_chunk_ref(*args, c, n, m)]
        if s == 1:
            wants.append(mlstm_step_ref(*args, c, n, m))
        exact = mlstm_chunk_ref(*args, c, n, m, dtype=torch.float64)
        runs = [mlstm_chunk_op(*args, c.clone(), n, m) for _ in range(2)]
        torch.cuda.synchronize()
        decided = []
        for want in wants:
            for name, g, w, x, tol in zip("hCnm", runs[0], want, exact,
                                          ((2e-5, 2e-5),) + ((1e-4, 1e-6),) * 3):
                ratio = held_to_plain(g, w, x, *tol,
                                      f"mlstm_chunk {label}L={s} dh={dh} b*H={bh} {name}")
                if ratio is not None:
                    decided.append((label + str(s), dh, bh, name, *ratio))
        if not all(torch.equal(g, a) for g, a in zip(*runs)):
            fail(f"mlstm_chunk {label}L={s} dh={dh} b*H={bh}: two launches differ")
        return 4 * len(wants), decided

    grid = list(itertools.product(MLSTM_EDGE_L, MLSTM_EDGE_DH, MLSTM_EDGE_BH))
    by_fp64, n_held = [], 0
    for draw in range(MLSTM_DRAWS):
        for s, dh, bh in grid:
            b, H = MLSTM_EDGE_BH[bh]
            args = mlstm_inputs(b, s, H, dh, gen)
            made, decided = held(s, dh, bh, args, mlstm_state(b, H, dh, gen), f"draw {draw} ")
            n_held += made
            by_fp64 += decided
    for name, ((b, s, H, dh), _, what) in MLSTM_PINNED.items():
        args, state = pinned_mlstm_inputs(name)
        made, decided = held(s, dh, b * H, args, state, f"pinned {name} ")
        n_held += made
        by_fp64 += decided
        exact = mlstm_chunk_ref(*args, *state, dtype=torch.float64)
        kernel = mlstm_chunk_op(*args, state[0].clone(), *state[1:])
        plain = mlstm_chunk_ref(*args, *state)
        errs = {label: [(g.double() - x).abs().max().item() for g, x in zip(got, ref)]
                for label, got, ref in (("kernel", kernel, exact), ("plain", plain, exact),
                                        ("kernel_vs_plain", kernel, plain))}
        print(f"mlstm_chunk pinned {name} ({what}): max abs err of h, C, n, m: "
              f"{json.dumps(errs)}")
    print(f"mlstm_chunk fp32: output (tol 2e-5) and state (rtol 1e-4, atol 1e-6) match plain "
          f"at {MLSTM_DRAWS} draws of {len(grid)} shapes (L {MLSTM_EDGE_L}, dh {MLSTM_EDGE_DH}, "
          f"b*H {tuple(MLSTM_EDGE_BH)}) and {len(MLSTM_PINNED)} pinned draws from a "
          f"carried state, decode steps also against mlstm_step_ref; two launches identical "
          f"bit for bit")
    print(f"mlstm_chunk: {len(by_fp64)} of {n_held} tensor comparisons decided through fp64 "
          f"(draw and L, dh, b*H, tensor, kernel err / plain err against fp64, plain version "
          f"itself beyond the tolerance): {by_fp64}")
    return err, state_err


def held_to_plain(got, plain, exact, rtol: float, atol: float, what: str):
    """``got`` (a kernel's fp32 result) against ``plain`` (the fp32 plain
    version's) at rtol/atol. Where an element misses that, both are held
    against ``exact``, the plain version's algebra in fp64, at the same
    rtol/atol: the kernel must meet it there, or, only where the fp32 plain
    version itself misses it, miss by no more than the plain version does.
    Returns None, or (the kernel's max abs error against fp64 over the
    plain version's, whether the plain version missed) when fp64 decided."""
    if torch.allclose(got, plain, rtol=rtol, atol=atol):
        return None
    limit = atol + rtol * exact.abs()
    over_kernel = ((got.double() - exact).abs() - limit).max().item()
    over_plain = ((plain.double() - exact).abs() - limit).max().item()
    if over_kernel > max(over_plain, 0.0):
        fail(f"{what}: differs from the plain version beyond rtol {rtol}, atol {atol} (max abs "
             f"{(got - plain).abs().max().item():.3e}), and misses them against fp64 by "
             f"{over_kernel:.3e}, where the plain version misses by {max(over_plain, 0.0):.3e}")
    e_kernel = (got.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    return e_kernel / e_plain, over_plain > 0


def mlstm_work(b, s, H, dh) -> tuple[int, int]:
    """(bytes, operations) in fp32: q, k, v and the gates read, C, n and m
    read and written, h written; per chunk of L steps and head, 2·L·dh² for
    q·C, 2·L·dh² + dh² for C's update, 2·L(L+1)·dh for the scores and W·v,
    4·L·dh for q·n and n's update."""
    n_bytes = 4 * b * H * (4 * s * dh + 2 * s + 2 * dh * dh + 2 * dh + 2)
    n_ops = 0
    for c0 in range(0, s, 64):
        L = min(64, s - c0)
        n_ops += b * H * (4 * L * dh * dh + dh * dh + 2 * L * (L + 1) * dh + 4 * L * dh)
    return n_bytes, n_ops


def time_mlstm_chunk(gen, bw: float, flops: float) -> dict:
    """Times of a decode step and a 10-token prefill at xLSTM-1.3B's heads
    from a carried state. No single PyTorch call computes the chunkwise
    mLSTM, so there is no library yardstick."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk_op
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

    rows = {}
    for label, case in (("decode", (1, 1, 4, 512)), ("prefill", (1, 10, 4, 512))):
        args = mlstm_inputs(*case, gen)
        c, n, m = mlstm_state(case[0], case[2], case[3], gen)
        n_bytes, n_ops = mlstm_work(*case)
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / flops * 1e3
        rows[label] = {
            "ms": device_ms(lambda: mlstm_chunk_op(*args, c, n, m)),  # C evolves in place
            "plain_ms": device_ms(lambda: mlstm_chunk_ref(*args, c, n, m)),
            "library_ms": None,
            "ms_burst": device_ms_burst(lambda: mlstm_chunk_op(*args, c, n, m)),
            "library_ms_burst": None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": list(case),
        }
        print(f"mlstm_chunk fp32 {label}: {json.dumps(rows[label])}")
    return rows


def serve(abstracts, titles):
    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.core.clean import clean_abstracts, clean_titles
    from repro_torch.data.tokenizer import START, WordTokenizer
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.text_clean import ops as scan_ops
    from repro_torch.launch.serve import encode_abstracts, serve_abstracts
    from repro_torch.models.seq2seq import Seq2Seq

    t0 = time.perf_counter()
    clean_a, clean_t = clean_abstracts(abstracts, "cuda"), clean_titles(titles, "cuda")
    clean_s = time.perf_counter() - t0
    if clean_a != clean_abstracts(abstracts, "cpu") or clean_t != clean_titles(titles, "cpu"):
        fail("cleaning on the card differs from cleaning on the CPU")
    tok = WordTokenizer.fit(clean_a + clean_t, vocab_size=CONFIG.vocab_size)
    model = Seq2Seq(CONFIG, "cuda", seed=SEED)
    requests = abstracts[:N_REQUESTS]
    serve_abstracts(model, tok, requests[:BATCH], batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()

    lstm_ops.LAUNCHES["lstm_cell"] = 0
    scan_ops.LAUNCHES["text_scan"] = 0
    t0 = time.perf_counter()
    out = serve_abstracts(model, tok, requests, batch_size=BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"lstm_cell": lstm_ops.LAUNCHES["lstm_cell"],
                "text_scan": scan_ops.LAUNCHES["text_scan"]}
    n_batches = -(-N_REQUESTS // BATCH)
    want = n_batches * (CONFIG.n_encoder_layers * CONFIG.max_abstract_len + CONFIG.max_title_len)
    if launches["lstm_cell"] != want:
        fail(f"serving made {launches['lstm_cell']} lstm_cell launches, expected {want}")
    if launches["text_scan"] < n_batches:
        fail(f"serving made {launches['text_scan']} text_scan launches, expected >= {n_batches}")
    if len(out) != N_REQUESTS or not all(isinstance(t, str) for t in out):
        fail("serve_abstracts did not return one title per request")
    known = set(tok.itos) | {"<unk>"}
    if any(w not in known for t in out for w in t.split()):
        fail("a served title holds a word outside the vocabulary")
    print(f"served {len(out)} requests in {seconds:.3f} s (cleaning of {len(abstracts)} "
          f"abstracts and titles on the card took {clean_s:.3f} s); launches {launches}")
    for a, t in list(zip(requests, out))[:2]:
        print(f"  {a[:50]!r}... -> {t[:80]!r}")

    # One batch again on the CPU with the plain versions, same weights.
    cpu = Seq2Seq(CONFIG, "cpu", seed=SEED)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = requests[:BATCH]
    enc = encode_abstracts(cpu, tok, batch)
    if not torch.equal(encode_abstracts(model, tok, batch).cpu(), enc):
        fail("encoder tokens differ between card and CPU")
    gen_card = model.generate(enc.cuda()).cpu()
    gen_cpu = cpu.generate(enc)
    agreement = (gen_card == gen_cpu).float().mean().item()
    if gen_card.min() < 0 or gen_card.max() >= CONFIG.vocab_size:
        fail("generated token outside the vocabulary")
    dec = torch.cat([torch.full((BATCH, 1), START, dtype=torch.int32), gen_cpu[:, :-1]], 1)
    with torch.no_grad():
        logits_card = model({"encoder_tokens": enc.cuda(), "decoder_tokens": dec.cuda()}).cpu()
        logits_cpu = cpu({"encoder_tokens": enc, "decoder_tokens": dec})
    if not torch.isfinite(logits_card).all():
        fail("non-finite logits on the card")
    torch.testing.assert_close(logits_card, logits_cpu, rtol=1e-4, atol=1e-4)
    logit_err = (logits_card - logits_cpu).abs().max().item()
    print(f"card vs CPU on one batch: logits max abs err {logit_err:.3e} (tol 1e-4), "
          f"generated-token agreement {agreement:.4%}")
    if agreement < 0.99:
        fail(f"generated-token agreement {agreement:.4%} is under 99%")
    tokens = N_REQUESTS * CONFIG.max_title_len
    return launches, {"requests": len(out), "tokens": tokens, "seconds": seconds,
                      "tokens_per_s": tokens / seconds, "logits_max_abs_err": logit_err,
                      "token_agreement": agreement}


def token_agreement(a: dict[int, list[int]], b: dict[int, list[int]]) -> float:
    """Share of positions, over the longer of each pair, where two runs
    generated the same token."""
    same = sum(sum(x == y for x, y in zip(a[u], b[u])) for u in a)
    return same / sum(max(len(a[u]), len(b[u])) for u in a)


def lm_launch_counters() -> dict[str, dict]:
    """The LM kernels' launch counters, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops

    return {"flash_attention": flash_ops.LAUNCHES, "rg_lru": rg_ops.LAUNCHES,
            "mlstm_chunk": mlstm_ops.LAUNCHES}


def exact_param_count(cfg) -> int:
    """The size of the JAX ``LM.init`` tree without the norms, which the CPU
    tests hold the port's ``LM.param_count()`` to. The analytic
    ``ArchConfig.param_count()`` leaves out each RG-LRU layer's gate biases
    b_r and b_i (2·d_rnn) and counts an mLSTM layer's gate projection as
    2·d_rnn instead of d_rnn·2H + 2H."""
    from repro_torch.models.lm import layer_kinds

    dr, H = cfg.resolved_d_rnn, cfg.n_heads
    gap = {"rglru": 2 * dr, "mlstm": dr * 2 * H + 2 * H - 2 * dr}
    return cfg.param_count() + sum(gap.get(kind, 0) for kind in layer_kinds(cfg))


def serve_lm(cfg):
    """Serve ``LM_REQUESTS`` requests at ``cfg``'s width with random weights
    from ``SEED`` built on the card; returns the LM kernels' launches and
    the ``serve_lm`` line."""
    from repro_torch.launch.serve import lm_requests
    from repro_torch.models.lm import LM
    from repro_torch.runtime.serve_loop import serve_requests

    t0 = time.perf_counter()
    model = LM(cfg, "cuda", seed=SEED)
    torch.cuda.synchronize()
    n_params = model.param_count()
    if n_params != exact_param_count(cfg):
        fail(f"{cfg.name} has {n_params} parameters, expected {exact_param_count(cfg)}")
    print(f"{cfg.name}: {n_params} parameters ({torch.cuda.memory_allocated() / 1e9:.1f} GB "
          f"on the card) built in {time.perf_counter() - t0:.1f} s")
    requests = lm_requests(cfg, LM_REQUESTS, max_new=LM_MAX_NEW, seed=SEED)
    kw = dict(slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    serve_requests(model, requests[:1], **kw)  # warm-up
    torch.cuda.synchronize()

    counters = lm_launch_counters()
    for name, counter in counters.items():
        counter[name] = 0
    t0 = time.perf_counter()
    out = serve_requests(model, requests, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: counter[name] for name, counter in counters.items()}
    n_tokens = sum(len(t) for t in out.values())
    if sorted(out) != [r.uid for r in requests]:
        fail("serve_requests did not answer every request")
    if any(not 1 <= len(t) <= LM_MAX_NEW for t in out.values()):
        fail("a request got no token or more than max_new")
    if any(not 0 <= x < cfg.vocab_size for t in out.values() for x in t):
        fail("a served token lies outside the vocabulary")
    per_pass = {name: 0 for name in counters}
    for kind in model.kinds:
        if kind in KERNEL_OF_KIND:
            per_pass[KERNEL_OF_KIND[kind]] += 1
    for name, n in per_pass.items():
        if launches[name] != n * n_tokens:
            fail(f"serving {cfg.name} made {launches[name]} {name} launches, expected "
                 f"{n} x {n_tokens} = {n * n_tokens}")
    print(f"served {len(out)} {cfg.name} requests / {n_tokens} tokens in {seconds:.3f} s "
          f"({len(out) / seconds:.2f} requests/s, {n_tokens / seconds:.1f} tokens/s); launches "
          + ", ".join(f"{name} {launches[name]} = {n} x {n_tokens}"
                      for name, n in per_pass.items() if n))
    for uid in sorted(out)[:2]:
        print(f"  req {uid}: {requests[uid].prompt.tolist()} -> {out[uid]}")
    line = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers, "requests": len(out),
            "tokens": n_tokens, "slots": LM_SLOTS, "max_new": LM_MAX_NEW, "max_seq": LM_MAX_SEQ,
            "seconds": seconds, "requests_per_s": len(out) / seconds,
            "tokens_per_s": n_tokens / seconds,
            "launches": {name: launches[name] for name, n in per_pass.items() if n}}
    return launches, line


def lm_card_vs_cpu(cfg, n_layers: int) -> dict:
    """A model of ``cfg``'s width cut to ``n_layers`` at ``init_scale=1`` on the card
    and on the CPU with the same weights. At the reference scale (0.02) the
    layers add ~1e-4 to a residual of ~50 and move the logits by ~1e-7, so
    no comparison of logits could see them; at 1 they add O(1). Checked:
    what the layers add to the residual (``hidden`` less the embedding),
    card vs CPU within 1e-4, after checking that it is far larger than
    that; ``forward`` logits of two prompts card vs CPU within 1e-4; on the
    card, a block prefill and single ``decode_step`` calls against
    ``forward`` within 1e-4 (a wrong cache position or kv_len fails); and
    tokens of 4 served requests agreeing at >= 99% of positions."""
    from repro_torch.launch.serve import lm_requests
    from repro_torch.models.blocks import embed_tokens
    from repro_torch.models.lm import LM
    from repro_torch.runtime.serve_loop import serve_requests

    small = dataclasses.replace(cfg, n_layers=n_layers, init_scale=1.0)
    card = LM(small, "cuda", seed=SEED)
    cpu = LM(small, "meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(4, cfg.vocab_size, size=(2, 16)).astype(np.int32))

    def layers_add(model, t):
        with torch.no_grad():
            return (model.hidden(t) - embed_tokens(model.embed, t, small)).cpu()

    delta_card, delta_cpu = layers_add(card, tokens.cuda()), layers_add(cpu, tokens)
    delta_size = delta_cpu.abs().mean().item()
    if delta_size < 100 * 1e-4:
        fail(f"the layers add only {delta_size:.3e} to the residual: 1e-4 cannot see them")
    torch.testing.assert_close(delta_card, delta_cpu, rtol=1e-4, atol=1e-4)
    delta_err = (delta_card - delta_cpu).abs().max().item()
    logits_card = card({"tokens": tokens.cuda()}).cpu()
    if not torch.isfinite(logits_card).all():
        fail("non-finite LM logits on the card")
    logits_cpu = cpu({"tokens": tokens})
    torch.testing.assert_close(logits_card, logits_cpu, rtol=1e-4, atol=1e-4)
    logit_err = (logits_card - logits_cpu).abs().max().item()

    state = card.init_decode_state(2, LM_MAX_SEQ)
    decode_err = 0.0
    for start, end in [(0, 5)] + [(i, i + 1) for i in range(5, 16)]:
        step, state = card.decode_step(tokens[:, start:end].cuda(), state, start)
        want = logits_card[:, end - 1 : end]
        torch.testing.assert_close(step.cpu(), want, rtol=1e-4, atol=1e-4)
        decode_err = max(decode_err, (step.cpu() - want).abs().max().item())

    requests = lm_requests(small, 4, max_new=LM_MAX_NEW, seed=SEED + 1)
    kw = dict(slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    agreement = token_agreement(serve_requests(card, requests, **kw),
                                serve_requests(cpu, requests, **kw))
    print(f"{small.name} with {n_layers} layers at init_scale 1, card vs CPU: what the layers add "
          f"(mean abs {delta_size:.3e}) max abs err {delta_err:.3e}, forward logits max abs "
          f"err {logit_err:.3e} (tol 1e-4); card decode_step vs forward max abs err "
          f"{decode_err:.3e} (tol 1e-4); served-token agreement {agreement:.4%}")
    if agreement < 0.99:
        fail(f"served-token agreement {agreement:.4%} is under 99%")
    return {"card_vs_cpu_layers": n_layers, "layers_add_mean_abs": delta_size, "layers_add_max_abs_err": delta_err,
            "logits_max_abs_err": logit_err,
            "decode_vs_forward_max_abs_err": decode_err, "token_agreement": agreement}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    from repro_torch import device
    from repro_torch.data.synthetic import abstracts_and_titles
    from repro_torch.kernels import _build

    # 1. the card
    card = device.card()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {cap}, {torch.cuda.device_count()} device(s)")
    if not device.is_sm90():
        fail(f"capability {cap}: the kernels are built for sm_90a")
    bw, flops = peaks(name)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    built = "reused a cached build" if _build.build_seconds is None else \
        f"nvcc took {_build.build_seconds:.1f} s"
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s ({built}) "
          f"-> {_build.LIBRARY.relative_to(ROOT)}")
    for src, report in _build.build_report.items():
        print(f"  {src}: nvcc {report['seconds']:.1f} s")
        for kernel, resources in report["kernels"].items():
            print(f"    {kernel}: {resources}")

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    abstracts, titles = abstracts_and_titles(N_CORPUS, seed=SEED)
    lstm_err = check_lstm_cell(gen)
    scan_err = check_text_scan(abstracts, titles)
    flash_err = check_flash_attention(gen)
    rg_err = check_rg_lru(gen)
    mlstm_err, mlstm_state_err = check_mlstm_chunk(gen)
    clean_err = check_text_clean(gen)
    train_gen = torch.Generator().manual_seed(SEED + 1)  # the earlier checks' draws unchanged
    bwd_err = check_lstm_cell_bwd(train_gen)

    # 4. timings
    lstm_t = time_lstm_cell(gen, bw, flops)
    scan_t = time_text_scan(abstracts, bw)
    timed = {"flash_attention": time_flash_attention(gen, bw, flops),
             "rg_lru": time_rg_lru(gen, bw, flops),
             "mlstm_chunk": time_mlstm_chunk(gen, bw, flops)}
    bwd_t = time_lstm_cell_bwd(train_gen, bw, flops)

    # 5. the summarizer at CONFIG width
    launches, serve_line = serve(abstracts, titles)

    # 6. each LM at CONFIG width and depth, then card vs CPU at a few layers
    from repro_torch.configs import get

    lm_launches = {name: {} for name in timed}
    serve_lm_lines = []
    for arch in LM_ARCHS:
        cfg = get(arch)
        counts, line = serve_lm(cfg)
        for kernel, n in counts.items():
            if n:
                lm_launches[kernel][cfg.name] = n
        torch.cuda.empty_cache()
        line.update(lm_card_vs_cpu(cfg, CARD_VS_CPU_LAYERS[arch]))
        torch.cuda.empty_cache()
        serve_lm_lines.append(line)

    # 7. preprocessing: corpus -> ingest -> pre_clean -> device cleaning
    workdir = ROOT / "build" / "chip_smoke_corpus"
    cleaned, pre_cleaned, abstracts_flat, clean_launches, preprocess_line = preprocess(workdir)
    clean_t = time_text_clean(gen, abstracts_flat, bw)
    del abstracts_flat
    torch.cuda.empty_cache()

    # 8. the paper's comparison: the abstract column's scan, CA, P3SAPP
    scan_held, scan_column = check_p3sapp_scan(pre_cleaned)
    scan_t["p3sapp_column"] = time_text_scan_column(scan_column, bw)
    del scan_column, pre_cleaned
    torch.cuda.empty_cache()
    p3sapp_launches, p3sapp_line, p3sapp_records = p3sapp(workdir, scan_held)
    torch.cuda.empty_cache()

    # 9. the Dataset planner on the same corpus: whole frame, streamed, cached, fed
    dataset_launches, dataset_line = dataset(workdir, p3sapp_records)
    del p3sapp_records
    shutil.rmtree(workdir)
    torch.cuda.empty_cache()

    # 10. the feed into the summarizer's encoder
    feed_line = feed(cleaned)
    torch.cuda.empty_cache()

    # 11. training: card vs CPU, 40 steps with a checkpoint, resume
    train_line = train(cleaned)

    # 12. report
    def lm_kernel(name, err, source, replaces):
        """Headline: the decode row, most of a serving run's launches; all
        timed rows nested; launches summed over the served LMs."""
        rows = timed[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(lm_launches[name].values()),
                "launches_by_arch": lm_launches[name], "max_abs_err": err,
                **{k: rows["decode"][k] for k in ("ms", "plain_ms", "library_ms", "ms_burst",
                                                  "library_ms_burst", "bound_ms", "bound_by")},
                **rows}

    kernels = [
        {"name": "lstm_cell", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
         "replaces": "src/repro/kernels/lstm_cell/lstm_cell.py:23",
         "launches": launches["lstm_cell"], "max_abs_err": lstm_err, **lstm_t,
         "train_launches": train_line["lstm_cell_launches"],
         "dataset_launches": dataset_launches["lstm_cell"]},
        {"name": "text_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/text_scan.cu",
         "replaces": "src/repro/kernels/text_clean/text_clean.py:77",
         "launches": launches["text_scan"], "max_abs_err": scan_err, **scan_t,
         "p3sapp_launches": p3sapp_launches, "dataset_launches": dataset_launches["text_scan"]},
        lm_kernel("flash_attention", flash_err, "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention/flash_attention.py:27"),
        lm_kernel("rg_lru", rg_err, "src/repro_torch/kernels/csrc/rg_lru.cu",
                  "src/repro/kernels/rg_lru/rg_lru.py:28"),
        {**lm_kernel("mlstm_chunk", mlstm_err, "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                     "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:32"),
         "state_max_rel_err": mlstm_state_err},
        {"name": "text_clean", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/text_clean.cu",
         "replaces": "src/repro/kernels/text_clean/text_clean.py:34",
         "launches": clean_launches, "max_abs_err": clean_err,
         **{k: clean_t["matrix"][k] for k in
            ("ms", "ms_burst", "plain_ms", "library_ms", "bound_ms", "bound_by")}, **clean_t},
        {"name": "lstm_cell_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_cell_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/seq2seq.py:63 lstm_cell",
         "launches": train_line["lstm_cell_bwd_launches"], "max_abs_err": bwd_err, **bwd_t,
         "dataset_launches": dataset_launches["lstm_cell_bwd"]},
    ]
    for (kernel, row), before in BEFORE_MS.items():
        entry = next(k for k in kernels if k["name"] == kernel)
        now = entry[row]["ms"] if row else entry["ms"]
        print(f"{kernel}{' ' + row if row else ''}: {now:.5f} ms a launch (before: {before} ms, "
              f"{before / now:.2f}x)")
    for (kernel, row), before in BEFORE_BURST_MS.items():
        entry = next(k for k in kernels if k["name"] == kernel)
        now = entry[row]["ms_burst"] if row else entry["ms_burst"]
        print(f"{kernel}{' ' + row if row else ''}: {now:.6f} ms a launch back to back "
              f"(before: {before} ms, {before / now:.2f}x)")
    print(f"chip_smoke.py ran its phases in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {**serve_line, "card": card}}))
    for line in serve_lm_lines:
        print(json.dumps({"serve_lm": {**line, "card": card}}))
    print(json.dumps({"preprocess": {**preprocess_line, "card": card}}))
    print(json.dumps({"feed": {**feed_line, "card": card}}))
    print(json.dumps({"train": {**train_line, "card": card}}))
    print(json.dumps({"p3sapp": {**p3sapp_line, "card": card}}))
    print(json.dumps({"dataset": {**dataset_line, "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
