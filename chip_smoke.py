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
   inputs; ``flash_attention`` also at DeepSeek-MoE-16B's heads (16/16 of
   128: prefill, decode, its training step), at long caches split over a cluster,
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
6. for each LM of ``LM_ARCHS`` (StableLM-3B, RecurrentGemma-9B, xLSTM-1.3B,
   DeepSeek-MoE-16B) at its published width and depth (DeepSeek-MoE-16B cut
   to ``SERVE_LM_LAYERS``: 8 of its 28 layers; random weights from seed 0
   built on the card): serve 8 requests through ``serve_requests``, 4 slots, 12 new
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
   ``lstm_layer_bwd`` counts (and no ``lstm_cell_bwd``); each part's wall
   time, ``StageTimings`` and the feeds' ``OverlapReport``;
10. the process and remote shard executors against the thread executor
   on the same corpus (``executors``), 4 workers (the remote executor's
   local TCP workers), the ``device`` backend, the chain without its
   dedup, the counters set to 0 just before each part and read just after:
   ``fit_vocab`` (the same vocabulary), an epoch of
   ``device_batches(overlap=True)`` (every batch equal bit for bit, the
   executors' start from construction to the first shard result), the
   shard cache cold and warm (the same counters, warm batches equal to
   cold), each with exactly 2 ``text_scan`` launches a shard, 0 warm, the
   process and remote workers' launches counted in the workers and added
   by the caller; then 20 ``TrainController`` steps fed by
   ``make_input_pipeline`` on each executor with exact ``lstm_cell`` and
   ``lstm_layer_bwd`` counts (and no ``lstm_cell_bwd``); then the remote
   epoch again with one worker SIGKILLed after the first result (the
   threads' batches, exactly 2 launches a shard);
11. text serving (``serve_text``): a row program of the abstract plan
   (``Dataset.row_program``, vocabulary fitted on the corpus), StableLM-3B
   at its published width and depth with that vocabulary (random weights
   from seed 0 built on the card), 4 slots, two waves sharing one ring
   cache: exact ``ServeStats`` counters, exact ``text_scan`` launches
   (the program's kernel scans times the calls that reach them) and
   ``flash_attention`` launches (32 x the tokens of the decoded
   requests); every decoded prompt's tokens equal on the card, the CPU and
   the thread executor's rows; 2 layers of the same width at
   ``init_scale=1``, served tokens card against CPU;
12. the feed: 32 batches of 64 cleaned abstracts, tokenized and snapped
   onto a ``BucketGrid`` in ``DeviceFeed``'s fill thread, copied to the
   card and run through ``Seq2Seq.encode`` at CONFIG width inside
   ``feed.step``; the ``OverlapReport`` and the exact ``lstm_cell`` launch
   count (snapped width x 3 encoder layers, summed);
13. training (the example's, ``examples/train_summarizer_torch.py``):
   ``lstm_cell_bwd`` against its plain version at the training shape and
   its grid's edges, two launches bit for bit, the training entry of
   ``lstm_cell`` bit-equal to the serving entry, and both timed;
   ``lstm_layer_bwd`` (a layer's backward through time in one launch)
   against its plain version at T 1-128, B 1-64, H 8-264, with and without
   the final state's cotangents (fp64 decides a miss), two launches bit for
   bit, and timed beside its bound, serial floor and cuDNN's one-layer LSTM
   forward and backward (the port never calls it); one train
   step at CONFIG width (``init_scale=1``) on the card against the CPU
   (loss, every gradient present and within 1e-4 of its tensor's largest
   element, grad norm, updated params); then 40 steps of 32 cleaned
   records through ``DeviceFeed`` on the 2-D bucket grid under
   ``TrainController`` (checkpoint at step 20), the counters set to 0 just
   before and read just after (``lstm_cell`` exactly the sum of snapped
   encoder width x 3 + decoder width - 1, ``lstm_layer_bwd`` exactly 4 a
   step, ``lstm_cell_bwd`` 0), the loss falling; a second controller
   resumes at step 20 with the saved state bit for bit and tracks the first
   run's losses at 1e-4; one more step traced (idle share, ``aten::mm``
   calls);
14. the LM's training (``lm_train``, the path of ``python -m
   repro_torch.launch.train``): flash's training forward
   (``flash_attention_train.cu``, tensor cores, which also writes each
   row's log-sum-exp) and ``flash_attention_bwd`` against their plain
   versions at 15 shapes (hd 80, 128 and 256, groups 1-16, seq 1-2048,
   windows under the sequence; 2e-5 abs/rel or 1e-5 of the tensor's max),
   the forward also against fp64 and the serving kernel, no input written,
   ``rg_lru_bwd`` at the forward's 11 shapes
   and the training shape with and without h0 (1e-5), each launched twice
   and held equal bit for bit, and timed beside its plain version, bound and
   (flash) SDPA's forward alone and with its backward; ``mlstm_chunk_op``
   under grad
   (``MLSTMFunction``: ``mlstm_chunk_train.cu``, tensor cores, and
   ``mlstm_chunk_bwd``) at xLSTM-1.3B's heads (s 1-200) and narrow ones
   from a carried state, against the plain versions, fp64 (the forward's
   own algebra and autograd of the gradients) and itself bit for bit, no
   input written, and timed; one ``value_and_grad`` of ``LM.loss``
   card against CPU for StableLM-3B, RecurrentGemma-9B, xLSTM-1.3B (with
   and without remat) and DeepSeek-MoE-16B at ``CARD_VS_CPU_LAYERS``
   full-width layers, ``init_scale=1`` (loss 1e-5 rel, every gradient
   present, non-zero and within 1e-4 of its tensor's max, launches exact,
   expert ids equal); 20 steps
   of ``make_train_step`` with AdamW at StableLM-3B's full width cut to 4
   layers, batch 8, seq 64, on rows of the launcher's ``build_dataset``
   built on the card (exactly 2 ``text_scan`` launches; flash forward
   layers x 2 and backward layers x 1 a step, with remat; the loss
   falling; seconds a step, tokens/s, peak memory, one step traced for the
   idle share), then ``AdamW.update_`` against ``update`` on the same
   gradients and, where two backward passes agree bit for bit, one step of
   the launcher's donating step against one functional step, bit for bit;
   StableLM-3B at all 32 layers, 10 steps of the launcher's donating step
   (launches exact, the loss falling, seconds a step, tokens/s, peak
   memory, one step traced); then ``launch.train.main`` at ``--smoke`` on the card to
   step 10 and resumed to step 20, the restored state bit-equal to the
   saved one, and 20 steps of it for xLSTM-1.3B, DeepSeek-MoE-16B and
   Kimi-K2 (launches exact, the loss falling);
15. the two configurations with a frontend (``frontends``; their draws
   from a generator of their own): the serving flash kernel at HuBERT
   X-Large's 8 x 512 non-causal frames (16/16 heads of 80) and at
   Qwen2-VL-72B's prefill and decode (64 query heads over 8 kv heads of
   128), fp32 and bf16, and the training forward and backward at their
   training shapes, against their plain versions, twice bit for bit, and
   timed beside ``scaled_dot_product_attention``; each configuration at 2
   full-width layers (``init_scale=1``) card vs CPU on frames or tokens
   with patches: what the layers add, ``forward`` logits (1e-4) and one
   ``value_and_grad`` of ``LM.loss`` (as in phase 14; HuBERT's unused token
   embedding zero on both); HuBERT X-Large at all 48 layers: a no-grad
   forward over 8 x 512 frames (48 flash launches), then 20 donating steps
   of ``make_train_step`` over a pool of 4 frame batches labelled by their
   nearest seeded centroid (flash 48 x 2 forward and 48 backward a step,
   the loss falling; seconds a step, frames/s, peak memory);
16. bf16 training (``lm_train_bf16``; its draws from a generator of its
   own), as the JAX dry run's train cells build the LM (``remat``, bf16
   parameters, AdamW with fp32 moments): ``flash_attention_train_bf16``
   and ``flash_attention_bwd_bf16`` (wgmma, TMA and mbarriers) against their
   plain versions at the fp32 training shapes, HuBERT X-Large's and
   Qwen2-VL-72B's, StableLM-3B's train_4k microbatch (8 x 4,096, 32
   heads of 80, causal) and the new tilings' edges (lengths past one tile
   and not multiples of 128, non-causal, a head not a multiple of 8, an
   input at an odd element offset): out and the gradients within 2e-2
   abs/rel or 2e-2 of the tensor's max, lse within one bf16 unit of the
   row's largest score (the scores are rounded to bf16) and 2e-5, twice bit
   for bit, no input written; both timed at 8 x 64, 512, 2,048 and 4,096
   beside their plain versions, bounds and ``scaled_dot_product_attention``
   in bf16, the backward's kernels a call counted by its library and held
   to its plan (2, or 3 with a head split); one bf16
   ``value_and_grad`` of ``LM.loss`` card against CPU for StableLM-3B,
   RecurrentGemma-9B, xLSTM-1.3B and DeepSeek-MoE-16B at
   ``CARD_VS_CPU_LAYERS`` full-width layers (each gradient within 2e-2 of
   the CPU's bf16 one or no further from the CPU's fp32 one than the
   CPU's bf16 one, times 1.5, and where one misses both, the step split at
   the residual stream held to the same rule; cuBLAS may not add partial
   sums in bf16; launches exact, each token's expert set equal, and where
   a token ranks its experts apart its ``moe_local`` output held); StableLM-3B
   at all 32 layers in bf16 on 8 rows of 4,096 tokens of ``build_dataset``,
   5 donating steps (64 flash forward and 32 backward launches a step,
   finite losses; seconds a step, tokens/s, peak memory, one step traced,
   the share of the bf16 peak);
17. the dry run (``dryrun``, ``python -m repro_torch.launch.dryrun``): the
   StableLM-3B train_4k cell counted on meta tensors at full size (FLOPs,
   bytes, ``model_flops`` and their ratio; one counted microbatch over
   phase 16's median full-depth step, the counted share of the bf16 peak
   beside the 6·N·T share); one bf16 donating step of StableLM-3B at 2
   full-width layers on 8 x 4,096 tokens counted twice, run on the card
   under the counter and on meta: FLOPs and bytes equal exactly, each
   kernel's counted calls its ``LAUNCHES`` (flash's forward 4, backward
   2), the arguments' bytes within 1% of what the card allocated for them,
   the meta peak beside the card's; the same for DeepSeek-MoE-16B at 2
   layers (dense, then MoE) on 2 x 64 tokens, FLOPs equal and the card's
   bytes at most the meta count (which takes the routing that hits the
   most experts);
18. print the ``kernels`` line, one ``serve`` line and one ``serve_lm``
   line per LM, the ``preprocess``, ``feed``, ``train``, ``p3sapp``,
   ``dataset``, ``executors``, ``serve_text``, ``lm_train``, ``frontends``,
   ``lm_train_bf16`` and ``dryrun`` lines, the card line from nvidia-smi,
   and the result line.
"""

from __future__ import annotations

import contextlib
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
LM_ARCHS = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b",
            "qwen2_vl_72b")
LM_REQUESTS, LM_SLOTS, LM_MAX_NEW, LM_MAX_SEQ = 8, 4, 12, 128
# Served at full width but cut in depth: DeepSeek-MoE-16B to 8 of its 28
# layers (1 dense + 7 MoE, 4.6 B parameters, 18.5 GB in fp32). All 28 are
# 16.38 B parameters, 65.5 GB in fp32: too little of the card's 80 GB would
# be left beside the other phases, and too little of the run's time.
# Qwen2-VL-72B to 4 of its 80 layers (877.7 M parameters, 3.51 GB in fp32, a
# layer; 4.98 GB each for the embedding and the untied head: 24 GB); all 80
# are 291 GB.
SERVE_LM_LAYERS = {"deepseek_moe_16b": 8, "qwen2_vl_72b": 4}
# layers of the card-vs-CPU model: one layer of every kind of the pattern
# (DeepSeek-MoE-16B: its dense first layer and one MoE layer)
CARD_VS_CPU_LAYERS = {"stablelm_3b": 2, "recurrentgemma_9b": 3, "xlstm_1_3b": 8,
                      "deepseek_moe_16b": 2, "qwen2_vl_72b": 1}
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
# Per-launch times before the current designs of flash_attention, its
# backward and rg_lru, the fp64 state sum of mlstm_chunk's chunked pass and
# the mLSTM backward (PERF.md §6 lists them; NVIDIA H100 80GB HBM3, 700.00
# W), printed beside this run's: (kernel, timed row) -> ms.
BEFORE_MS = {("lstm_cell", None): 0.01327, ("text_scan", None): 0.006816,
             ("flash_attention", "decode"): 0.01395, ("flash_attention", "prefill"): 0.01411,
             ("flash_attention", "decode_hd256"): 0.02643,
             ("flash_attention", "prefill_hd256"): 0.02603, ("rg_lru", "decode"): 0.005248,
             ("rg_lru", "prefill"): 0.005824, ("mlstm_chunk", "decode"): 0.007040,
             ("mlstm_chunk", "prefill"): 0.02070, ("text_clean", "matrix"): 0.01133,
             ("text_clean", "abstracts"): 0.10571, ("flash_attention_bwd", None): 0.1347,
             ("flash_attention_train", None): 0.04581, ("mlstm_chunk_train", None): 1.2992,
             ("mlstm_chunk_bwd", None): 0.7314, ("flash_attention_train_bf16", None): 7.638,
             ("flash_attention_bwd_bf16", None): 54.79}
# The byte kernels (tools/byte_kernel_times.py against a git archive of the
# tree before them), flash's backward, the two training forwards and the
# mLSTM backward (this script, before their tensor-core designs) by the
# back-to-back timer (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W):
# (kernel, row) -> ms.
BEFORE_BURST_MS = {("text_scan", None): 0.003862, ("text_clean", "matrix"): 0.008276,
                   ("text_clean", "abstracts"): 0.103428, ("flash_attention_bwd", None): 0.1326,
                   ("flash_attention_train", None): 0.04287,
                   ("mlstm_chunk_train", None): 1.2948, ("mlstm_chunk_bwd", None): 0.7287,
                   ("flash_attention_train_bf16", None): 7.461,
                   ("flash_attention_bwd_bf16", None): 55.04}
# The phases' seconds before the mesh phase was added (PERF.md; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside this run's.
BEFORE_PHASES_SECONDS = 789.1
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
# The executors phase: the same chain without its dedup on each executor.
EXECUTORS = ("thread", "process", "remote")
# The serve_text phase: StableLM-3B (the JAX launcher's default) over a row
# program of the abstract plan; 28 requests in two waves sharing one ring
# cache: the first 20 and an empty one into a queue of 32, then those 20
# again (cache hits) and 8 more into a queue of 4 (4 shed on arrival).
SERVE_TEXT_ARCH, SERVE_TEXT_VOCAB, SERVE_TEXT_PROMPT = "stablelm_3b", 8000, 128
SERVE_TEXT_REQUESTS, SERVE_TEXT_QUEUES, SERVE_TEXT_CACHE_SLOTS = 28, (32, 4), 64
SERVE_TEXT_SLOTS, SERVE_TEXT_MAX_NEW, SERVE_TEXT_MAX_SEQ = 4, 8, 256
SERVE_TEXT_COUNTERS = {"cache_hits": 20, "cache_misses": 29, "admitted": 25, "rejected": 4,
                       "filtered": 1, "served": 44}
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


def device_ms_pair(fn) -> tuple[float, float]:
    """``device_ms`` and ``device_ms_burst`` of ``fn``; a call of more than
    0.5 ms goes back to back 20 times, not 200: 200 of them, several
    launches each, would fill the card's launch queue behind the spin and
    hold the host to the card's pace."""
    ms = device_ms(fn)
    return ms, device_ms_burst(fn, 20 if ms > 0.5 else 200)


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
        return grid_batches(ds, tok, specs)

    def scans(label, want, fn):
        return counted("dataset", label, want, fn, walls, launches)

    counters = cache_counters

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
        # threads, as in earlier runs: 4 workers without a dedup would take processes
        cached = (chain(dedup=False).workers(DATASET_WORKERS, executor="thread")
                  .cache(Path(cache_root) / "cache"))
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
        zero_lstm_counts()
        t0 = time.perf_counter()
        try:
            history = controller.run(iter(feed), n_steps=DATASET_STEPS)
        finally:
            feed.close()
        walls["train"] = time.perf_counter() - t0
        step_launches = dict(lstm_ops.LAUNCHES)
    want_steps = summarizer_launches(widths, CONFIG.n_encoder_layers)
    if len(history) != DATASET_STEPS or step_launches != want_steps:
        fail(f"dataset: {len(history)} planner-fed steps and launches {step_launches}, "
             f"expected {DATASET_STEPS} and {want_steps}")
    losses = [h["loss"] for h in history]
    if not np.isfinite(losses).all():
        fail(f"dataset: a non-finite loss {losses}")
    report = feed.report()
    walls["phase"] = time.perf_counter() - started
    line["train"] = {"steps": len(history), "batch": DATASET_BATCH, "widths": widths,
                     "lstm_cell_launches": step_launches["lstm_cell"],
                     "lstm_cell_bwd_launches": step_launches["lstm_cell_bwd"],
                     "lstm_layer_bwd_launches": step_launches["lstm_layer_bwd"],
                     "losses": losses, "feed": report.as_dict(),
                     "executor": train_stats.get("executor", "thread")}
    line.update({"seconds": walls, "text_scan_launches": launches})
    print(f"dataset: {len(history)} steps of {DATASET_BATCH} fed by make_input_pipeline in "
          f"{walls['train']:.3f} s; lstm_cell launches {step_launches['lstm_cell']} (= sum of "
          f"encoder width x {CONFIG.n_encoder_layers} + decoder width - 1), lstm_layer_bwd "
          f"{step_launches['lstm_layer_bwd']} ({CONFIG.n_encoder_layers + 1} a step), "
          f"lstm_cell_bwd {step_launches['lstm_cell_bwd']}; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; feed report {json.dumps(report.as_dict())}")
    print(f"dataset: phase wall {walls['phase']:.3f} s")
    return {"text_scan": launches, "lstm_cell": step_launches["lstm_cell"],
            "lstm_cell_bwd": step_launches["lstm_cell_bwd"],
            "lstm_layer_bwd": step_launches["lstm_layer_bwd"]}, line


def summarizer_launches(widths, n_layers: int) -> dict[str, int]:
    """The summarizer's launch counts over train steps at these snapped
    (encoder, decoder) widths: ``lstm_cell`` once a step of every layer
    (encoder width x layers + decoder width - 1), one ``lstm_layer_bwd``
    a layer a step (every layer's backward), no ``lstm_cell_bwd``."""
    return {"lstm_cell": sum(e * n_layers + d - 1 for e, d in widths), "lstm_cell_bwd": 0,
            "lstm_layer_bwd": len(widths) * (n_layers + 1)}


def zero_lstm_counts() -> None:
    from repro_torch.kernels.lstm_cell import ops as lstm_ops

    for key in lstm_ops.LAUNCHES:
        lstm_ops.LAUNCHES[key] = 0


def grid_batches(ds, tok, specs):
    """``ds`` tokenized by ``specs`` in batches of ``DATASET_BATCH`` on the
    paired bucket grid, in stream order."""
    return (ds.tokenize(tok, specs)
            .batched(DATASET_BATCH, shuffle=False, bucket_by=("encoder_tokens", "decoder_tokens"))
            .prefetch(2))


def counted(phase: str, label: str, want: int | None, fn, walls: dict, launches: dict):
    """``fn()`` with the ``text_scan`` counter set to 0 just before and read
    just after, and its wall time with the card synchronized; fails unless
    ``want`` launches (None: only read)."""
    from repro_torch.kernels.text_clean import ops as clean_ops

    clean_ops.LAUNCHES["text_scan"] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[label] = time.perf_counter() - t0
    n = launches[label] = clean_ops.LAUNCHES["text_scan"]
    if want is not None and n != want:
        fail(f"{phase} ({label}) made {n} text_scan launches, expected {want}")
    return out


@contextlib.contextmanager
def timed_executors(into: list, after_first=None):
    """Inside, each shard executor the planner makes is recorded in
    ``into``: its name, the seconds its construction took and the seconds
    from then to its first shard result; ``after_first(executor, record)``
    runs once that first result is in."""
    from repro_torch.core import executor as EX

    real = EX.make_executor

    def make(*args, **kwargs):
        t0 = time.perf_counter()
        ex = real(*args, **kwargs)
        into.append({"name": ex.name, "construct_s": time.perf_counter() - t0})
        return FirstResult(ex, t0, into[-1], after_first)

    EX.make_executor = make
    try:
        yield into
    finally:
        EX.make_executor = real


def cache_counters(stats: dict) -> dict:
    return {k: stats.get(k, 0) for k in ("cache_hits", "cache_misses", "token_cache_hits",
                                         "token_cache_misses")}


def same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def kill_first_worker(executor, record: dict) -> None:
    """SIGKILL the remote executor's first spawned worker, and keep it in
    ``record`` to read its exit status after the run."""
    import signal

    victim = executor.workers[0]
    victim.send_signal(signal.SIGKILL)
    record["killed"] = victim


def executors(workdir: Path) -> tuple[dict, dict]:
    """The process and remote shard executors against the thread executor
    under the ``device`` backend, on the ``dataset`` phase's chain without
    its dedup (a full-subset dedup keeps the reference on threads), 4
    workers (the remote executor's: local TCP workers): ``fit_vocab`` (the
    same vocabulary), an epoch of ``device_batches(overlap=True)`` (every
    batch equal bit for bit), the shard cache's cold and warm epochs (the
    same counters and batches), each with 2 ``text_scan`` launches a shard
    (0 warm), the process and remote workers' counted by themselves and
    added by the caller; each executor's start, from its construction to
    its first result; ``DATASET_STEPS`` ``TrainController`` steps fed by
    ``make_input_pipeline`` under each, exact ``lstm_cell`` and
    ``lstm_layer_bwd`` counts; then the remote epoch again with one worker
    SIGKILLed after the first result (the threads' batches, 2 launches a
    shard). Returns the launches and the ``executors`` line."""
    import tempfile

    from repro_torch.configs.p3sapp_summarizer import CONFIG
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.expr import abstract_expr, col, title_expr
    from repro_torch.core.ingest import list_shards
    from repro_torch.data.batching import seq2seq_specs
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
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
    walls, launches = {}, {}
    others = [e for e in EXECUTORS if e != "thread"]
    line = {"shards": shards, "workers": DATASET_WORKERS, "executors": EXECUTORS}

    def chain(executor):
        return (Dataset.from_json_dirs([workdir]).where(keep)
                .transform(abstract=abstract_expr(), title=title_expr()).where(keep)
                .workers(DATASET_WORKERS, executor=executor))

    def batched(ds, tok):
        return grid_batches(ds, tok, specs)

    def scans(label, want, fn):
        return counted("executors", label, want, fn, walls, launches)

    def ran_on(label, stats, executor):
        if stats.get("executor") != executor:
            fail(f"executors ({label}) ran on {stats.get('executor')}, not {executor}")

    def each(seconds):
        """``seconds(executor)`` for every executor, as text."""
        return ", ".join(f"{seconds(e):.3f} s on {e}" for e in EXECUTORS)

    # 1. fit_vocab: the same vocabulary on every executor
    vocabs, fit_timings = {}, {}
    for executor in EXECUTORS:
        stats = {}
        vocabs[executor] = scans(f"fit_vocab_{executor}", per_pass, lambda: chain(executor)
                                 .fit_vocab(vocab_size=CONFIG.vocab_size, stats=stats))
        ran_on(f"fit_vocab {executor}", stats, executor)
        fit_timings[executor] = stats["timings"].as_dict()
    tok = vocabs["thread"]
    for executor in others:
        if vocabs[executor].itos != tok.itos:
            fail(f"executors: fit_vocab's vocabulary differs between threads and {executor}")
    line["fit_vocab"] = {"vocab": len(tok), "timings": fit_timings, "equal": True}
    print(f"executors: fit_vocab {each(lambda e: walls['fit_vocab_' + e])}, "
          f"{per_pass} text_scan launches each, vocabularies equal ({len(tok)} words)")

    # 2. an epoch into DeviceFeed, and each executor's start
    def epoch_run(executor, stats):
        feed = batched(chain(executor), tok).device_batches(overlap=True, stats=stats)
        got = []
        try:
            for batch in feed:
                with feed.step(batch):
                    got.append({k: batch[k].cpu().numpy() for k in batch})
        finally:
            feed.close()
        return got, feed.report()

    batches, epoch = {}, {}
    for executor in EXECUTORS:
        stats, made = {}, []
        with timed_executors(made):
            batches[executor], report = scans(f"epoch_{executor}", per_pass,
                                              lambda: epoch_run(executor, stats))
        ran_on(f"epoch {executor}", stats, executor)
        epoch[executor] = {"batches": len(batches[executor]),
                           "timings": stats["timings"].as_dict(), "feed": report.as_dict(),
                           "start": made[0]}
    for executor in others:
        if not same_batches(batches[executor], batches["thread"]):
            fail(f"executors: the {executor} executor's batches differ from the thread "
                 "executor's")
    line["epoch"] = {**epoch, "equal": True}
    print(f"executors: epoch {each(lambda e: walls['epoch_' + e])} "
          f"({len(batches['thread'])} batches equal bit for bit, {per_pass} text_scan "
          f"launches each, the process and remote workers' summed); from construction to "
          f"the first shard result: "
          f"{each(lambda e: epoch[e]['start']['first_result_s'])}; StageTimings "
          f"(thread-seconds, worker-seconds) "
          f"{json.dumps({k: v['timings'] for k, v in epoch.items()})}")

    # 3. the shard cache, cold then warm: the same counters on every executor
    cache = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache_root:
        for executor in EXECUTORS:
            stream = batched(chain(executor).cache(Path(cache_root) / executor), tok)
            cold_stats, warm_stats = {}, {}
            cold = scans(f"cache_cold_{executor}", per_pass,
                         lambda: list(stream.iter_batches(stats=cold_stats)))
            warm = scans(f"cache_warm_{executor}", 0,
                         lambda: list(stream.iter_batches(stats=warm_stats)))
            ran_on(f"cache {executor}", warm_stats, executor)
            if len(warm) != len(cold) or not all(
                    np.array_equal(x[k], y[k]) for x, y in zip(warm, cold) for k in x):
                fail(f"executors: the warm epoch's batches differ from the cold ({executor})")
            cache[executor] = {"counters": [cache_counters(cold_stats),
                                            cache_counters(warm_stats)],
                               "cold_timings": cold_stats["timings"].as_dict(),
                               "warm_timings": warm_stats["timings"].as_dict(),
                               "batches": cold}
    want = [dict(cache_hits=0, cache_misses=per_pass, token_cache_hits=0,
                 token_cache_misses=per_pass),
            dict(cache_hits=0, cache_misses=0, token_cache_hits=per_pass,
                 token_cache_misses=0)]
    if any(cache[e]["counters"] != want for e in EXECUTORS):
        fail(f"executors: cache counters "
             f"{json.dumps({e: cache[e]['counters'] for e in EXECUTORS})}, expected {want}")
    thread_cold = cache["thread"].pop("batches")
    for executor in others:
        if not all(np.array_equal(x[k], y[k]) for x, y in
                   zip(cache[executor].pop("batches"), thread_cold) for k in x):
            fail(f"executors: the cached epochs' batches differ between threads and "
                 f"{executor}")
    line["cache"] = cache
    print(f"executors: cache cold {each(lambda e: walls['cache_cold_' + e])}; warm "
          f"{each(lambda e: walls['cache_warm_' + e])}; text_scan launches {per_pass}/0 "
          f"each; counters {json.dumps(want)} on each")

    # 4. make_input_pipeline feeds the train step at CONFIG width
    model = Seq2Seq(CONFIG, "cuda", seed=SEED)
    train = {}
    for executor in EXECUTORS:
        opt = AdamW(learning_rate=warmup_cosine(3e-3, 5, DATASET_STEPS), weight_decay=1e-4)
        train_step = make_train_step(functional_loss(model), opt)
        widths, step_s, made = [], [], []

        def fed_step(params, opt_state, batch):
            t0 = time.perf_counter()
            with feed.step(batch):
                widths.append((batch["encoder_tokens"].shape[1],
                               batch["decoder_tokens"].shape[1]))
                out = train_step(params, opt_state, batch)
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        def init_state():
            params = params_of(model)
            return params, opt.init(params)

        with tempfile.TemporaryDirectory() as ckpt_dir, timed_executors(made):
            controller = TrainController(ckpt_dir, fed_step, init_state, save_every=10 ** 6)
            zero_lstm_counts()
            t0 = time.perf_counter()
            feed = make_input_pipeline(batched(chain(executor), tok), epochs=None,
                                       overlap=True)
            try:
                history = controller.run(iter(feed), n_steps=DATASET_STEPS)
            finally:
                feed.close()
            walls[f"train_{executor}"] = time.perf_counter() - t0
            got = dict(lstm_ops.LAUNCHES)
        want_cells = summarizer_launches(widths, CONFIG.n_encoder_layers)
        if len(history) != DATASET_STEPS or got != want_cells:
            fail(f"executors: {len(history)} steps fed on {executor} and launches {got}, "
                 f"expected {DATASET_STEPS} and {want_cells}")
        if [m["name"] for m in made] != [executor]:
            fail(f"executors: the steps fed on {executor} ran on {made}")
        losses = [h["loss"] for h in history]
        if not np.isfinite(losses).all():
            fail(f"executors: a non-finite loss {losses}")
        train[executor] = {"steps": len(history), "widths": widths,
                           "lstm_cell_launches": got["lstm_cell"],
                           "lstm_cell_bwd_launches": got["lstm_cell_bwd"],
                           "lstm_layer_bwd_launches": got["lstm_layer_bwd"],
                           "ms_a_step": 1e3 * walls[f"train_{executor}"] / len(history),
                           "step_ms_median": 1e3 * statistics.median(step_s),
                           "losses": losses, "feed": feed.report().as_dict(),
                           "start": made[0]}
        print(f"executors: {len(history)} steps fed on {executor} in "
              f"{walls[f'train_{executor}']:.3f} s ({train[executor]['ms_a_step']:.1f} ms a "
              f"step, median step {train[executor]['step_ms_median']:.1f} ms); launches "
              f"{json.dumps(got)}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")

    # 5. the remote epoch again, one worker SIGKILLed after the first result:
    # its lease is released and a survivor runs its shard; the dedup keeps
    # one result, and one report of launches, a shard
    stats, made = {}, []
    with timed_executors(made, after_first=kill_first_worker):
        killed, _ = scans("epoch_remote_killed", per_pass, lambda: epoch_run("remote", stats))
    ran_on("epoch remote killed", stats, "remote")
    victim = made[0].pop("killed", None)
    if victim is None or victim.wait(timeout=30) != -9:
        fail(f"executors: the remote worker was not SIGKILLed "
             f"({victim and victim.returncode})")
    if not same_batches(killed, batches["thread"]):
        fail("executors: the remote epoch with a worker SIGKILLed differs from the thread "
             "executor's")
    line["killed_worker"] = {"batches": len(killed), "equal": True,
                             "timings": stats["timings"].as_dict(), "start": made[0],
                             "exit": victim.returncode}
    print(f"executors: remote epoch with one of {DATASET_WORKERS} workers SIGKILLed after "
          f"the first result {walls['epoch_remote_killed']:.3f} s ({len(killed)} batches "
          f"equal bit for bit to threads, {per_pass} text_scan launches)")
    walls["phase"] = time.perf_counter() - started
    line.update({"train": train, "seconds": walls, "text_scan_launches": launches})
    print(f"executors: phase wall {walls['phase']:.3f} s")
    return {"text_scan": launches,
            "lstm_cell": {k: v["lstm_cell_launches"] for k, v in train.items()},
            "lstm_cell_bwd": {k: v["lstm_cell_bwd_launches"] for k, v in train.items()},
            "lstm_layer_bwd": {k: v["lstm_layer_bwd_launches"] for k, v in train.items()}}, line


class FirstResult:
    """A shard executor whose first result's time is recorded in ``into``
    (``first_result_s``, from ``t0``, just before its construction), and
    on which ``after_first(executor, into)`` runs then."""

    def __init__(self, executor, t0: float, into: dict, after_first=None):
        self._executor, self._t0, self._into = executor, t0, into
        self._after_first = after_first

    def __getattr__(self, name):
        return getattr(self._executor, name)

    def __iter__(self):
        for res in self._executor:
            if "first_result_s" not in self._into:
                self._into["first_result_s"] = time.perf_counter() - self._t0
                if self._after_first is not None:
                    self._after_first(self._executor, self._into)
            yield res


def kernel_scans(comp) -> int:
    """The ``text_scan`` launches of one evaluation of a compiled expression
    or predicate over a non-empty buffer: its scan passes that
    ``bytesops._run_scan_device`` gives the kernel (the kernel's flags and
    at least one span)."""
    from repro_torch.core import bytesops as B

    if not isinstance(comp, tuple) or not comp or not isinstance(comp[0], str):
        return 0
    if comp[0] in ("chain", "wrap"):
        prog = B.compile_megapass(comp[2]) if comp[2] else None
        n = sum(kind == "scan" and bool(p.spans) and B._kernel_scan_args(p) is not None
                for kind, p in prog or ())
        return n + (kernel_scans(comp[1]) if comp[0] == "wrap" else 0)
    return sum(kernel_scans(c) for c in comp[1:])


def serve_text_phase(workdir: Path) -> tuple[dict, dict]:
    """Text serving at StableLM-3B's published width and depth (random
    weights from ``SEED`` built on the card, the vocabulary the fitted
    tokenizer's): a row program from the abstract plan over the corpus,
    ``serve_text`` through ``SERVE_TEXT_SLOTS`` slots in two waves that
    share one ring cache (exact ``ServeStats`` counters, ``text_scan`` and
    ``flash_attention`` launches worked out from the program and the
    served tokens); every decoded request's prompt tokens from the row
    program on the card equal to the same program's on the CPU and to that
    record's row of the thread executor's tokens; then a model of the same
    width cut to ``CARD_VS_CPU_LAYERS`` layers, card against CPU with the
    same weights. Returns the launches and the ``serve_text`` line."""
    import tempfile

    from repro_torch.configs import get
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.expr import abstract_expr, col
    from repro_torch.core.ingest import list_shards
    from repro_torch.data.batching import TokenSpec
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.lm import LM
    from repro_torch.runtime.serve_loop import RingCache, ServeStats, TextRequest, serve_text

    started = time.perf_counter()
    walls, launches = {}, {}

    def plan(dirs):
        return (Dataset.from_json_dirs(dirs, fields=("abstract",))
                .where(col("abstract").not_empty()).transform(abstract=abstract_expr()))

    tok = plan([workdir]).fit_vocab(vocab_size=SERVE_TEXT_VOCAB, workers=DATASET_WORKERS,
                                    executor="thread")
    spec = TokenSpec("abstract", SERVE_TEXT_PROMPT)
    chain = plan([workdir]).tokenize(tok, [spec]).batched(BATCH).prefetch(2)
    rp, rp_cpu = chain.row_program(), chain.row_program(device="cpu")
    out_name = rp.output_names[0]
    filter_scans = sum(kernel_scans(arg) for kind, arg in rp.steps if kind == "filter")
    project_scans = sum(kernel_scans(comp) for kind, arg in rp.steps if kind == "project"
                        for _, comp in arg)

    # the requests: shard 0's first distinct raw abstracts whose rows the plan keeps
    shard0 = list_shards([workdir])[0]
    raw = [json.loads(line).get("abstract") for line in shard0.read_text().splitlines()
           if line.strip()]
    texts, seen = [], set()
    for text in raw:
        got = rp_cpu(text) if isinstance(text, str) and text not in seen else None
        seen.add(text)
        if got is not None and (got[out_name][0] != 0).any():
            texts.append(text)
        if len(texts) == SERVE_TEXT_REQUESTS:
            break
    if len(texts) != SERVE_TEXT_REQUESTS:
        fail(f"serve_text: shard 0 holds {len(texts)} served abstracts, not "
             f"{SERVE_TEXT_REQUESTS}")
    first = SERVE_TEXT_REQUESTS - 8
    wave1 = [TextRequest(i, t, SERVE_TEXT_MAX_NEW) for i, t in enumerate(texts[:first] + [""])]
    wave2 = [TextRequest(100 + i, t, SERVE_TEXT_MAX_NEW) for i, t in enumerate(texts)]

    cfg = dataclasses.replace(get(SERVE_TEXT_ARCH), vocab_size=len(tok.itos))
    t0 = time.perf_counter()
    model = LM(cfg, "cuda", seed=SEED)
    torch.cuda.synchronize()
    walls["build"] = time.perf_counter() - t0
    kw = dict(slots=SERVE_TEXT_SLOTS, max_seq=SERVE_TEXT_MAX_SEQ)
    serve_text(model, rp, wave1[:1], **kw)  # warm-up
    torch.cuda.synchronize()

    cache, stats = RingCache(slots=SERVE_TEXT_CACHE_SLOTS), ServeStats()
    results = {}
    flash_ops.LAUNCHES["flash_attention"] = 0

    def waves():
        for reqs, queue_size in ((wave1, SERVE_TEXT_QUEUES[0]), (wave2, SERVE_TEXT_QUEUES[1])):
            results.update(serve_text(model, rp, reqs, queue_size=queue_size, cache=cache,
                                      stats=stats, **kw))

    counted("serve_text", "serve", None, waves, walls, launches)
    launches["flash_attention"] = flash_ops.LAUNCHES["flash_attention"]
    counters = {k: getattr(stats, k) for k in SERVE_TEXT_COUNTERS}
    if counters != SERVE_TEXT_COUNTERS:
        fail(f"serve_text: counters {counters}, expected {SERVE_TEXT_COUNTERS}")
    decoded = [r.uid for r in wave1[:first]] + [r.uid for r in wave2[first:]
                                                if r.uid in results]
    if len(decoded) != stats.served - stats.cache_hits or results[first] != [] or any(
            results[100 + i] != results[i] for i in range(first)):
        fail("serve_text: the decoded, filtered or cached answers are not the expected ones")
    if any(not 1 <= len(results[u]) <= SERVE_TEXT_MAX_NEW or
           not all(0 <= x < cfg.vocab_size for x in results[u]) for u in decoded):
        fail("serve_text: a decoded request got no token, too many or one outside the vocabulary")
    attn = model.kinds.count("attn")
    want = {"text_scan": filter_scans * stats.admitted + project_scans * len(decoded),
            "flash_attention": attn * sum(len(results[u]) for u in decoded)}
    if launches["serve"] != want["text_scan"] or launches["flash_attention"] != \
            want["flash_attention"]:
        fail(f"serve_text: launches text_scan {launches['serve']}, flash_attention "
             f"{launches['flash_attention']}, expected {want}")
    print(f"serve_text: {cfg.name} ({model.param_count()} parameters, vocabulary {len(tok)}, "
          f"built in {walls['build']:.1f} s) served {len(wave1)} + {len(wave2)} requests in "
          f"{walls['serve']:.3f} s; counters {json.dumps(counters)}; text_scan launches "
          f"{launches['serve']} = {filter_scans} x {stats.admitted} preprocessed + "
          f"{project_scans} x {len(decoded)} reaching the projection; flash_attention "
          f"{launches['flash_attention']} = {attn} x {sum(len(results[u]) for u in decoded)} "
          f"(the prefills + the later tokens of {len(decoded)} decoded requests)")

    # zero skew: card, CPU and the training path's thread executor
    by_text = {r.text: r.uid for r in wave1[:first] + wave2[first:]}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as one:
        shutil.copy(shard0, one)
        rows = [row for b in plan([Path(one)]).tokenize(tok, [spec])
                .batch(BATCH, shuffle=False, drop_remainder=False).prefetch(2)
                .workers(1, executor="thread").iter_batches() for row in b[out_name]]
    _, kept = rp_cpu.encode_batch(raw)
    row_of = np.cumsum(kept) - 1
    for text, uid in by_text.items():
        if uid not in decoded:
            continue
        card, cpu = rp(text)[out_name][0], rp_cpu(text)[out_name][0]
        train_row = rows[row_of[raw.index(text)]]
        if not (np.array_equal(card, cpu) and np.array_equal(np.trim_zeros(card, "b"),
                                                              np.trim_zeros(train_row, "b"))):
            fail(f"serve_text: request {uid}'s prompt tokens differ between the card, the CPU "
                 f"and the thread executor")
    lat = sorted(stats.latency_s.values())
    quantiles = {f"p{q}": float(np.percentile(lat, q)) for q in (50, 90, 99)}
    print(f"serve_text: prompt tokens of {len(decoded)} decoded requests equal on the card, "
          f"the CPU and the thread executor's rows; preprocess {stats.preprocess_s:.3f} s, "
          f"decode {stats.decode_s:.3f} s; latency {json.dumps(quantiles)}")
    del model
    torch.cuda.empty_cache()

    # card against CPU at a few layers of the same width, same weights
    small = dataclasses.replace(cfg, n_layers=CARD_VS_CPU_LAYERS[SERVE_TEXT_ARCH],
                                init_scale=1.0)
    card = LM(small, "cuda", seed=SEED)
    cpu = LM(small, "meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    reqs = [TextRequest(i, t, SERVE_TEXT_MAX_NEW) for i, t in enumerate(texts[:8])]
    agreement = token_agreement(serve_text(card, rp, reqs, **kw),
                                serve_text(cpu, rp_cpu, reqs, **kw))
    print(f"serve_text: {small.name} with {small.n_layers} layers at init_scale 1, card vs CPU: "
          f"served-token agreement {agreement:.4%}")
    if agreement < 0.99:
        fail(f"serve_text: served-token agreement {agreement:.4%} is under 99%")
    walls["phase"] = time.perf_counter() - started
    print(f"serve_text: phase wall {walls['phase']:.3f} s")
    line = {"arch": cfg.name, "layers": cfg.n_layers, "vocab": len(tok), "slots": kw["slots"],
            "max_new": SERVE_TEXT_MAX_NEW, "max_seq": kw["max_seq"],
            "waves": [len(wave1), len(wave2)], "queue_sizes": list(SERVE_TEXT_QUEUES),
            "counters": counters, "launches": {"text_scan": launches["serve"],
                                               "flash_attention": launches["flash_attention"]},
            "expected_launches": want, "decoded": len(decoded),
            "tokens": sum(len(results[u]) for u in decoded),
            "preprocess_s": stats.preprocess_s, "decode_s": stats.decode_s,
            "latency_s": quantiles, "seconds": walls, "prompt_skew": 0,
            "card_vs_cpu_layers": small.n_layers, "token_agreement": agreement}
    return line["launches"], line


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


# lstm_layer_bwd: (T, B, H, d_in) covering T 1, 2, 24 and 128, B 1, 32, 33
# and 64 (rows split over clusters, a ragged last cluster), H 8, 256 and
# 264 (a unit past 32 a block, more units than threads) and the widest it
# takes, d_in 128 and 256; each with and without the final state's
# cotangents. The first is timed.
LAYER_WIDEST = 320  # ROADMAP Queue 3's limit: a block holds an eighth of wh
LAYER_SHAPES = [(128, TRAIN_BATCH, 256, 256), (128, 64, 256, 128), (24, 33, 264, 128),
                (2, 1, 8, 256), (1, TRAIN_BATCH, 256, 128), (24, 64, 8, 128),
                (128, 1, 264, 256), (2, 33, 256, 256), (1, 64, 264, 128), (24, 1, 256, 256),
                (2, 3, LAYER_WIDEST, 128)]
LAYER_TINY = (128, 1, 8, 128)  # the same T at the smallest work: the serial floor


def layer_bwd_inputs(T, B, H, d_in, gen, last=True):
    """What a layer's training forward saves (gates, cs) from the plain
    forward on random inputs on the card, wh, and random cotangents of hs
    and (with ``last``) of the final state."""
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_train_ref

    x, h, c, wx, wh, b = lstm_inputs(B, d_in, H, torch.float32, gen)
    wx, wh = wx * 8, wh * 8  # gates spread over their range
    xs = torch.randn(T, B, d_in, generator=gen).cuda()
    cs, gates = [c], []
    for t in range(T):
        h, c, g = lstm_cell_train_ref(xs[t], h, c, wx, wh, b)
        cs.append(c)
        gates.append(g)
    dhs = torch.randn(T, B, H, generator=gen).cuda()
    dh, dc = (torch.randn(B, H, generator=gen).cuda() if last else None for _ in range(2))
    return dhs, dh, dc, torch.stack(gates), torch.stack(cs), wh


def check_lstm_layer_bwd(gen) -> float:
    """``lstm_layer_bwd`` against ``lstm_layer_bwd_ref`` on the card at
    ``LAYER_SHAPES``, with and without the final state's cotangents: each
    of dz, dh0 and dc0 within 1e-5 of its tensor's max, or, where the
    kernel misses, both versions held against the fp64 plain version (the
    kernel within 1e-5 of the max, or no further than the fp32 plain
    version); two launches identical bit for bit. Returns the max abs
    error at the timed shape."""
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_layer_bwd_ref

    err, by_fp64 = 0.0, []
    for shape in LAYER_SHAPES:
        for last in (True, False):
            args = layer_bwd_inputs(*shape, gen, last=last)
            got = ops.lstm_layer_bwd(*args)
            again = ops.lstm_layer_bwd(*args)
            torch.cuda.synchronize()
            want = lstm_layer_bwd_ref(*args)
            exact = None
            for name, g, r, w in zip(("dz", "dh0", "dc0"), got, again, want):
                if not torch.equal(g, r):
                    fail(f"lstm_layer_bwd {shape} last={last}: two launches differ in {name}")
                scale = w.abs().max().item()
                e = (g - w).abs().max().item()
                if e > 1e-5 * scale:
                    if exact is None:
                        exact = lstm_layer_bwd_ref(*(None if t is None else t.double()
                                                     for t in args))
                    t64 = exact[("dz", "dh0", "dc0").index(name)]
                    e_k = (g.double() - t64).abs().max().item()
                    e_p = (w.double() - t64).abs().max().item()
                    if e_k > max(1e-5 * scale, e_p):
                        fail(f"lstm_layer_bwd {shape} last={last} {name}: {e:.3e} from plain, "
                             f"{e_k:.3e} from fp64 (plain {e_p:.3e}; max {scale:.3e}, tol "
                             f"1e-5 of the max)")
                    by_fp64.append([list(shape), last, name, e_k, e_p])
                if shape == LAYER_SHAPES[0] and last:
                    err = max(err, e)
    widest = ops._entry("lstm_layer_bwd_max_hidden")()
    if widest != LAYER_WIDEST:
        fail(f"lstm_layer_bwd takes hidden up to {widest}, documented {LAYER_WIDEST}")
    try:
        ops.lstm_layer_bwd(*layer_bwd_inputs(2, 3, LAYER_WIDEST + 8, 128, gen))
        fail(f"lstm_layer_bwd took hidden {LAYER_WIDEST + 8}, past its limit")
    except ValueError as exc:
        if f"({LAYER_WIDEST}:" not in str(exc):
            fail(f"lstm_layer_bwd's refusal does not name its limit: {exc}")
    print(f"lstm_layer_bwd: matches plain at {len(LAYER_SHAPES)} shapes x 2 (T 1-128, B 1-64, "
          f"H 8-{LAYER_WIDEST}; tol 1e-5 of each tensor's max), fp64 decided {by_fp64}; two "
          f"launches identical bit for bit; hidden {LAYER_WIDEST + 8} refused")
    return err


def time_lstm_layer_bwd(gen, bw: float, flops: float) -> dict:
    """The layer backward at T 128, B 32, d_in 256, H 256, both timers,
    beside its plain version, its bound (bytes and serial products) and
    serial floor (the kernel measured at B 1, H 8, where the products
    vanish and T cluster barriers remain); the yardstick is
    ``torch.nn.LSTM``'s forward and backward for one layer (cuDNN, TF32
    off), beside the port's pair: ``lstm_layer_op``'s T forward launches
    and its backward."""
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_layer_bwd_ref

    T, B, H, d_in = LAYER_SHAPES[0]
    args = layer_bwd_inputs(T, B, H, d_in, gen)
    tiny = layer_bwd_inputs(*LAYER_TINY, gen)
    # reads dhs, dh_last, dc_last, the gates, c (T + 1) and wh; writes dz, dh0, dc0
    n_bytes = 4 * (T * B * H + 2 * B * H + T * B * 4 * H + (T + 1) * B * H + H * 4 * H
                   + T * B * 4 * H + 2 * B * H)
    n_ops = 2 * T * B * H * 4 * H  # the serial products dz[t+1] wh^T, dh0 included
    x, h0, c0, wx, wh, b = lstm_inputs(B, d_in, H, torch.float32, gen)
    xs = torch.randn(T, B, d_in, generator=gen).cuda()
    leaves = [t.requires_grad_(True) for t in (xs, h0, c0, wx, wh, b)]
    cts = [torch.randn(T, B, H, generator=gen).cuda(), torch.randn(B, H, generator=gen).cuda(),
           torch.randn(B, H, generator=gen).cuda()]

    def port_pair():
        torch.autograd.backward(ops.lstm_layer_op(*leaves), cts)

    lstm = torch.nn.LSTM(d_in, H).cuda()
    inp = xs.detach().requires_grad_(True)
    state = (h0.detach()[None], c0.detach()[None])

    def library():
        out, (hn, cn) = lstm(inp, state)
        torch.autograd.backward((out, hn[0], cn[0]), cts)

    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = device_ms(library, n=20)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    row = {"ms": device_ms(lambda: ops.lstm_layer_bwd(*args)),
           "ms_burst": device_ms_burst(lambda: ops.lstm_layer_bwd(*args), n=50),
           "plain_ms": device_ms(lambda: lstm_layer_bwd_ref(*args), n=10),
           "bound_ms": max(n_bytes / bw, n_ops / flops) * 1e3,
           "bound_by": "bytes" if n_bytes / bw >= n_ops / flops else "operations",
           "bytes": n_bytes, "operations": n_ops,
           "serial_floor_ms": device_ms(lambda: ops.lstm_layer_bwd(*tiny)),
           "serial_floor_shape": list(LAYER_TINY),
           "library_ms": library_ms,
           "library": "torch.nn.LSTM forward + backward, one layer (cuDNN, allow_tf32 False)",
           "pair_ms": device_ms(port_pair, n=20), "shape": [T, B, H, d_in]}
    print(f"lstm_layer_bwd fp32 T={T} B={B} H={H} d_in={d_in}: {json.dumps(row)}")
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
        return summarizer_launches(widths, CONFIG.n_encoder_layers)

    # warm-up: the first step's kernels, cuBLAS handles and allocator
    warm = {k: torch.from_numpy(v).cuda() for k, v in grid.snap(hosts[0]).items()}
    params, state = init_state()
    train_step(params, state, warm)
    torch.cuda.synchronize()
    del warm, params, state

    with tempfile.TemporaryDirectory() as ckpt_dir:
        saved = {}
        controller, feed, widths = controller_over(ckpt_dir, hosts, saved)
        zero_lstm_counts()
        history, report, seconds = run(controller, feed)
        launches = dict(lstm_ops.LAUNCHES)
        want = want_launches(widths)
        if len(history) != TRAIN_STEPS or launches != want:
            fail(f"the train run made {len(history)} steps and launches {launches}, expected "
                 f"{TRAIN_STEPS} steps and {want}")
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
        zero_lstm_counts()
        history2, _, seconds2 = run(resumed, feed2)
        resume_launches = dict(lstm_ops.LAUNCHES)
    # one more step traced, as examples/train_summarizer_torch.py --profile does
    from repro_torch.launch.serve import profile

    traced_batch = {k: torch.from_numpy(v).cuda() for k, v in grid.snap(hosts[0]).items()}
    params, state = init_state()
    line["traced_step"] = profile(lambda: train_step(params, state, traced_batch),
                                  torch.device("cuda"), torch.cuda.synchronize,
                                  f"one train step at CONFIG, batch {TRAIN_BATCH}")
    del params, state, traced_batch
    if [h["step"] for h in history2] != list(range(TRAIN_SAVE_AT + 1, TRAIN_STEPS + 1)):
        fail(f"the resumed run took steps {[h['step'] for h in history2]}")
    want2 = want_launches(widths2)
    if resume_launches != want2:
        fail(f"the resumed run made launches {resume_launches}, expected {want2}")
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
        "lstm_layer_bwd_launches": launches["lstm_layer_bwd"],
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "resumed_at": TRAIN_SAVE_AT, "resume_max_rel_loss_diff": rel,
        "resume_seconds": seconds2, "resume_launches": resume_launches,
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
    })
    print(f"train: {len(history)} steps of {TRAIN_BATCH} at CONFIG width in {seconds:.3f} s "
          f"({seconds / len(history) * 1e3:.1f} ms a step, {n_tokens / seconds:.0f} training "
          f"tokens/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}; feed wait "
          f"{report.device_idle_fraction:.2%} of the steps (the feed's OverlapReport; the "
          f"card's idle share is the traced step's, {line['traced_step']['idle_share']:.2%}), "
          f"{line['wall_idle_share']:.2%} of the wall clock outside the steps")
    print(f"train: lstm_cell launches {launches['lstm_cell']} = sum of snapped (encoder width "
          f"x {CONFIG.n_encoder_layers} + decoder width - 1) over the steps; lstm_layer_bwd "
          f"{launches['lstm_layer_bwd']} = {CONFIG.n_encoder_layers + 1} a step; lstm_cell_bwd "
          f"{launches['lstm_cell_bwd']}")
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
# DeepSeek-MoE-16B's attention (16 query and kv heads of 128): a block
# prefill, decode steps into the 128-long cache, and the training step's
# full causal pass (LM_TRAIN_CHECK_BATCH sequences of 64). Drawn from a
# generator of their own, so the earlier shapes' draws are unchanged.
FLASH_SERVED_MOE = (
    [(1, sq, LM_MAX_SEQ, 16, 16, 128, True, 0, 0, sq) for sq in (4, 9, 16)]
    + [(1, 1, LM_MAX_SEQ, 16, 16, 128, True, 0, pos, pos + 1) for pos in (0, 4, 15, 77, 126)]
    + [(2, 64, 64, 16, 16, 128, True, 0, 0, None)]
)
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
# timed shapes: StableLM-3B's heads (hd 80), RecurrentGemma-9B's (MQA, hd
# 256), then DeepSeek-MoE-16B's (16/16 heads of 128) at decode and at the
# training step's forward
FLASH_TIMED = {
    "decode": (1, 1, LM_MAX_SEQ, 32, 32, 80, True, 0, 15, 16),
    "prefill": (1, 10, LM_MAX_SEQ, 32, 32, 80, True, 0, 0, 10),
    "decode_hd256": (1, 1, LM_MAX_SEQ, 16, 1, 256, True, 2048, 15, 16),
    "prefill_hd256": (1, 10, LM_MAX_SEQ, 16, 1, 256, True, 2048, 0, 10),
    "decode_hd128": (1, 1, LM_MAX_SEQ, 16, 16, 128, True, 0, 15, 16),
    "train_hd128": (2, 64, 64, 16, 16, 128, True, 0, 0, 64),
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
    moe_gen = torch.Generator().manual_seed(SEED + 3)
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
        for case in FLASH_SERVED_MOE:
            q, k, v = flash_inputs(case, dtype, moe_gen)
            got = flash_attention_op(q, k, v, **flash_kwargs(case))
            again = flash_attention_op(q, k, v, **flash_kwargs(case))
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **flash_kwargs(case))
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if not torch.equal(got, again):
                fail(f"flash_attention {dtype} {case}: two launches differ")
            if dtype == torch.float32:
                err = max(err, (got - want).abs().max().item())
        print(f"flash_attention {dtype}: matches plain at {len(cases) + len(FLASH_SERVED_MOE)} "
              f"shapes (tol {tol}), {len(FLASH_SERVED_MOE)} of them DeepSeek-MoE-16B's, "
              f"{len(FLASH_SPLITS) + 1} at a cluster split; two launches identical bit for bit")
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
    2·d_rnn instead of d_rnn·2H + 2H; it counts a frontend's
    ``frontend/proj`` (frontend_dim · d_model) as the tree has it."""
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
    if cfg.moe is not None:
        line.update(moe_serving_costs(model, requests, kw))
    return launches, line


def moe_serving_costs(model, requests, kw) -> dict:
    """For a MoE LM: the expert loop's host syncs (one a MoE layer a model
    pass) over the served run again, with the seconds the host waited in
    them, and one request traced for the card's idle share."""
    from repro_torch.launch.serve import profile
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import serve_requests

    moe.HOST_SYNCS.update(count=0, seconds=0.0)
    t0 = time.perf_counter()
    serve_requests(model, requests, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    syncs = dict(moe.HOST_SYNCS)
    n_moe = sum(model.moe)
    traced = profile(lambda: serve_requests(model, requests[:1], slots=1, max_seq=LM_MAX_SEQ),
                     torch.device("cuda"), torch.cuda.synchronize,
                     f"one {model.cfg.name} request at {model.cfg.n_layers} layers")
    print(f"{model.cfg.name}: {syncs['count']} host syncs of the expert loop ({n_moe} a model "
          f"pass) in a served run of {seconds:.3f} s, waiting {syncs['seconds']:.3f} s in them "
          f"({syncs['seconds'] / seconds:.2%})")
    return {"host_syncs": syncs["count"], "host_sync_wait_s": syncs["seconds"],
            "host_sync_run_s": seconds, "host_sync_wait_share": syncs["seconds"] / seconds,
            "traced_request": traced}


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
            return (model.hidden({"tokens": t}) - embed_tokens(model.embed, t, small)).cpu()

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


# The lm_train phase: the LM launcher's training path (src/repro/launch/
# train.py, whose default is --arch stablelm_3b) on the card. StableLM-3B
# at its full width cut to LM_TRAIN_LAYERS of its 32 layers with the
# functional step (its figures are comparable from run to run; the full
# depth takes the donating step below). 4 layers
# peak at 30.2 GB; at 8 the launcher's learning rate (3e-3) diverges, with
# the plain versions as with the kernels (tools/lm_train_depth.py); batch 8,
# seq 64 (the launcher's defaults), LM_TRAIN_STEPS steps with remat, so each
# attention layer's flash forward launches twice a step and its backward
# once.
LM_TRAIN_ARCH, LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = "stablelm_3b", 4, 8, 64
LM_TRAIN_STEPS, LM_TRAIN_CORPUS_MB, LM_TRAIN_LR = 20, 2.0, 3e-3
# StableLM-3B at all 32 layers through the launcher's donating step (params,
# gradients and both moments are 45 GB in fp32): FULL_DEPTH_STEPS steps of
# the same batches from its own draws. The launcher's 3e-3 diverges from 8
# layers on (PERF.md §5), so the run takes a tenth of it, warmed up over 2 steps.
FULL_DEPTH_STEPS, FULL_DEPTH_LR, FULL_DEPTH_WARMUP = 10, 3e-4, 2
# one step card vs CPU at CARD_VS_CPU_LAYERS full-width layers, batch 2, seq
# 64, by (arch, remat): xLSTM-1.3B with and without remat
LM_TRAIN_CHECKED = (("stablelm_3b", True), ("recurrentgemma_9b", True), ("xlstm_1_3b", True),
                    ("xlstm_1_3b", False), ("deepseek_moe_16b", True))
LM_TRAIN_CHECK_BATCH = 2
# the launcher at --smoke on the card for the recurrent and MoE LMs: 20
# steps each, the loss falling
LAUNCHER_ARCHS, LAUNCHER_ARCH_STEPS = ("xlstm_1_3b", "deepseek_moe_16b", "kimi_k2_1t_a32b"), 20
# the launcher at --smoke on the card: to step 10 saving every 5, then resumed to step 20
LAUNCHER_FLAGS = ["--arch", "stablelm_3b", "--smoke", "--device", "cuda", "--corpus-mb", "0.5",
                  "--save-every", "5"]
LAUNCHER_STEPS = (10, 20)
# (b, s, nq, nkv, hd, causal, window) of the flash backward: the training
# shapes, then hd 80 and 256, groups of 1, 4 and 16, lengths on both sides
# of the backward's 32- and 64-key tiles, windows under the sequence,
# forwards that the plan splits over a cluster (lse from the combine), and
# backwards that split a kv group's heads over blocks, one of them over 16
# rounds of partial dQ
FLASH_BWD_CASES = [
    (LM_TRAIN_BATCH, LM_TRAIN_SEQ, 32, 32, 80, True, 0),  # StableLM-3B's training step
    (LM_TRAIN_CHECK_BATCH, 64, 16, 1, 256, True, 2048),  # RecurrentGemma-9B's checked step
    (LM_TRAIN_CHECK_BATCH, 64, 16, 16, 128, True, 0),  # DeepSeek-MoE-16B's checked step
    (1, 1, 32, 32, 80, True, 0),
    (1, 1, 16, 1, 256, True, 2048),
    (3, 63, 16, 1, 256, True, 20),
    (2, 65, 32, 32, 80, True, 0),
    (4, 64, 8, 2, 80, True, 17),
    (5, 64, 16, 16, 256, True, 64),
    (1, 300, 4, 4, 80, True, 0),  # split
    (1, 200, 2, 1, 80, True, 150),  # split, windowed
    (2, 300, 16, 1, 256, True, 100),
    (1, 300, 2, 2, 256, False, 0),  # non-causal, split
    (8, 65, 4, 1, 256, False, 9),  # a non-causal window
    (2, 2048, 16, 1, 256, True, 2048),  # RecurrentGemma-9B at 2048 positions: 16 rounds
]


def held_fp32(got, want, what: str) -> float:
    """fp32 within 2e-5 abs/rel elementwise, or, where sums reorder over
    many terms, within 1e-5 of the tensor's largest element. Returns the
    max abs error."""
    err = (got - want).abs()
    worst = err.max().item() if err.numel() else 0.0
    if not (torch.all(err <= 2e-5 + 2e-5 * want.abs())
            or worst <= 1e-5 * want.abs().max().item()):
        fail(f"{what}: max abs err {worst:.3e} against the plain version (largest element "
             f"{want.abs().max().item():.3e}; tol 2e-5 abs/rel or 1e-5 of the largest)")
    return worst


def fp32_miss(got, want) -> float:
    """How far ``got`` misses ``held_fp32``'s rule against ``want`` (at most
    0 where it meets it): the smaller of the largest elementwise excess over
    2e-5 abs/rel and the largest error's excess over 1e-5 of ``want``'s
    largest element."""
    err = (got.double() - want.double()).abs()
    if not err.numel():
        return 0.0
    elementwise = (err - 2e-5 - 2e-5 * want.double().abs()).max().item()
    return min(elementwise, err.max().item() - 1e-5 * want.double().abs().max().item())


def flash_bwd_inputs(case, gen):
    b, s, nq, nkv, hd = case[:5]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    return rnd(b, s, nq, hd), rnd(b, s, nkv, hd), rnd(b, s, nkv, hd), rnd(b, s, nq, hd)


def check_flash_train_case(case, gen) -> tuple[float, float]:
    """One shape of ``check_flash_bwd``: the training forward against its
    plain version, fp64 and the serving kernel, the backward against its
    plain version, each launched twice and held equal bit for bit, no
    input written. Returns the max abs errors of out and of the gradients."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_train_ref)

    kw = dict(causal=case[5], window=case[6])
    q, k, v, dout = flash_bwd_inputs(case, gen)
    inputs = [t.clone() for t in (q, k, v, dout)]
    out, lse = flash_ops.flash_attention_train(q, k, v, **kw)
    out2, lse2 = flash_ops.flash_attention_train(q, k, v, **kw)
    served = flash_ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_train_ref(q, k, v, **kw)
    exact_out, exact_lse = flash_attention_train_ref(q.double(), k.double(), v.double(), **kw)
    e_out = held_fp32(out, want_out, f"flash_attention_train {case} out")
    held_fp32(lse, want_lse, f"flash_attention_train {case} lse")
    held_fp32(out.double(), exact_out, f"flash_attention_train {case} out against fp64")
    held_fp32(lse.double(), exact_lse, f"flash_attention_train {case} lse against fp64")
    held_fp32(out, served, f"flash_attention_train {case} out against the serving kernel")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"flash_attention_train {case}: two launches differ")
    grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(t, u) for t, u in zip((q, k, v, dout), inputs)):
        fail(f"flash_attention_train or flash_attention_bwd {case} wrote an input")
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    e_grad = max(held_fp32(g, w, f"flash_attention_bwd {case} d{name}")
                 for name, g, w in zip("qkv", grads, want))
    if not all(torch.equal(g, r) for g, r in zip(grads, again)):
        fail(f"flash_attention_bwd {case}: two launches differ")
    return e_out, e_grad


def check_flash_bwd(gen) -> tuple[float, float]:
    """The training forward (``flash_attention_train.cu``) against
    ``flash_attention_train_ref`` (out and lse), against the same algebra
    in fp64 and, for out, against the serving kernel (``held_fp32`` each:
    since the training forward runs on the tensor cores the two kernels
    no longer share their bits); ``flash_attention_bwd`` against
    ``flash_attention_bwd_ref``; each launched twice and the two results
    held equal bit for bit, and no input written. Returns the max abs
    errors of the training forward and of the backward at the training
    shape."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    err_fwd = err_bwd = 0.0
    n_split = n_heads_split = n_rounds = 0
    for case in FLASH_BWD_CASES:
        b, s, nq, nkv, hd, causal, window = case
        kw = dict(causal=causal, window=window)
        n_split += flash_ops.plan(b, s, nq, nkv, q_offset=0, n_keys=s, **kw).split > 1
        n_heads_split += flash_ops.bwd_head_split(b, s, s, nq, nkv, hd) > 1
        tiles = -(-s // flash_ops.bwd_key_tile(hd))
        n_rounds += 0 < flash_ops.bwd_part_tiles(b, s, s, nq, hd) < tiles
        e_out, e_grad = check_flash_train_case(case, gen)
        if case == FLASH_BWD_CASES[0]:
            err_fwd, err_bwd = e_out, e_grad
    if n_split < 2:
        fail(f"flash_attention: only {n_split} of the backward's shapes split the serving "
             f"kernel over a cluster")
    if n_heads_split < 2 or n_rounds < 1:
        fail(f"flash_attention_bwd: {n_heads_split} shapes split a kv group's heads and "
             f"{n_rounds} sum partial dQ in rounds (want 2 and 1)")
    print(f"flash_attention_train and flash_attention_bwd: match plain at "
          f"{len(FLASH_BWD_CASES)} shapes (hd 80, 128 and 256, groups 1-16, seq 1-2048, "
          f"windows under the sequence; tol 2e-5 abs/rel or 1e-5 of the tensor's max), "
          f"{n_split} of them split over a cluster by the serving kernel, {n_heads_split} split "
          f"a kv group's heads in the backward, {n_rounds} sum partial dQ in rounds; the "
          f"forward within the same tolerance of fp64 and of the serving kernel; two launches "
          f"identical bit for bit; no input written")
    return err_fwd, err_bwd


# (b, s, d) of the RG-LRU backward at RecurrentGemma-9B's training shape
RG_TRAIN = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, 4096)


def check_rg_lru_bwd(gen) -> float:
    """``rg_lru_bwd`` against ``rg_lru_bwd_ref`` at the forward's 11 shapes
    and the training shape, with and without h0, with dh and d(last), dh
    alone and d(last) alone (fp32, 1e-5); two launches bit for bit. Returns
    the max abs error at the training shape."""
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru.ref import rg_lru_bwd_ref, rg_lru_ref

    err = 0.0
    cases = RG_SERVED + RG_EDGES + RG_MORE + [RG_TRAIN]
    for case in cases:
        a, b, h0 = rg_inputs(*case, gen)
        dh = torch.randn(*case, generator=gen).cuda()
        dlast = torch.randn(case[0], case[2], generator=gen).cuda()
        for init in (None, h0):
            h, _ = rg_lru_ref(a, b, init)
            for cot in ((dh, dlast), (dh, None), (None, dlast)):
                got = rg_ops.rg_lru_bwd(a, h, init, *cot)
                again = rg_ops.rg_lru_bwd(a, h, init, *cot)
                torch.cuda.synchronize()
                for g, r, w in zip(got, again, rg_lru_bwd_ref(a, h, init, *cot)):
                    if w is None:
                        if g is not None:
                            fail(f"rg_lru_bwd {case}: a dh0 without h0")
                        continue
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
                    if not torch.equal(g, r):
                        fail(f"rg_lru_bwd {case}: two launches differ")
                    if case == RG_TRAIN:
                        err = max(err, (g - w).abs().max().item())
    print(f"rg_lru_bwd: matches plain at {len(cases)} shapes with and without h0, with dh and "
          f"d(last), either alone (tol 1e-5); two launches identical bit for bit")
    return err


# (b, s, H, dh) of the mLSTM backward: xLSTM-1.3B's 4 heads of 512 at a
# decode step, a prompt, one chunk, a chunk and a step, two chunks and a
# ragged third, and three; then narrow heads (the products' ragged column
# tiles), the training step's shape (LM_TRAIN_CHECK_BATCH of seq 64) and a
# head width that is not a multiple of 4 (rows not 16-byte aligned: plain
# loads instead of cp.async)
MLSTM_BWD_SERVED = [(1, s, 4, 512) for s in (1, 7, 64, 65, 130, 200)]
MLSTM_BWD_EDGES = [(2, 65, 2, 16), (1, 130, 4, 64), (3, 1, 2, 64), (2, 7, 4, 16), (2, 64, 4, 512),
                   (1, 70, 3, 30)]
MLSTM_BWD_TIMED = (8, 64, 4, 512)  # batch 8, seq 64: the launcher's training step


def mlstm_grads(args, state, cts, *, fp64: bool = False):
    """The gradients of (q, k, v, i, f, C, n, m) for the cotangents ``cts``
    of (h, C, n, m) (None: not differentiated): through ``mlstm_chunk_op``
    under grad (on the card, ``MLSTMFunction``: the training entry and the
    backward kernel), or with ``fp64`` by autograd of the plain version in
    fp64."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk_op
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref

    dtype = torch.float64 if fp64 else torch.float32
    ins = [t.detach().to(dtype).clone().requires_grad_(True) for t in (*args, *state)]
    with torch.enable_grad():
        out = mlstm_chunk_ref(*ins, dtype=dtype) if fp64 else mlstm_chunk_op(*ins)
        used = [(o, c.to(dtype)) for o, c in zip(out, cts) if c is not None]
        return torch.autograd.grad([o for o, _ in used], ins, [c for _, c in used])


def check_mlstm_bwd(gen) -> tuple[float, float]:
    """``mlstm_chunk_op`` under grad on the card (``MLSTMFunction``): the
    training entry's h, C, n, m and chunk states against
    ``mlstm_chunk_train_ref`` (output 2e-5, state 1e-4 relative and 1e-6
    absolute) with the input C untouched; the backward's eight gradients
    against ``mlstm_chunk_bwd_ref`` on the same saved tensors
    (``held_fp32``; where the kernel misses it, fp64 decides as in
    ``held_to_plain``: the kernel must be no further from the plain
    version's algebra in fp64 than the fp32 plain version), and against
    fp64 autograd of ``mlstm_chunk_ref``
    within 5e-5 of each tensor's largest element (the CPU tests' limit);
    every input gets a gradient; two runs of the backward identical bit for
    bit. The training forward (``mlstm_chunk_train.cu``) is also held to
    its algebra in fp64 at the same tolerances wherever the fp32 plain
    version meets them, launched twice with identical bits, and writes no
    input. From a carried state, with cotangents for h alone (the train
    step's) and for h and the whole returned state. Returns the max abs
    errors of the gradients and of the training entry's h at the served
    shapes."""
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref, mlstm_chunk_train_ref

    bwd_err = fwd_err = 0.0
    worst_fp64 = 0.0
    by_fp64 = []
    names = ("dq", "dk", "dv", "di", "df", "dC", "dn", "dm")
    for case in MLSTM_BWD_SERVED + MLSTM_BWD_EDGES:
        b, s, H, dh = case
        args = mlstm_inputs(b, s, H, dh, gen)
        state = mlstm_state(b, H, dh, gen)
        inputs = [t.clone() for t in (*args, *state)]
        got = mlstm_ops.mlstm_chunk_train(*args, *state)
        again = mlstm_ops.mlstm_chunk_train(*args, *state)
        want = mlstm_chunk_train_ref(*args, *state)
        exact = mlstm_chunk_train_ref(*args, *state, dtype=torch.float64)
        torch.cuda.synchronize()
        if not all(torch.equal(t, u) for t, u in zip((*args, *state), inputs)):
            fail(f"mlstm_chunk_train {case} wrote an input")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"mlstm_chunk_train {case}: two launches differ")
        for name, g, w, x in zip(("h", "C", "n", "m", "C_in", "n_in", "m_in"), got, want, exact):
            tol = (2e-5, 2e-5) if name == "h" else (1e-4, 1e-6)
            held_to_plain(g, w, x, *tol, f"mlstm_chunk_train {case} {name}")
            limit = tol[1] + tol[0] * x.abs()
            over = ((g.double() - x).abs() - limit).max().item()
            over_plain = ((w.double() - x).abs() - limit).max().item()
            if over > max(over_plain, 0.0):
                fail(f"mlstm_chunk_train {case} {name}: misses fp64 by {over:.3e} (rtol "
                     f"{tol[0]}, atol {tol[1]}), the plain version by {max(over_plain, 0.0):.3e}")
        if case in MLSTM_BWD_SERVED:
            fwd_err = max(fwd_err, (got[0] - want[0]).abs().max().item())
        h, c_st, n_st, m_st = got[0], *got[4:]
        dh_out = torch.randn(b, s, H, dh, generator=gen).cuda()
        d_state = (torch.randn(b, H, dh, dh, generator=gen).cuda(),
                   torch.randn(b, H, dh, generator=gen).cuda(), torch.randn(b, H, generator=gen).cuda())
        for label, cts in (("dh", (dh_out, None, None, None)), ("dh+state", (dh_out, *d_state))):
            runs = [mlstm_ops.mlstm_chunk_bwd(*args, c_st, n_st, m_st, h, *cts) for _ in range(2)]
            plain = mlstm_chunk_bwd_ref(*args, c_st, n_st, m_st, h, *cts)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                fail(f"mlstm_chunk_bwd {case} {label}: two launches differ")
            exact = None
            for name, g, w in zip(names, runs[0], plain):
                e = (g - w).abs().max().item()
                if fp32_miss(g, w) > 0:  # fp64 decides, as held_to_plain
                    if exact is None:
                        exact = mlstm_chunk_bwd_ref(*args, c_st, n_st, m_st, h, *cts,
                                                    dtype=torch.float64)
                    x = exact[names.index(name)]
                    miss_k, miss_p = fp32_miss(g, x), fp32_miss(w, x)
                    if miss_k > max(miss_p, 0.0):
                        fail(f"mlstm_chunk_bwd {case} {label} {name}: max abs err {e:.3e} "
                             f"against the plain version (largest element "
                             f"{w.abs().max().item():.3e}; tol 2e-5 abs/rel or 1e-5 of the "
                             f"largest), and misses them against fp64 by {miss_k:.3e}, where "
                             f"the plain version misses by {max(miss_p, 0.0):.3e}")
                    by_fp64.append([list(case), label, name, miss_k, miss_p])
                if case in MLSTM_BWD_SERVED:
                    bwd_err = max(bwd_err, e)
            through = mlstm_grads(args, state, cts)
            exact = mlstm_grads(args, state, cts, fp64=True)
            for name, g, x in zip(names, through, exact):
                scale = x.abs().max().item()
                if g is None or (scale > 0 and g.abs().max().item() == 0):
                    fail(f"mlstm_chunk_op under grad {case} {label}: no gradient for {name}")
                ratio = (g.double() - x).abs().max().item() / max(scale, 1e-30)
                worst_fp64 = max(worst_fp64, ratio)
                if ratio > 5e-5:
                    fail(f"mlstm_chunk_op under grad {case} {label} {name}: {ratio:.3e} of the "
                         f"largest element from fp64 autograd (limit 5e-5)")
    print(f"mlstm_chunk_train: h, C, n, m and the chunk states match plain and fp64 at "
          f"{len(MLSTM_BWD_SERVED + MLSTM_BWD_EDGES)} shapes from a carried state, no input "
          f"written, two launches identical bit for bit; h max abs err {fwd_err:.3e} at the "
          f"served shapes")
    print(f"mlstm_chunk_bwd fp32: 8 gradients match plain (2e-5 abs/rel or 1e-5 of the largest; "
          f"where the kernel misses that, no further from the plain version's algebra in fp64 "
          f"than the plain version: fp64 decided [case, cotangents, gradient, the kernel's miss "
          f"against fp64, the plain version's] {by_fp64}) with cotangents of h and of h and the "
          f"state; max abs err {bwd_err:.3e} at the served shapes; through MLSTMFunction within "
          f"{worst_fp64:.3e} of fp64 autograd (limit 5e-5); two launches identical bit for bit")
    return bwd_err, fwd_err


def mlstm_bwd_work(b, s, H, dh) -> tuple[int, int]:
    """(bytes, operations) of the backward in fp32 with a cotangent of h
    alone, as a train step gives it: q, k, v, h, dh and the gates read,
    each chunk's input C, n and m read once; dq, dk, dv, the gates'
    gradients, dC, dn, dm of the input state written. Per chunk of L steps
    and head, five products of L x dh x dh (q C_in, dC_in, dq, dk, dv),
    five of L(L+1)/2 x dh (the scores q.k and dh.v, dS K, dS^T Q, W^T dnum),
    and dC_out . C_in."""
    n_chunks = -(-s // 64)
    bH = b * H
    n_bytes = 4 * (bH * s * (8 * dh + 4) + n_chunks * bH * (dh * dh + dh + 1)
                   + bH * (dh * dh + dh + 1))
    n_ops = 0
    for c0 in range(0, s, 64):
        L = min(64, s - c0)
        n_ops += bH * (10 * L * dh * dh + 5 * L * (L + 1) * dh + 2 * dh * dh)
    return n_bytes, n_ops


def time_mlstm_bwd(gen, bw: float, flops: float) -> dict:
    """The backward and the training entry at ``MLSTM_BWD_TIMED``, both
    timers, beside their plain versions and bounds. No single PyTorch call
    computes either."""
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref, mlstm_chunk_train_ref

    b, s, H, dh = MLSTM_BWD_TIMED
    args = mlstm_inputs(b, s, H, dh, gen)
    state = mlstm_state(b, H, dh, gen)
    h, _, _, _, c_st, n_st, m_st = mlstm_ops.mlstm_chunk_train(*args, *state)
    dout = torch.randn(b, s, H, dh, generator=gen).cuda()
    saved = (*args, c_st, n_st, m_st, h, dout, None, None, None)
    n_bytes, n_ops = mlstm_bwd_work(b, s, H, dh)
    f_bytes, f_ops = mlstm_work(b, s, H, dh)
    f_bytes += 4 * b * H * (dh * dh + dh + 1) * -(-s // 64)  # the chunk states written
    row = {"ms": device_ms(lambda: mlstm_ops.mlstm_chunk_bwd(*saved)),
           "ms_burst": device_ms_burst(lambda: mlstm_ops.mlstm_chunk_bwd(*saved)),
           "plain_ms": device_ms(lambda: mlstm_chunk_bwd_ref(*saved)),
           "library_ms": None, "library": "none: no single PyTorch call",
           "bound_ms": max(n_bytes / bw, n_ops / flops) * 1e3,
           "bound_by": "bytes" if n_bytes / bw >= n_ops / flops else "operations",
           "bytes": n_bytes, "operations": n_ops,
           "train_forward_ms": device_ms(lambda: mlstm_ops.mlstm_chunk_train(*args, *state)),
           "train_forward_ms_burst": device_ms_burst(
               lambda: mlstm_ops.mlstm_chunk_train(*args, *state)),
           "train_forward_plain_ms": device_ms(lambda: mlstm_chunk_train_ref(*args, *state)),
           "train_forward_bound_ms": max(f_bytes / bw, f_ops / flops) * 1e3,
           "train_forward_bound_by": "bytes" if f_bytes / bw >= f_ops / flops else "operations",
           "shape": list(MLSTM_BWD_TIMED)}
    print(f"mlstm_chunk_bwd fp32 {MLSTM_BWD_TIMED}: {json.dumps(row)}")
    return row


def time_flash_bwd(gen, bw: float, flops: float) -> dict:
    """The backward and the training entry at StableLM-3B's training shape."""
    return time_flash_train(FLASH_BWD_CASES[0], gen, bw, flops)


def heads_of_queries(t: torch.Tensor, group: int) -> torch.Tensor:
    """(b, heads, s, hd) with each head repeated ``group`` times in place,
    as query head h reads kv head h // group: a grouped kv for
    ``scaled_dot_product_attention``, made once outside a timed call (its
    ``enable_gqa`` repeats the heads inside each call, through a host sync)."""
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def time_flash_train(case, gen, bw: float, flops: float) -> dict:
    """The backward and the training entry at ``case`` (no window), both
    timers, beside their plain versions and bounds; the yardstick is
    ``scaled_dot_product_attention``'s forward and backward over the kv
    heads repeated to the query heads beforehand (the port never calls it;
    for a group its dk and dv are per query head, not yet summed), beside
    the kernels' forward and backward together."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_train_ref)

    b, s, nq, nkv, hd, causal = case[:6]
    q, k, v, dout = flash_bwd_inputs(case, gen)
    out, lse = flash_ops.flash_attention_train(q, k, v, causal=causal)
    group = nq // nkv
    qt, kt, vt = (heads_of_queries(t.transpose(1, 2), 1 if t is q else group)
                  .detach().requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return torch.autograd.grad(o, (qt, kt, vt), dt)

    def library_forward():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    for g, w in zip(library(), flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)):
        if g.shape[1] != w.shape[2]:  # a kv head's gradient sums its group's
            g = g.unflatten(1, (w.shape[2], group)).sum(2)
        torch.testing.assert_close(g.transpose(1, 2), w, rtol=1e-4, atol=1e-4)
    pairs = b * nq * (s * (s + 1) // 2 if causal else s * s)  # visible (query, key) pairs
    q_elems, kv_elems = b * s * nq * hd, b * s * nkv * hd
    # backward: q, k, v, out, dout and lse read, dq, dk, dv written; 5
    # products over the pairs (S again, dP, dV, dQ, dK)
    bwd_bytes = 4 * (4 * q_elems + 4 * kv_elems + b * nq * s)
    bwd_ops = 5 * 2 * hd * pairs
    # training forward: q, k, v read, out and lse written; q.k and p.v
    fwd_bytes = 4 * (2 * q_elems + 2 * kv_elems + b * nq * s)
    fwd_ops = 2 * 2 * hd * pairs

    def bound(n_bytes, n_ops):
        return max(n_bytes / bw, n_ops / flops) * 1e3, \
            "bytes" if n_bytes / bw >= n_ops / flops else "operations"

    def bwd():
        return flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)

    def fwd():
        return flash_ops.flash_attention_train(q, k, v, causal=causal)

    bwd_bound, bwd_by = bound(bwd_bytes, bwd_ops)
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_ops)
    ms, ms_burst = device_ms_pair(bwd)
    library_ms, library_ms_burst = device_ms_pair(library)
    library_forward_ms, library_forward_ms_burst = device_ms_pair(library_forward)
    fwd_ms, fwd_ms_burst = device_ms_pair(fwd)
    row = {"ms": ms, "ms_burst": ms_burst,
           "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                 causal=causal)),
           "library_ms": library_ms, "library_ms_burst": library_ms_burst,
           "library": "scaled_dot_product_attention forward + backward",
           "library_forward_ms": library_forward_ms,
           "library_forward_ms_burst": library_forward_ms_burst,
           "bound_ms": bwd_bound, "bound_by": bwd_by, "bytes": bwd_bytes, "operations": bwd_ops,
           "train_forward_ms": fwd_ms, "train_forward_ms_burst": fwd_ms_burst,
           "train_forward_plain_ms": device_ms(lambda: flash_attention_train_ref(q, k, v,
                                                                                causal=causal)),
           "train_forward_bound_ms": fwd_bound, "train_forward_bound_by": fwd_by,
           "shape": list(case)}
    row["forward_and_backward_ms"] = row["ms"] + row["train_forward_ms"]
    print(f"flash_attention_bwd fp32 {case}: {json.dumps(row)}")
    return row


def time_rg_lru_bwd(gen, bw: float, flops: float) -> dict:
    """The backward at RecurrentGemma-9B's training shape (dh given, no h0
    and no d(last), as ``rglru_scan`` trains), both timers, beside its plain
    version and bound. No single PyTorch call computes it."""
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru.ref import rg_lru_bwd_ref, rg_lru_ref

    b_, s, d = RG_TRAIN
    a, b, _ = rg_inputs(b_, s, d, gen)
    h, _ = rg_lru_ref(a, b)
    dh = torch.randn(b_, s, d, generator=gen).cuda()
    n_bytes, n_ops = 4 * 5 * b_ * s * d, 3 * b_ * s * d  # a, h, dh read; da, db written
    row = {"ms": device_ms(lambda: rg_ops.rg_lru_bwd(a, h, None, dh, None)),
           "ms_burst": device_ms_burst(lambda: rg_ops.rg_lru_bwd(a, h, None, dh, None)),
           "plain_ms": device_ms(lambda: rg_lru_bwd_ref(a, h, None, dh, None)),
           "library_ms": None,
           "bound_ms": max(n_bytes / bw, n_ops / flops) * 1e3,
           "bound_by": "bytes" if n_bytes / bw >= n_ops / flops else "operations",
           "shape": list(RG_TRAIN)}
    print(f"rg_lru_bwd fp32 {RG_TRAIN}: {json.dumps(row)}")
    return row


def lm_train_counters() -> dict[str, dict]:
    """The launch counters the LM's train step reaches, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops

    return {"flash_attention": flash_ops.LAUNCHES, "flash_attention_bwd": flash_ops.LAUNCHES,
            "rg_lru": rg_ops.LAUNCHES, "rg_lru_bwd": rg_ops.LAUNCHES,
            "mlstm_chunk": mlstm_ops.LAUNCHES, "mlstm_chunk_bwd": mlstm_ops.LAUNCHES}


def zero_counters(counters: dict[str, dict]) -> None:
    for name, counter in counters.items():
        counter[name] = 0


def step_launches(kinds, steps: int, remat: bool = True) -> dict[str, int]:
    """Each layer kind's forward kernel launches 1 + remat times a step
    (the forward, then its recompute in the backward) and its backward
    kernel once."""
    n = {"flash_attention": kinds.count("attn"), "rg_lru": kinds.count("rglru"),
         "mlstm_chunk": kinds.count("mlstm")}
    out = {}
    for name, layers in n.items():
        out[name] = layers * (1 + remat) * steps
        out[f"{name}_bwd"] = layers * steps
    return out


@contextlib.contextmanager
def recorded_routes():
    """Every expert id ``models.moe._route`` picks while inside, in call
    order (a list of CPU tensors)."""
    from unittest import mock

    from repro_torch.models import moe

    ids, route = [], moe._route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        ids.append(out[0].detach().cpu())
        return out

    with mock.patch.object(moe, "_route", recording):
        yield ids


def lm_step_card_vs_cpu(arch: str, remat: bool = True) -> dict:
    """One ``value_and_grad`` of ``LM.loss`` at ``arch``'s width cut to
    ``CARD_VS_CPU_LAYERS`` layers, ``init_scale=1``, the same weights and
    batch on the card and on the CPU: the loss at 1e-5 rel, every
    gradient present, non-zero and within 1e-4 of its tensor's largest
    element; the card's launches exact; a MoE model's expert ids equal on
    both, call by call."""
    from repro_torch.configs import get
    from repro_torch.models.lm import LM
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    small = dataclasses.replace(get(arch), n_layers=CARD_VS_CPU_LAYERS[arch], init_scale=1.0)
    card = LM(small, "cuda", seed=SEED, remat=remat)
    cpu = LM(small, "meta", remat=remat)
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        4, small.vocab_size, size=(LM_TRAIN_CHECK_BATCH, LM_TRAIN_SEQ)).astype(np.int32))
    counters = lm_train_counters()
    zero_counters(counters)
    with recorded_routes() as routes_card:
        loss_card, grads_card = value_and_grad(functional_loss(card))(params_of(card),
                                                                      {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    launches = {name: counter[name] for name, counter in counters.items()}
    grads_card = {k: g.cpu() for k, g in grads_card.items()}
    traced = None
    if small.moe is not None:  # one more step traced for the card's idle share
        from repro_torch.launch.serve import profile

        traced = profile(lambda: value_and_grad(functional_loss(card))(
            params_of(card), {"tokens": tokens.cuda()}), torch.device("cuda"),
            torch.cuda.synchronize, f"one {small.name} train step at {small.n_layers} layers")
    del card
    torch.cuda.empty_cache()
    with recorded_routes() as routes_cpu:
        loss_cpu, grads_cpu = value_and_grad(functional_loss(cpu))(params_of(cpu),
                                                                   {"tokens": tokens})
    want = step_launches(cpu.kinds, 1, remat)
    if launches != want:
        fail(f"{small.name} card step (remat {remat}): launches {launches}, expected {want}")
    if len(routes_card) != len(routes_cpu) or not all(
            torch.equal(a, b) for a, b in zip(routes_card, routes_cpu)):
        fail(f"{small.name} train step: the expert ids differ between the card and the CPU")
    if small.moe is not None and not routes_card:
        fail(f"{small.name} train step routed no token")
    lc, lp = loss_card.item(), loss_cpu.item()
    if not np.isfinite(lc) or abs(lc - lp) > 1e-5 * abs(lp):
        fail(f"{small.name} train step loss card {lc} vs CPU {lp} (rtol 1e-5)")
    worst = held_grads(small.name, grads_card, grads_cpu)
    print(f"{small.name} with {small.n_layers} layers at init_scale 1, remat {remat}, one train "
          f"step card vs CPU (batch {tuple(tokens.shape)}): loss {lc:.6f} vs {lp:.6f}; all "
          f"{len(grads_cpu)} gradients present and non-zero, worst max|dg|/max|g| {worst:.3e} "
          f"(limit 1e-4); {len(routes_card)} routings with equal expert ids; launches {launches}")
    return {"arch": small.name, "label": f"{small.name}{'' if remat else ' no remat'}",
            "layers": small.n_layers, "remat": remat, "loss_card": lc, "loss_cpu": lp,
            "grad_tensors": len(grads_cpu), "grad_worst_rel": worst,
            "routings_equal": len(routes_card), "launches": launches, "traced_step": traced}


def held_grads(name: str, grads_card: dict, grads_cpu: dict, unreached=frozenset(),
               summed=None) -> float:
    """Every gradient present on the card, non-zero and within 1e-4 of its
    CPU tensor's largest element; the parameters in ``unreached``, which the
    loss does not reach (the audio frontend's token embedding), exactly zero
    on both. A parameter in ``summed`` (bias path -> weight path) is held
    within 1e-4 of the larger of its own gradient's largest element and its
    weight's: its gradient sums over every token cotangents that nearly
    cancel (the key bias's, by the softmax's shift invariance), so its own
    largest element understates the terms that fp32 rounds. Card tensors
    come to the host one at a time. Returns the worst max|dg|/scale."""
    if set(grads_card) != set(grads_cpu):
        fail(f"{name} train step: the card and the CPU give gradients of other parameters")
    summed = summed or {}
    worst = 0.0
    for path, w in grads_cpu.items():
        g = grads_card[path].cpu()
        if path in unreached:
            if g.any() or w.any():
                fail(f"{name} train step: {path}, which the loss does not reach, has a gradient")
            continue
        scale = w.abs().max().item()
        if g.abs().max().item() == 0 or scale == 0:
            fail(f"{name} train step: the gradient of {path} is zero on the card")
        if path in summed:
            terms = grads_cpu[summed[path]].abs().max().item()
            print(f"  {path}: max|dg| {(g - w).abs().max().item():.3e}, max|g| {scale:.3e}, "
                  f"max|g| of {summed[path]} {terms:.3e}")
            scale = max(scale, terms)
        ratio = (g - w).abs().max().item() / scale
        worst = max(worst, ratio)
        if ratio > 1e-4:
            fail(f"{name} train step: {path}'s gradient differs from the CPU's by "
                 f"{ratio:.3e} of its largest element (limit 1e-4)")
    return worst


def lm_train_steps() -> dict:
    """``LM_TRAIN_STEPS`` steps of ``make_train_step`` over ``LM.loss`` with
    AdamW (``warmup_cosine``, the launcher's schedule) at StableLM-3B's full
    width and ``LM_TRAIN_LAYERS`` layers, on rows from the launcher's
    ``build_dataset`` built on the card; exact ``text_scan``, flash forward
    and backward launches, finite losses that fall; seconds a step,
    tokens/s, peak memory, and one more step traced for the card's idle
    share."""
    from repro_torch.configs import get
    from repro_torch.kernels.text_clean import ops as clean_ops
    from repro_torch.launch.serve import profile
    from repro_torch.launch.train import build_dataset
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.train_loop import functional_loss, make_train_step, params_of

    cfg = dataclasses.replace(get(LM_TRAIN_ARCH), n_layers=LM_TRAIN_LAYERS)
    clean_ops.LAUNCHES["text_scan"] = 0
    t0 = time.perf_counter()
    seqs = build_dataset(cfg, LM_TRAIN_SEQ, LM_TRAIN_CORPUS_MB, seed=SEED, device="cuda")
    dataset_seconds = time.perf_counter() - t0
    scans = clean_ops.LAUNCHES["text_scan"]
    if scans != P3SAPP_SCANS[True]:
        fail(f"build_dataset made {scans} text_scan launches, expected {P3SAPP_SCANS[True]} (one "
             f"fused scan a column; fit_vocab reuses the frame)")
    model = LM(cfg, "cuda", seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(LM_TRAIN_LR, 10, LM_TRAIN_STEPS))
    step = make_train_step(functional_loss(model), opt)
    params = params_of(model)
    state = opt.init(params)
    rng = np.random.default_rng(SEED)

    def next_batch():
        idx = rng.integers(0, len(seqs), size=LM_TRAIN_BATCH)
        return {"tokens": torch.from_numpy(seqs[idx]).cuda()}

    warm = {"tokens": torch.from_numpy(seqs[:LM_TRAIN_BATCH]).cuda()}
    step(params, state, warm)  # warm-up: cuBLAS handles, the allocator; its result is dropped
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = lm_train_counters()
    zero_counters(counters)
    losses, t0 = [], time.perf_counter()
    for _ in range(LM_TRAIN_STEPS):
        params, state, metrics = step(params, state, next_batch())
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: counter[name] for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = step_launches(model.kinds, LM_TRAIN_STEPS)
    if launches != want:
        fail(f"the LM train steps made launches {launches}, expected {want} (layers x (1 + "
             f"remat) forward, layers backward, a step)")
    if not np.isfinite(losses).all():
        fail(f"a non-finite LM training loss: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"the LM loss did not fall over {LM_TRAIN_STEPS} steps: {losses}")
    traced = profile(lambda: step(params, state, next_batch()), torch.device("cuda"),
                     torch.cuda.synchronize, f"one {cfg.name} train step at {LM_TRAIN_LAYERS} "
                     f"layers")
    donated_equal = donating_step_is_functional(model, opt, params, state, warm)
    n_tokens = LM_TRAIN_STEPS * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"LM train: {cfg.name} at full width, {LM_TRAIN_LAYERS} of {get(LM_TRAIN_ARCH).n_layers} "
          f"layers ({model.param_count()} parameters), {LM_TRAIN_STEPS} steps of "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in {seconds:.3f} s ({seconds / LM_TRAIN_STEPS * 1e3:.1f} "
          f"ms a step, {n_tokens / seconds:.0f} tokens/s); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak memory {peak / 1e9:.2f} GB; launches {launches}; "
          f"{len(seqs)} rows from build_dataset in {dataset_seconds:.2f} s ({scans} text_scan)")
    line = {"arch": cfg.name, "layers": LM_TRAIN_LAYERS, "params": model.param_count(),
            "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "steps": LM_TRAIN_STEPS,
            "seconds": seconds, "seconds_per_step": seconds / LM_TRAIN_STEPS,
            "tokens_per_s": n_tokens / seconds, "peak_memory_bytes": peak,
            "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "launches": launches, "rows": len(seqs), "build_dataset_seconds": dataset_seconds,
            "build_dataset_text_scan_launches": scans, "traced_step": traced,
            "donating_step_bit_equal": donated_equal}
    del model, params, state
    torch.cuda.empty_cache()
    return line, seqs


def donating_step_is_functional(model, opt, params, state, batch) -> dict:
    """The launcher's donating step (``train_step_of``: AdamW written in
    place) against the functional ``make_train_step``, one step each on
    ``batch``: ``AdamW.update_`` on copies against ``update`` with the same
    gradients, and, where two backward passes give the same gradients bit
    for bit, one whole donating step on copies against one functional step
    from the originals (loss, norm, params, moments and count). The
    donating step must return the tensors it was given. Returns the
    counts of tensors compared."""
    from repro_torch.checkpoint.tree import flatten_with_paths, map_with_paths
    from repro_torch.launch.train import train_step_of
    from repro_torch.runtime.train_loop import functional_loss, make_train_step, value_and_grad

    def copies():
        return map_with_paths(lambda _, t: t.clone(), (params, state))

    def held(got, want, what):
        n = 0
        for (path, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(want),
                                     strict=True):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"{what}: {path} differs (max abs "
                     f"{(a.double() - b.double()).abs().max().item():.3e})")
            n += 1
        return n

    grads_of = value_and_grad(functional_loss(model))
    _, grads = grads_of(params, batch)
    _, again = grads_of(params, batch)
    reproducible = all(torch.equal(grads[k], again[k]) for k in grads)
    del again
    want_params, want_state, want_norm = opt.update(grads, state, params)
    got_params, got_state = copies()
    got_norm = opt.update_({k: g.clone() for k, g in grads.items()}, got_state, got_params)
    torch.cuda.synchronize()
    if not torch.equal(got_norm, want_norm):
        fail("AdamW.update_ gives another grad norm than update")
    n_update = held((got_params, got_state), (want_params, want_state),
                    "AdamW.update_ against update on the same gradients")
    del grads, want_params, want_state, got_params, got_state
    n_step = 0
    if reproducible:
        want_params, want_state, want = make_train_step(functional_loss(model), opt)(
            params, state, batch)
        got_params, got_state = copies()
        ptrs = [t.data_ptr() for _, t in flatten_with_paths((got_params, got_state))]
        new_params, new_state, got = train_step_of(model, opt)(got_params, got_state, batch)
        torch.cuda.synchronize()
        if new_params is not got_params or new_state is not got_state or ptrs != [
                t.data_ptr() for _, t in flatten_with_paths((new_params, new_state))]:
            fail("the donating step did not write into the tensors it was given")
        for key in ("loss", "grad_norm"):
            if not torch.equal(got[key], want[key]):
                fail(f"the donating step's {key} {got[key].item()!r} differs from the "
                     f"functional step's {want[key].item()!r}")
        n_step = held((got_params, got_state), (want_params, want_state),
                      "one donating step against one functional step")
    print(f"LM train: AdamW.update_ equals update bit for bit on the same gradients ({n_update} "
          f"tensors: params, moments and count); two backward passes "
          f"{'agree' if reproducible else 'DIFFER'} bit for bit, so "
          + (f"one donating step equals one functional step bit for bit ({n_step} tensors, "
             f"loss and grad norm)" if reproducible else
             "whole steps cannot be compared bit for bit"))
    return {"update_tensors_bit_equal": n_update, "gradients_reproducible": reproducible,
            "step_tensors_bit_equal": n_step}


def lm_train_full_depth(seqs) -> dict:
    """StableLM-3B at its full width and all 32 layers, ``FULL_DEPTH_STEPS``
    steps of the launcher's donating step (``train_step_of``) on batches of
    ``build_dataset``'s rows: exact flash launches, finite losses that
    fall; seconds a step, tokens/s, the peak of
    ``torch.cuda.max_memory_allocated()``, and one more step traced for the
    card's idle share."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import profile
    from repro_torch.launch.train import train_step_of
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.train_loop import params_of

    cfg = get(LM_TRAIN_ARCH)
    t0 = time.perf_counter()
    model = LM(cfg, "cuda", seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(FULL_DEPTH_LR, FULL_DEPTH_WARMUP, FULL_DEPTH_STEPS))
    step = train_step_of(model, opt)
    params = params_of(model)
    state = opt.init(params)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 7)

    def next_batch():
        idx = rng.integers(0, len(seqs), size=LM_TRAIN_BATCH)
        return {"tokens": torch.from_numpy(seqs[idx]).cuda()}

    torch.cuda.reset_peak_memory_stats()
    counters = lm_train_counters()
    zero_counters(counters)
    losses, step_seconds = [], []
    for _ in range(FULL_DEPTH_STEPS):
        batch = next_batch()
        t1 = time.perf_counter()
        _, _, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        step_seconds.append(time.perf_counter() - t1)
    launches = {name: counter[name] for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = step_launches(model.kinds, FULL_DEPTH_STEPS)
    if launches != want:
        fail(f"StableLM-3B at full depth made launches {launches}, expected {want}")
    if not np.isfinite(losses).all():
        fail(f"a non-finite loss at full depth: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"the full-depth loss did not fall over {FULL_DEPTH_STEPS} steps: {losses}")
    traced = profile(lambda: step(params, state, next_batch()), torch.device("cuda"),
                     torch.cuda.synchronize, f"one {cfg.name} train step at all "
                     f"{cfg.n_layers} layers")
    seconds = sum(step_seconds)
    steady = statistics.median(step_seconds[1:])
    n_tokens = FULL_DEPTH_STEPS * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"LM train at full depth: {cfg.name}, all {cfg.n_layers} layers "
          f"({model.param_count()} parameters, built with its AdamW state in {built:.1f} s), "
          f"{FULL_DEPTH_STEPS} donating steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in "
          f"{seconds:.3f} s (median after the first {steady * 1e3:.1f} ms a step, "
          f"{n_tokens / seconds:.0f} tokens/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
          f"memory {peak / 1e9:.2f} GB; launches {launches}")
    line = {"arch": cfg.name, "layers": cfg.n_layers, "params": model.param_count(),
            "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "steps": FULL_DEPTH_STEPS,
            "lr": FULL_DEPTH_LR, "seconds": seconds, "step_seconds": step_seconds,
            "seconds_per_step": seconds / FULL_DEPTH_STEPS, "median_step_seconds": steady,
            "tokens_per_s": n_tokens / seconds, "peak_memory_bytes": peak, "losses": losses,
            "launches": launches, "traced_step": traced, "build_seconds": built}
    del model, params, state, step
    torch.cuda.empty_cache()
    return line


def lm_train_launcher() -> dict:
    """``repro_torch.launch.train.main`` at ``--smoke`` on the card, twice
    on one ``--ckpt``: to step 10, then resumed to step 20. The second run
    must print ``resumed from step 10`` and start from the state the first
    saved, bit for bit; each run's ``text_scan`` and flash launches exact;
    every loss finite."""
    import contextlib
    import io
    import tempfile
    from unittest import mock

    from repro_torch.checkpoint.tree import flatten_with_paths, map_with_paths
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.text_clean import ops as clean_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm import layer_kinds

    controllers = []

    class Recording(launch_train.TrainController):
        """The launcher's controller, keeping a copy of its starting state."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.start = map_with_paths(lambda _, t: t.clone(), (self.params, self.opt_state))
            controllers.append(self)

    counters = {"text_scan": clean_ops.LAUNCHES, **lm_train_counters()}
    kinds = layer_kinds(get_smoke("stablelm_3b"))
    runs = []
    with tempfile.TemporaryDirectory() as ckpt:
        done = 0
        for steps in LAUNCHER_STEPS:
            zero_counters(counters)
            out = io.StringIO()
            t0 = time.perf_counter()
            with mock.patch.object(launch_train, "TrainController", Recording), \
                    contextlib.redirect_stdout(out):
                history = launch_train.main(LAUNCHER_FLAGS + ["--ckpt", ckpt, "--steps",
                                                              str(steps)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {name: counter[name] for name, counter in counters.items()}
            text = out.getvalue()
            print("  " + text.strip().replace("\n", "\n  "))
            want = {"text_scan": P3SAPP_SCANS[True], **step_launches(kinds, steps - done)}
            if launches != want:
                fail(f"the launcher to step {steps} made launches {launches}, expected {want}")
            if [h["step"] for h in history] != list(range(done + 1, steps + 1)):
                fail(f"the launcher to step {steps} ran steps {[h['step'] for h in history]}")
            if not all(np.isfinite(h["loss"]) for h in history):
                fail(f"a non-finite loss in the launcher's run to step {steps}")
            resumed = f"resumed from step {done}" in text
            if resumed != bool(done):
                fail(f"the launcher's run to step {steps} printed {text!r}")
            runs.append({"steps": steps, "seconds": seconds, "launches": launches,
                         "losses": [h["loss"] for h in history], "resumed": resumed})
            done = steps
    first, second = controllers
    for (path, got), (_, saved) in zip(flatten_with_paths(second.start),
                                       flatten_with_paths((first.params, first.opt_state)),
                                       strict=True):
        if got.dtype != saved.dtype or not torch.equal(got, saved):
            fail(f"the resumed launcher's {path} differs from the state saved at step "
                 f"{LAUNCHER_STEPS[0]}")
    print(f"launcher: --smoke on the card to step {LAUNCHER_STEPS[0]}, then resumed from it to "
          f"step {LAUNCHER_STEPS[1]} with params, moments and count equal bit for bit to those "
          f"saved; launches {[r['launches'] for r in runs]}")
    return {"runs": runs, "restored_bit_equal": True}


def lm_train_launcher_archs() -> list[dict]:
    """``repro_torch.launch.train.main`` at ``--smoke`` on the card for each
    of ``LAUNCHER_ARCHS``, ``LAUNCHER_ARCH_STEPS`` steps: exact
    ``text_scan``, flash and mLSTM launches (forward and backward), finite
    losses whose last five average below the first five."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.text_clean import ops as clean_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm import layer_kinds

    counters = {"text_scan": clean_ops.LAUNCHES, **lm_train_counters()}
    runs = []
    for arch in LAUNCHER_ARCHS:
        with tempfile.TemporaryDirectory() as ckpt:
            zero_counters(counters)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                history = launch_train.main(
                    ["--arch", arch, "--smoke", "--device", "cuda", "--corpus-mb", "0.5",
                     "--steps", str(LAUNCHER_ARCH_STEPS), "--ckpt", ckpt])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = {name: counter[name] for name, counter in counters.items()}
        want = {"text_scan": P3SAPP_SCANS[True],
                **step_launches(layer_kinds(get_smoke(arch)), LAUNCHER_ARCH_STEPS)}
        if launches != want:
            fail(f"the launcher for {arch} made launches {launches}, expected {want}")
        losses = [h["loss"] for h in history]
        if len(losses) != LAUNCHER_ARCH_STEPS or not np.isfinite(losses).all():
            fail(f"the launcher for {arch} gave losses {losses}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            fail(f"the launcher's loss for {arch} did not fall: {losses}")
        print(f"launcher --arch {arch} --smoke on the card: {LAUNCHER_ARCH_STEPS} steps in "
              f"{seconds:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}")
        runs.append({"arch": arch, "steps": LAUNCHER_ARCH_STEPS, "seconds": seconds,
                     "losses": losses, "launches": launches})
    return runs


def lm_train(bw: float, flops: float) -> tuple[dict, dict]:
    """The lm_train phase; returns its line and the new kernels' rows."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 2)  # the earlier checks' draws unchanged
    fwd_err, bwd_err = check_flash_bwd(gen)
    rg_err = check_rg_lru_bwd(gen)
    mlstm_gen = torch.Generator().manual_seed(SEED + 4)  # the draws above unchanged
    mlstm_bwd_err, mlstm_fwd_err = check_mlstm_bwd(mlstm_gen)
    rows = {"flash_attention_bwd": {**time_flash_bwd(gen, bw, flops), "max_abs_err": bwd_err,
                                    "train_forward_max_abs_err": fwd_err},
            "rg_lru_bwd": {**time_rg_lru_bwd(gen, bw, flops), "max_abs_err": rg_err},
            "mlstm_chunk_bwd": {**time_mlstm_bwd(mlstm_gen, bw, flops),
                                "max_abs_err": mlstm_bwd_err,
                                "train_forward_max_abs_err": mlstm_fwd_err}}
    torch.cuda.empty_cache()
    checked = []
    for arch, remat in LM_TRAIN_CHECKED:
        checked.append(lm_step_card_vs_cpu(arch, remat))
        torch.cuda.empty_cache()
    steps_line, seqs = lm_train_steps()
    line = {"card_vs_cpu": checked, **steps_line, "full_depth": lm_train_full_depth(seqs),
            "launcher": lm_train_launcher(), "launcher_archs": lm_train_launcher_archs()}
    line["phase_seconds"] = time.perf_counter() - t0
    print(f"lm_train phase: {line['phase_seconds']:.1f} s")
    return line, rows


# The frontends phase: the LM family's two configurations with a frontend.
# HuBERT X-Large's attention: 16 query and kv heads of 80, non-causal, over
# 8 x 512 frames; Qwen2-VL-72B's: 64 query heads over 8 kv heads of 128
# (groups of 8), causal, a block prefill and decode steps into the 128-long
# cache. (b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len)
HUBERT_BATCH, HUBERT_FRAMES = 8, 512
FLASH_SERVED_FRONTENDS = (
    [(HUBERT_BATCH, HUBERT_FRAMES, HUBERT_FRAMES, 16, 16, 80, False, 0, 0, None)]
    + [(1, sq, LM_MAX_SEQ, 64, 8, 128, True, 0, 0, sq) for sq in (4, 9, 16)]
    + [(1, 1, LM_MAX_SEQ, 64, 8, 128, True, 0, pos, pos + 1) for pos in (0, 4, 15, 77, 126)]
)
# (b, s, nq, nkv, hd, causal, window) of their training passes: HuBERT X-Large's
# step and Qwen2-VL-72B's checked step
FLASH_BWD_FRONTENDS = [
    (HUBERT_BATCH, HUBERT_FRAMES, 16, 16, 80, False, 0),
    (LM_TRAIN_CHECK_BATCH, LM_TRAIN_SEQ, 64, 8, 128, True, 0),
]
FLASH_TIMED_FRONTENDS = {"serve_hubert": FLASH_SERVED_FRONTENDS[0],
                         "prefill_qwen2_vl": FLASH_SERVED_FRONTENDS[2],
                         "decode_qwen2_vl": FLASH_SERVED_FRONTENDS[6]}
FRONTEND_ARCHS = ("hubert_xlarge", "qwen2_vl_72b")
# HuBERT X-Large at all 48 layers: a no-grad forward over 8 x 512 frames,
# then HUBERT_STEPS steps of make_train_step (donating) cycling through a
# pool of HUBERT_POOL seeded frame batches whose labels are the frames'
# nearest of 504 seeded centroids (k-means ids, as HuBERT's targets are)
HUBERT_STEPS, HUBERT_POOL, HUBERT_LR, HUBERT_WARMUP = 20, 4, 3e-4, 5
# full-width layers of the card-vs-CPU check: Qwen2-VL-72B's one is 13.5 GB of
# parameters in fp32 (3.51 GB a layer, 4.98 GB each for the embedding and
# the untied head), and the CPU holds them and their gradients; every one of
# its layers is of one kind (cut from two to keep the phases under 800 s)
FRONTEND_CHECK_LAYERS = {"hubert_xlarge": 2, "qwen2_vl_72b": 1}


def check_flash_frontends(gen) -> dict:
    """The serving kernel at the two configurations' shapes against its
    plain version in fp32 (2e-5) and bf16 (2e-2), launched twice and held
    equal bit for bit; the training forward and backward at their training
    shapes as ``check_flash_bwd`` holds them. Returns the fp32 max abs
    errors."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    err = {"serve": 0.0, "train_forward": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case in FLASH_SERVED_FRONTENDS:
            q, k, v = flash_inputs(case, dtype, gen)
            got = flash_attention_op(q, k, v, **flash_kwargs(case))
            again = flash_attention_op(q, k, v, **flash_kwargs(case))
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **flash_kwargs(case))
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if not torch.equal(got, again):
                fail(f"flash_attention {dtype} {case}: two launches differ")
            if dtype == torch.float32:
                err["serve"] = max(err["serve"], (got - want).abs().max().item())
    for case in FLASH_BWD_FRONTENDS:
        e_out, e_grad = check_flash_train_case(case, gen)
        err["train_forward"] = max(err["train_forward"], e_out)
        err["bwd"] = max(err["bwd"], e_grad)
    print(f"flash_attention at HuBERT X-Large's and Qwen2-VL-72B's shapes: the serving kernel "
          f"matches plain at {len(FLASH_SERVED_FRONTENDS)} shapes in fp32 (2e-5) and bf16 "
          f"(2e-2), the training forward and backward at {len(FLASH_BWD_FRONTENDS)} (non-causal "
          f"hd 80 over 512 keys; 64 query heads over 8 kv heads of 128); two launches identical "
          f"bit for bit; fp32 max abs errors {err}")
    return err


def flash_mask(case) -> torch.Tensor:
    """The (sq, skv) boolean mask of a serving case, on the card."""
    sq, skv, causal, window, q_offset, kv_len = (case[i] for i in (1, 2, 6, 7, 8, 9))
    q_pos = torch.arange(sq, device="cuda")[:, None] + q_offset
    k_pos = torch.arange(skv, device="cuda")[None, :]
    mask = k_pos < (kv_len or skv)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def time_flash_frontends(gen, bw: float, flops: float) -> dict:
    """The serving kernel at ``FLASH_TIMED_FRONTENDS`` and the training
    forward and backward at ``FLASH_BWD_FRONTENDS``, fp32, both timers,
    beside the plain versions, the bounds and
    ``scaled_dot_product_attention`` on the same inputs (kv heads repeated
    to the query heads beforehand; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rows = {}
    for label, case in FLASH_TIMED_FRONTENDS.items():
        q, k, v = flash_inputs(case, torch.float32, gen)
        kw = flash_kwargs(case)
        qt = q.transpose(1, 2)
        kt, vt = (heads_of_queries(t.transpose(1, 2), case[3] // case[4]) for t in (k, v))
        mask = None if not case[6] and case[9] is None else flash_mask(case)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        torch.testing.assert_close(library().transpose(1, 2), flash_attention_ref(q, k, v, **kw),
                                   rtol=1e-4, atol=1e-4)
        n_bytes, n_ops = flash_work(case)
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / flops * 1e3
        ms, ms_burst = device_ms_pair(lambda: flash_attention_op(q, k, v, **kw))
        library_ms, library_ms_burst = device_ms_pair(library)
        rows[label] = {
            "ms": ms, "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
            "library_ms": library_ms, "ms_burst": ms_burst, "library_ms_burst": library_ms_burst,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": list(case),
        }
        print(f"flash_attention fp32 {label}: {json.dumps(rows[label])}")
    for label, case in zip(("train_hubert", "train_qwen2_vl"), FLASH_BWD_FRONTENDS):
        rows[label] = time_flash_train(case, gen, bw, flops)
    return rows


def frontend_batch(cfg, b: int, s: int, seed: int) -> dict[str, torch.Tensor]:
    """A CPU batch of numpy draws from ``seed``: for the audio frontend
    ``frames`` and, as ``labels``, each frame's nearest of ``vocab_size``
    seeded centroids by dot product (k-means ids, as HuBERT's targets are);
    for the vision one, tokens and ``patches`` over the first s/4
    positions."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        frames = rng.standard_normal((b, s, cfg.frontend_dim), dtype=np.float32)
        centroids = np.random.default_rng(SEED).standard_normal(
            (cfg.vocab_size, cfg.frontend_dim), dtype=np.float32)
        return {"frames": torch.from_numpy(frames),
                "labels": torch.from_numpy((frames @ centroids.T).argmax(-1).astype(np.int32))}
    return {"tokens": torch.from_numpy(rng.integers(4, cfg.vocab_size, (b, s)).astype(np.int32)),
            "patches": torch.from_numpy(
                rng.standard_normal((b, s // 4, cfg.frontend_dim), dtype=np.float32))}


def on_card(batch: dict) -> dict:
    return {k: t.cuda() for k, t in batch.items()}


def host_available_bytes() -> int:
    """``MemAvailable`` of ``/proc/meminfo``."""
    for row in Path("/proc/meminfo").read_text().splitlines():
        if row.startswith("MemAvailable:"):
            return int(row.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def frontend_card_vs_cpu(arch: str) -> dict:
    """``arch`` at its full width, ``FRONTEND_CHECK_LAYERS`` layers (one if
    the host's available memory cannot hold the CPU model and its
    gradients twice over), ``init_scale=1``, the same weights on the card
    and on the CPU, on a ``frontend_batch`` of 2 x 64: what the layers add
    to the embedding, card vs CPU within 1e-4 after checking it is far
    larger; ``forward`` logits within 1e-4; one ``value_and_grad`` of
    ``LM.loss`` held as ``lm_step_card_vs_cpu`` holds it (the token
    embedding of the audio frontend, which its loss does not reach,
    exactly zero on both), launches exact."""
    from repro_torch.configs import get
    from repro_torch.models.lm import LM
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    n_layers = FRONTEND_CHECK_LAYERS[arch]
    small = dataclasses.replace(get(arch), n_layers=n_layers, init_scale=1.0)
    need = 3 * 4 * exact_param_count(small)
    available = host_available_bytes()
    if available < need:
        n_layers = 1
        small = dataclasses.replace(small, n_layers=1)
        print(f"{small.name}: the host has {available / 1e9:.1f} GB available, under the "
              f"{need / 1e9:.1f} GB of {FRONTEND_CHECK_LAYERS[arch]} layers: checking 1 layer")
    card = LM(small, "cuda", seed=SEED)
    cpu = LM(small, "meta")
    cpu.to_empty(device="cpu")
    target = cpu.state_dict()
    for name, t in card.state_dict().items():  # one tensor at a time through the host
        target[name].copy_(t.cpu())
    batch = frontend_batch(small, LM_TRAIN_CHECK_BATCH, LM_TRAIN_SEQ, SEED + 8)

    def layers_add(model, b):
        with torch.no_grad():
            return (model.hidden(b) - model._embed(b)).cpu()

    delta_card, delta_cpu = layers_add(card, on_card(batch)), layers_add(cpu, batch)
    delta_size = delta_cpu.abs().mean().item()
    if delta_size < 100 * 1e-4:
        fail(f"{small.name}: the layers add only {delta_size:.3e}: 1e-4 cannot see them")
    torch.testing.assert_close(delta_card, delta_cpu, rtol=1e-4, atol=1e-4)
    logits_card = card(on_card(batch)).cpu()
    if not torch.isfinite(logits_card).all():
        fail(f"non-finite {small.name} logits on the card")
    logits_cpu = cpu(batch)
    torch.testing.assert_close(logits_card, logits_cpu, rtol=1e-4, atol=1e-4)
    logit_err = (logits_card - logits_cpu).abs().max().item()
    del logits_card, logits_cpu

    counters = lm_train_counters()
    zero_counters(counters)
    loss_card, grads_card = value_and_grad(functional_loss(card))(params_of(card),
                                                                  on_card(batch))
    torch.cuda.synchronize()
    launches = {name: counter[name] for name, counter in counters.items()}
    del card
    torch.cuda.empty_cache()
    loss_cpu, grads_cpu = value_and_grad(functional_loss(cpu))(params_of(cpu), batch)
    want = step_launches(cpu.kinds, 1)
    if launches != want:
        fail(f"{small.name} card step: launches {launches}, expected {want}")
    lc, lp = loss_card.item(), loss_cpu.item()
    if not np.isfinite(lc) or abs(lc - lp) > 1e-5 * abs(lp):
        fail(f"{small.name} train step loss card {lc} vs CPU {lp} (rtol 1e-5)")
    unreached = {"embed/embedding"} if small.frontend == "audio" else set()
    key_biases = {f"layers/{i}/attn/bk": f"layers/{i}/attn/wk"
                  for i in range(n_layers)} if small.qkv_bias else {}
    worst = held_grads(small.name, grads_card, grads_cpu, unreached, key_biases)
    print(f"{small.name} with {n_layers} full-width layers at init_scale 1, card vs CPU on "
          f"{ {k: tuple(t.shape) for k, t in batch.items()} }: what the layers add (mean abs "
          f"{delta_size:.3e}) within 1e-4, forward logits max abs err {logit_err:.3e} (tol "
          f"1e-4); one train step: loss {lc:.6f} vs {lp:.6f}, {len(grads_cpu)} gradients "
          f"({len(unreached)} unreached, zero on both), worst max|dg|/max|g| {worst:.3e} "
          f"(limit 1e-4); launches {launches}")
    del grads_card, grads_cpu, cpu
    torch.cuda.empty_cache()
    return {"arch": small.name, "label": f"{small.name} card vs cpu", "layers": n_layers,
            "host_available_bytes": available, "layers_add_mean_abs": delta_size,
            "logits_max_abs_err": logit_err, "loss_card": lc, "loss_cpu": lp,
            "grad_worst_rel": worst, "launches": launches}


def hubert_full_depth() -> dict:
    """HuBERT X-Large at its full width and all 48 layers: a no-grad
    ``forward`` over 8 x 512 frames (finite logits, one serving flash
    launch a layer), then ``HUBERT_STEPS`` steps of ``make_train_step``
    (donating) over ``LM.loss`` cycling through ``HUBERT_POOL`` frame
    batches: flash training forward and backward launches exact (48 x 2 and
    48 a step, with remat), finite losses whose last 5 average below the
    first 5; seconds a step, frames/s, peak memory."""
    from repro_torch.configs import get
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.train_loop import functional_loss, make_train_step, params_of

    cfg = get("hubert_xlarge")
    model = LM(cfg, "cuda", seed=SEED)
    n_params = model.param_count()
    if n_params != exact_param_count(cfg):
        fail(f"{cfg.name} has {n_params} parameters, expected {exact_param_count(cfg)}")
    pool = [on_card(frontend_batch(cfg, HUBERT_BATCH, HUBERT_FRAMES, SEED + 20 + i))
            for i in range(HUBERT_POOL)]
    counters = lm_train_counters()
    model(pool[0])  # warm-up
    torch.cuda.synchronize()
    zero_counters(counters)
    t0 = time.perf_counter()
    logits = model(pool[0])
    torch.cuda.synchronize()
    forward_seconds = time.perf_counter() - t0
    forward_launches = {name: counter[name] for name, counter in counters.items()}
    if tuple(logits.shape) != (HUBERT_BATCH, HUBERT_FRAMES, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"{cfg.name} forward gave {tuple(logits.shape)} logits, finite: "
             f"{bool(torch.isfinite(logits).all())}")
    if forward_launches["flash_attention"] != cfg.n_layers or \
            forward_launches["flash_attention_bwd"]:
        fail(f"{cfg.name} forward made launches {forward_launches}, expected "
             f"{cfg.n_layers} flash_attention")
    del logits

    opt = AdamW(learning_rate=warmup_cosine(HUBERT_LR, HUBERT_WARMUP, HUBERT_STEPS))
    step = make_train_step(functional_loss(model), opt, donate=True)
    params = params_of(model)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    losses, step_seconds = [], []
    for i in range(HUBERT_STEPS):
        t1 = time.perf_counter()
        _, _, metrics = step(params, state, pool[i % HUBERT_POOL])
        losses.append(metrics["loss"].item())  # waits for the step
        step_seconds.append(time.perf_counter() - t1)
    launches = {name: counter[name] for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = step_launches(model.kinds, HUBERT_STEPS)
    if launches != want:
        fail(f"{cfg.name} train steps made launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"{cfg.name} losses over {HUBERT_STEPS} steps did not fall: {losses}")
    seconds = sum(step_seconds)
    n_frames = HUBERT_STEPS * HUBERT_BATCH * HUBERT_FRAMES
    print(f"{cfg.name} at all {cfg.n_layers} layers ({n_params} parameters): forward over "
          f"{HUBERT_BATCH} x {HUBERT_FRAMES} frames in {forward_seconds * 1e3:.1f} ms "
          f"({forward_launches['flash_attention']} flash launches); {HUBERT_STEPS} train steps in "
          f"{seconds:.3f} s ({statistics.median(step_seconds) * 1e3:.1f} ms median a step, "
          f"{n_frames / seconds:.0f} frames/s), loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
          f"memory {peak / 1e9:.2f} GB; launches {launches}")
    line = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
            "batch": HUBERT_BATCH, "frames": HUBERT_FRAMES, "forward_seconds": forward_seconds,
            "forward_launches": forward_launches, "steps": HUBERT_STEPS, "lr": HUBERT_LR,
            "seconds": seconds, "step_seconds": step_seconds,
            "median_step_seconds": statistics.median(step_seconds),
            "frames_per_s": n_frames / seconds, "peak_memory_bytes": peak, "losses": losses,
            "launches": launches}
    del model, params, state, step, pool
    torch.cuda.empty_cache()
    return line


def frontends(bw: float, flops: float) -> tuple[dict, dict]:
    """The frontends phase; returns its line and the flash rows at the new
    shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 6)  # the earlier checks' draws unchanged
    errors = check_flash_frontends(gen)
    rows = time_flash_frontends(gen, bw, flops)
    torch.cuda.empty_cache()
    checked = [frontend_card_vs_cpu(arch) for arch in FRONTEND_ARCHS]
    line = {"flash_max_abs_err": errors, "card_vs_cpu": checked,
            "hubert_full_depth": hubert_full_depth()}
    line["phase_seconds"] = time.perf_counter() - t0
    print(f"frontends phase: {line['phase_seconds']:.1f} s")
    return line, rows


# The lm_train_bf16 phase: the LM family trained in bf16, as the JAX dry
# run's train cells build it (src/repro/launch/dryrun.py:189 build_cell:
# LM(cfg, remat=True, dtype=bf16), AdamW, make_train_step). bf16 peaks of
# the tensor cores, dense, from NVIDIA's data sheets: (name substring,
# FLOP/s). First match wins.
BF16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H200", 989e12), ("H100", 989e12))
# train_4k's microbatch for StableLM-3B: MICRO_ROWS["stablelm_3b"] = 8 rows
# (src/repro/launch/dryrun.py:50) of 4,096 tokens; 32 heads of 80, causal
TRAIN_4K_ROWS, TRAIN_4K_SEQ = 8, 4096
TRAIN_4K_FLASH = (TRAIN_4K_ROWS, TRAIN_4K_SEQ, 32, 32, 80, True, 0)
# (b, s, nq, nkv, hd, causal, window) of the bf16 kernels' checks: the fp32
# training shapes, HuBERT X-Large's and Qwen2-VL-72B's, and train_4k's
# The bf16 kernels' tilings' edges (128-row and 128-key tiles, 64 and 32
# at hd 256; 64- and 32-row chunks): lengths past one tile and not
# multiples of 128, a window, non-causal, a head of 36 (padded to 40), and
# a view one element past an aligned base (copied by the wrapper)
FLASH_BF16_ODD_VIEW = (2, 96, 8, 4, 64, True, 0)
FLASH_BF16_EDGES = [(2, 200, 8, 2, 80, True, 0), (1, 129, 16, 1, 256, True, 0),
                    (2, 513, 32, 32, 80, True, 100), (2, 300, 4, 4, 128, False, 0),
                    (1, 100, 4, 1, 36, True, 0), FLASH_BF16_ODD_VIEW]
FLASH_BF16_CASES = FLASH_BWD_CASES + FLASH_BWD_FRONTENDS + [TRAIN_4K_FLASH] + FLASH_BF16_EDGES
FLASH_BF16_TIMED = {"8x64": FLASH_BWD_CASES[0], "8x512": (8, 512, 32, 32, 80, True, 0),
                    "8x2048": (8, 2048, 32, 32, 80, True, 0), "8x4096": TRAIN_4K_FLASH}
# a plain version past this many fp32 scores runs one batch row at a time
# (train_4k's whole batch would be 17 GB of scores, and several such tensors)
PLAIN_ROW_SCORES = 1 << 30
# the bf16 step card vs CPU: the fp32 check's models and depths
BF16_CHECKED = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b")
# StableLM-3B at all 32 layers in bf16: the dry run's 32 microbatches x dp of
# 8 rows cut to one microbatch (TrainStepConfig(n_microbatches=1)), 5
# donating steps, AdamW with fp32 moments, lr warmup_cosine(3e-4, 1, 5)
BF16_STEPS, BF16_LR, BF16_WARMUP = 5, 3e-4, 1


def bf16_peak(name: str) -> float:
    for key, flops in BF16_PEAKS:
        if key in name:
            return flops
    fail(f"no bf16 peak for card {name!r}")


def held_bf16(got, want, what: str) -> float:
    """bf16 within 2e-2 abs/rel elementwise, or within 2e-2 of the tensor's
    largest element (the kernel rounds P from its running max, the plain
    version from the row's; out and the gradients come out rounded to bf16).
    Returns the max abs error."""
    err = (got.float() - want.float()).abs()
    worst = err.max().item() if err.numel() else 0.0
    if not (torch.all(err <= 2e-2 + 2e-2 * want.float().abs())
            or worst <= 2e-2 * want.float().abs().max().item()):
        fail(f"{what}: max abs err {worst:.3e} against the plain version (largest element "
             f"{want.float().abs().max().item():.3e}; tol 2e-2 abs/rel or 2e-2 of the largest)")
    return worst


def lse_slack(q, k, kw) -> torch.Tensor:
    """``(b, nq, s)``: one bf16 unit of each row's largest visible scaled
    score (2^-7 of it) plus fp32's 2e-5, what lse may differ by between the
    card and the plain version. Each score is rounded to bf16, as the
    reference's einsum returns it; where the card's fp32 sum and the plain
    version's land on two sides of a rounding boundary the score moves by
    one bf16 unit, and lse, 1-Lipschitz in the scores, by no more than the
    largest such move. One batch row at a time past ``PLAIN_ROW_SCORES``."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if kw["causal"]:
        mask &= pos[None, :] <= pos[:, None]
    if kw["window"] > 0:
        mask &= pos[None, :] > pos[:, None] - kw["window"]
    rows = range(b) if b * nq * s * s > PLAIN_ROW_SCORES else [None]
    out = []
    for i in rows:
        qi, ki = (q, k) if i is None else (q[i:i + 1], k[i:i + 1])
        qg = qi.float().reshape(qi.shape[0], s, nkv, nq // nkv, hd)
        top = torch.einsum("bsngk,btnk->bngst", qg, ki.float()).abs().mul_(hd ** -0.5)
        out.append(torch.where(mask, top, 0.0).amax(-1).reshape(qi.shape[0], nq, s))
        del top
    return torch.cat(out) * 2.0 ** -7


def held_lse(got, want, slack, what: str) -> float:
    """lse within ``slack`` (``lse_slack``) + 2e-5 |lse|. Returns the worst
    miss over the slack, a fraction of it."""
    err = (got - want).abs()
    limit = slack + 2e-5 * (1 + want.abs())
    if not torch.all(err <= limit):
        worst = (err - limit).argmax()
        fail(f"{what}: lse misses the plain version by {err.flatten()[worst].item():.3e} where "
             f"one bf16 unit of the row's largest score and fp32 allow "
             f"{limit.flatten()[worst].item():.3e}")
    return (err / limit).max().item() if err.numel() else 0.0


def flash_bf16_plain(q, k, v, dout, kw, lse=None):
    """The plain versions on the card in bf16: (out, lse) and, given lse,
    (dq, dk, dv) (the bf16 backward reads no out); one batch row at a time
    past ``PLAIN_ROW_SCORES``."""
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_train_ref)

    b, s, nq = q.shape[:3]
    rows = [slice(i, i + 1) for i in range(b)] if b * nq * s * s > PLAIN_ROW_SCORES \
        else [slice(0, b)]
    if lse is None:
        parts = [flash_attention_train_ref(q[r], k[r], v[r], **kw) for r in rows]
    else:
        parts = [flash_attention_bwd_ref(q[r], k[r], v[r], None, lse[r], dout[r], **kw)
                 for r in rows]
    return [torch.cat(ts) for ts in zip(*parts)]


def flash_bf16_inputs(case, gen):
    return [t.bfloat16() for t in flash_bwd_inputs(case, gen)]


def odd_view(t):
    """``t``'s values in a contiguous view one element past the start of
    its buffer (2 bytes off a 16-byte boundary in bf16)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)




def check_flash_bf16(gen) -> tuple[float, float, float]:
    """``flash_attention_train_bf16`` and ``flash_attention_bwd_bf16`` against
    their plain versions on the card at ``FLASH_BF16_CASES`` (out, dq, dk, dv
    by ``held_bf16``, lse by ``held_lse``), each launched twice and held
    equal bit for bit, no input written. Returns the max abs errors of out,
    of the gradients and lse's worst error as a fraction of its slack."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    e_out = e_grad = e_lse = 0.0
    for case in FLASH_BF16_CASES:
        kw = dict(causal=case[5], window=case[6])
        q, k, v, dout = flash_bf16_inputs(case, gen)
        if case == FLASH_BF16_ODD_VIEW:
            q, k, v, dout = (odd_view(t) for t in (q, k, v, dout))
            if q.data_ptr() % 16 == 0:
                fail(f"flash bf16 {case}: the odd view is aligned")
        inputs = [t.clone() for t in (q, k, v, dout)]
        out, lse = flash_ops.flash_attention_train(q, k, v, **kw)
        out2, lse2 = flash_ops.flash_attention_train(q, k, v, **kw)
        grads = flash_ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)
        again = flash_ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16 or lse.dtype != torch.float32 or \
                any(g.dtype != torch.bfloat16 for g in grads):
            fail(f"flash bf16 {case}: out {out.dtype}, lse {lse.dtype}, grads "
                 f"{[g.dtype for g in grads]}")
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            fail(f"flash_attention_train bf16 {case}: two launches differ")
        if not all(torch.equal(g, r) for g, r in zip(grads, again)):
            fail(f"flash_attention_bwd bf16 {case}: two launches differ")
        if not all(torch.equal(t, u) for t, u in zip((q, k, v, dout), inputs)):
            fail(f"flash bf16 {case}: an input was written")
        want_out, want_lse = flash_bf16_plain(q, k, v, dout, kw)
        e_out = max(e_out, held_bf16(out, want_out, f"flash_attention_train bf16 {case} out"))
        e_lse = max(e_lse, held_lse(lse, want_lse, lse_slack(q, k, kw),
                                    f"flash_attention_train bf16 {case}"))
        del want_out, want_lse
        want = flash_bf16_plain(q, k, v, dout, kw, lse)
        e_grad = max(e_grad, *(held_bf16(g, w, f"flash_attention_bwd bf16 {case} d{name}")
                               for name, g, w in zip("qkv", grads, want)))
        del q, k, v, dout, out, out2, lse, lse2, grads, again, want, inputs
        torch.cuda.empty_cache()
    print(f"flash_attention_train_bf16 and flash_attention_bwd_bf16: match their plain versions "
          f"at {len(FLASH_BF16_CASES)} shapes (the fp32 training shapes, HuBERT X-Large's "
          f"8 x 512 non-causal 16 x 80, Qwen2-VL-72B's 64/8 x 128 at 2 x 64, StableLM-3B's "
          f"train_4k microbatch {TRAIN_4K_FLASH}, the tilings' edges {FLASH_BF16_EDGES}, the "
          f"last a view at an odd element offset); out {e_out:.3e}, grads {e_grad:.3e} (tol 2e-2 "
          f"abs/rel or 2e-2 of the tensor's max), lse at {e_lse:.3f} of its slack (one bf16 "
          f"unit of the row's largest score and 2e-5 abs/rel); "
          f"two launches identical bit for bit; no input written")
    return e_out, e_grad, e_lse


def time_flash_bf16(case, gen, bw: float, flops: float) -> dict:
    """Both bf16 kernels at ``case``, both timers (the median of 10 calls, and
    20 back to back, 2 past 0.5 ms a call: SDPA's autograd call is a score
    of launches and the backward at 8 x 4,096 129, and more of them would
    fill the launch queue behind the spin), beside their plain versions,
    their bounds (bf16 tensor cores) and
    ``scaled_dot_product_attention`` in bf16 (the port never calls it): its
    forward, and its forward and backward over the kv heads repeated to
    the query heads beforehand."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, s, nq, nkv, hd, causal = case[:6]
    kw = dict(causal=causal, window=0)
    q, k, v, dout = flash_bf16_inputs(case, gen)
    out, lse = flash_ops.flash_attention_train(q, k, v, **kw)
    group = nq // nkv
    qt, kt, vt = (heads_of_queries(t.transpose(1, 2), 1 if t is q else group)
                  .detach().requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return torch.autograd.grad(o, (qt, kt, vt), dt)

    def library_forward():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def timed(fn):
        ms = device_ms(fn, 10)
        return ms, device_ms_burst(fn, 20 if ms <= 0.5 else 2)

    pairs = b * nq * (s * (s + 1) // 2 if causal else s * s)  # visible (query, key) pairs
    q_elems, kv_elems = b * s * nq * hd, b * s * nkv * hd
    # forward: q, k, v read, out written (bf16), lse written (fp32); Q K^T and P V
    fwd_bytes, fwd_ops = 2 * (2 * q_elems + 2 * kv_elems) + 4 * b * nq * s, 2 * 2 * hd * pairs
    # backward: q, k, v, dout read, dq, dk, dv written (bf16), lse read; the
    # five products of the reference's algebra (S, dP, dV, dQ, dK)
    bwd_bytes, bwd_ops = 2 * (3 * q_elems + 4 * kv_elems) + 4 * b * nq * s, 5 * 2 * hd * pairs

    def bound(n_bytes, n_ops):
        return max(n_bytes / bw, n_ops / flops) * 1e3, \
            "bytes" if n_bytes / bw >= n_ops / flops else "operations"

    fwd_ms, fwd_burst = timed(lambda: flash_ops.flash_attention_train(q, k, v, **kw))
    bwd_ms, bwd_burst = timed(lambda: flash_ops.flash_attention_bwd(q, k, v, None, lse, dout,
                                                                    **kw))
    lib_fwd, lib_fwd_burst = timed(library_forward)
    lib, lib_burst = timed(library)
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_ops)
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_ops)
    plan = flash_ops.bwd_bf16_plan(b, s, s, nq, nkv, hd)
    before = flash_ops.bwd_bf16_kernels()
    flash_ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)
    kernels = flash_ops.bwd_bf16_kernels() - before
    if kernels != plan.launches:
        fail(f"flash_attention_bwd bf16 {case}: {kernels} kernels a call, its plan says "
             f"{plan.launches}")
    print(f"flash_attention_bwd bf16 {case}: {kernels} kernels a call (head split "
          f"{plan.head_split}), as its plan says")
    row = {"shape": list(case),
           "forward": {"ms": fwd_ms, "ms_burst": fwd_burst,
                       "plain_ms": device_ms(lambda: flash_bf16_plain(q, k, v, dout, kw), 3),
                       "bound_ms": fwd_bound, "bound_by": fwd_by, "bytes": fwd_bytes,
                       "operations": fwd_ops, "library_ms": lib_fwd,
                       "library_ms_burst": lib_fwd_burst,
                       "library": "scaled_dot_product_attention forward, bf16"},
           "backward": {"ms": bwd_ms, "ms_burst": bwd_burst,
                        "plain_ms": device_ms(lambda: flash_bf16_plain(q, k, v, dout, kw, lse),
                                              3),
                        "bound_ms": bwd_bound, "bound_by": bwd_by, "bytes": bwd_bytes,
                        "operations": bwd_ops, "library_ms": lib, "library_ms_burst": lib_burst,
                        "library": "scaled_dot_product_attention forward + backward, bf16",
                        "kernels_a_call": kernels, "head_split": plan.head_split,
                        # the design's own floor: nine products where the algebra has five
                        "design_floor_ms": max(bwd_bytes / bw, 9 / 5 * bwd_ops / flops) * 1e3}}
    row["forward_and_backward_ms"] = fwd_ms + bwd_ms
    print(f"flash bf16 {case}: {json.dumps(row)}")
    del q, k, v, dout, out, lse, qt, kt, vt, dt
    torch.cuda.empty_cache()
    return row


def bf16_grad_misses(name: str, card: dict, cpu: dict, fp32) -> tuple[float, str, float, list]:
    """Every gradient present and non-zero on the card, in the CPU's dtype.
    Returns the worst distance from the CPU's bf16 gradient (as a share of
    its largest element) and its gradient's path, the worst ratio of the card's distance from the
    CPU's fp32 gradient to the CPU bf16 one's (0 if no gradient needed the
    second way) and the gradients that miss both ways of the rule: within
    2e-2 of the CPU bf16 gradient's largest element, or no further from the
    CPU's fp32 gradient (of the same rounded parameters) than the CPU's
    bf16 one is, times 1.5. ``fp32()`` gives the CPU's fp32 gradients; it
    is called once, and only if a gradient misses 2e-2."""
    if set(card) != set(cpu):
        fail(f"{name} bf16 step: the card and the CPU give gradients of other parameters")
    worst = worst_ratio = 0.0
    worst_path, misses, grads32 = "", [], None
    for path, w in cpu.items():
        g = card[path]
        if g.dtype != w.dtype:
            fail(f"{name} bf16 step: {path}'s gradient is {g.dtype} on the card, {w.dtype} on "
                 f"the CPU")
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        if scale == 0 or g.abs().max().item() == 0:
            fail(f"{name} bf16 step: the gradient of {path} is zero")
        err = (g - w).abs().max().item() / scale
        if err > worst:
            worst, worst_path = err, path
        if err <= 2e-2:
            continue
        if grads32 is None:
            grads32 = fp32()
        f = grads32[path].float()
        err32, ref32 = (g - f).abs().max().item(), (w - f).abs().max().item()
        if ref32:
            worst_ratio = max(worst_ratio, err32 / ref32)
        if err32 > 1.5 * ref32:
            misses.append({"path": path, "rel": err, "from_fp32": err32, "cpu_from_fp32": ref32})
    return worst, worst_path, worst_ratio, misses


@contextlib.contextmanager
def recorded_moe_outputs():
    """Every ``y`` that ``models.moe.moe_local`` returns while inside, in
    call order (a list of CPU tensors)."""
    from unittest import mock

    from repro_torch.models import moe

    ys, local = [], moe.moe_local

    def recording(*args, **kwargs):
        y, aux = local(*args, **kwargs)
        ys.append(y.detach().cpu())
        return y, aux

    with mock.patch.object(moe, "moe_local", recording):
        yield ys


@contextlib.contextmanager
def residual_stream(model):
    """Records, while inside, the residual stream of one pass of ``model``'s
    loss at the layer boundaries: each layer's input X[i] and the last
    layer's output X[L] into the first list it gives, and, as the backward
    reaches them, the loss's cotangent of each, dX[i], into the dict. A
    remat layer's recompute is not recorded."""
    from unittest import mock

    xs, dxs, block, n = [], {}, model._block, len(model.layers)

    def recording(layer, kind, moe, x, positions, cache=None, cache_pos=0):
        i = len(xs)
        out = block(layer, kind, moe, x, positions, cache, cache_pos)
        if i < n:
            xs.append(x.detach().clone())
            x.register_hook(lambda g: dxs.__setitem__(i, g.detach().clone()))
        if i == n - 1:
            xs.append(out[0].detach().clone())
            out[0].register_hook(lambda g: dxs.__setitem__(n, g.detach().clone()))
        return out

    with mock.patch.object(model, "_block", recording):
        yield xs, dxs


def bf16_split_step(model, tokens, xs, dxs) -> tuple[dict, list]:
    """``model``'s step split at the residual stream: each layer alone on
    the input ``xs[i]`` with its output's cotangent ``dxs[i + 1]``, the
    embedding with its output's cotangent ``dxs[0]``, the head (final norm,
    logits, loss) on ``xs[-1]``, in ``model``'s dtype on its device (no
    remat). -> (the gradients of the parameters and, as ``residual/<i>``,
    of each ``xs[i]``; each layer's output)."""
    from unittest import mock

    from repro_torch.runtime.train_loop import functional_loss, params_of

    dev, dt = model.device, model.dtype
    xs = [x.to(dev, dt).requires_grad_(True) for x in xs]
    dxs = [d.to(dev, dt) for d in dxs]
    outs, terms, block, embed = [], [], model._block, model._embed

    def split_block(layer, kind, moe, x, positions, cache=None, cache_pos=0):
        i = len(outs)
        y, new_cache, aux = block(layer, kind, moe, xs[i], positions, cache, cache_pos)
        outs.append(y.detach().cpu())
        terms.append((y.float() * dxs[i + 1].float()).sum())
        return xs[i + 1], new_cache, aux

    def split_embed(batch):
        e = embed(batch)
        terms.append((e.float() * dxs[0].float()).sum())
        return e

    leaves = {k: t.detach().requires_grad_(True) for k, t in params_of(model).items()}
    model.remat = False
    with torch.enable_grad(), mock.patch.object(model, "_block", split_block), \
            mock.patch.object(model, "_embed", split_embed):
        loss = functional_loss(model)(leaves, {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(loss + sum(terms), [*leaves.values(), *xs])
    model.remat = True
    names = [*leaves, *(f"residual/{i}" for i in range(len(xs)))]
    return {k: g.cpu() for k, g in zip(names, grads)}, outs


def bf16_step_card_vs_cpu(arch: str) -> dict:
    """One ``value_and_grad`` of ``LM.loss`` in bf16 at ``arch``'s width cut
    to ``CARD_VS_CPU_LAYERS`` layers, ``init_scale=1``, parameters rounded to
    bf16 (the router fp32): the card against the CPU in bf16 and, where a
    gradient misses 2e-2, the CPU in fp32 on the same rounded parameters.
    The loss at 2e-3 rel, each gradient by ``bf16_grad_misses``' rule, the
    card's launches exact, a MoE model's expert ids equal on card and CPU,
    call by call and token by token, as each token's set of k experts; where
    a token ranks its experts apart, ``moe_local``'s output on that token
    within 2e-2 of the CPU's largest element on those tokens.

    Where a gradient misses both ways of the rule, the step is split at the
    residual stream: each layer, the embedding and the head run alone on
    the card from the CPU's bf16 boundary values (``residual_stream``,
    ``bf16_split_step``), and every parameter gradient and boundary
    cotangent is held to the same rule against the CPU's step (its split
    step, bit for bit) and the CPU's fp32 split step; each layer's output
    within 2e-2 of its largest element. At xLSTM-1.3B's 8 full-width layers
    some gradients are mostly bf16 noise carried down from the layers
    above: two CPU steps that differ only in fp32 roundings stand up to 59%
    of such a gradient's largest element apart and miss the whole step's
    rule against each other as often as card and CPU do
    (``tools/bf16_card_vs_cpu.py``); split, each layer's gradients are its
    own."""
    from repro_torch.configs import get
    from repro_torch.models.lm import LM, layer_kinds
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    small = dataclasses.replace(get(arch), n_layers=CARD_VS_CPU_LAYERS[arch], init_scale=1.0)
    card = LM(small, "cuda", dtype=torch.bfloat16, seed=SEED)
    state = {k: t.cpu() for k, t in card.state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        4, small.vocab_size, size=(LM_TRAIN_CHECK_BATCH, LM_TRAIN_SEQ)).astype(np.int32))
    counters = lm_train_counters()
    zero_counters(counters)
    with recorded_routes() as routes_card, recorded_moe_outputs() as ys_card:
        loss_card, grads_card = value_and_grad(functional_loss(card))(params_of(card),
                                                                      {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    launches = {name: counter[name] for name, counter in counters.items()}
    grads_card = {k: g.cpu() for k, g in grads_card.items()}

    def cpu_model(dtype):
        cpu = LM(small, "meta", dtype=dtype)
        cpu.to_empty(device="cpu")
        cpu.load_state_dict({k: t.to(dtype) if t.dtype == torch.bfloat16 else t
                             for k, t in state.items()})
        return cpu

    def cpu_step(dtype):
        cpu = cpu_model(dtype)
        with recorded_routes() as routes, recorded_moe_outputs() as ys, \
                residual_stream(cpu) as (xs, dxs):
            loss, grads = value_and_grad(functional_loss(cpu))(params_of(cpu), {"tokens": tokens})
        return loss.item(), grads, routes, ys, (xs, [dxs[i] for i in range(len(xs))])

    lp, grads_cpu, routes_cpu, ys_cpu, (xs, dxs) = cpu_step(torch.bfloat16)
    fp32_loss = {}

    def fp32():
        fp32_loss["loss_cpu_fp32"], grads32, *_ = cpu_step(torch.float32)
        return grads32

    want = step_launches(layer_kinds(small), 1)
    if launches != want:
        fail(f"{small.name} bf16 card step: launches {launches}, expected {want}")
    # the set of a token's k experts: their order follows their probabilities,
    # which card and CPU may rank apart where two lie within bf16 noise; the
    # k copies are added in that order, so such a token's output is held too
    if len(routes_card) != len(routes_cpu) or not all(
            torch.equal(a.sort(-1).values, b.sort(-1).values)
            for a, b in zip(routes_card, routes_cpu)):
        fail(f"{small.name} bf16 train step: the expert ids differ between the card and the CPU")
    if small.moe is not None and not routes_card:
        fail(f"{small.name} bf16 train step routed no token")
    reordered, reordered_err = 0, 0.0
    for a, b, yc, yp in zip(routes_card, routes_cpu, ys_card, ys_cpu):
        rows = (a != b).any(-1).nonzero().flatten()
        if not len(rows):
            continue
        reordered += len(rows)
        yc, yp = (y.reshape(-1, y.shape[-1])[rows].float() for y in (yc, yp))
        err = (yc - yp).abs().max().item() / yp.abs().max().item()
        reordered_err = max(reordered_err, err)
        if err > 2e-2:
            fail(f"{small.name} bf16 train step: moe_local's output on the {len(rows)} tokens "
                 f"that rank their experts apart is {err:.3e} of its largest element from the "
                 f"CPU's (tol 2e-2)")
    lc = loss_card.item()
    if not np.isfinite(lc) or abs(lc - lp) > 2e-3 * abs(lp):
        fail(f"{small.name} bf16 train step loss card {lc} vs CPU {lp} (rtol 2e-3)")
    worst, worst_path, ratio, misses = bf16_grad_misses(small.name, grads_card, grads_cpu,
                                                         fp32)
    for m in misses:
        print(f"  {m['path']}: {m['rel']:.3e} of its largest element from the CPU's bf16 "
              f"gradient, {m['from_fp32']:.3e} from the fp32 one where the CPU's bf16 one is "
              f"{m['cpu_from_fp32']:.3e}")
    split = {}
    if misses:
        # the CPU's split step is its whole step, recorded at the boundaries
        # (bit for bit: tests/test_torch_bf16_split.py)
        split_cpu = {**grads_cpu, **{f"residual/{i}": d for i, d in enumerate(dxs)}}
        outs_cpu = xs[1:]
        split_card, outs_card = bf16_split_step(card, tokens, xs, dxs)
        torch.cuda.synchronize()
        split_out = 0.0
        for i, (yc, yp) in enumerate(zip(outs_card, outs_cpu)):
            err = (yc.float() - yp.float()).abs().max().item() / yp.float().abs().max().item()
            split_out = max(split_out, err)
            if err > 2e-2:
                fail(f"{small.name} bf16 split step: layer {i}'s output on the CPU's input is "
                     f"{err:.3e} of its largest element from the CPU's (tol 2e-2)")
        split_worst, split_path, split_ratio, split_misses = bf16_grad_misses(
            f"{small.name} split", split_card, split_cpu,
            lambda: bf16_split_step(cpu_model(torch.float32), tokens, xs, dxs)[0])
        for m in split_misses:
            print(f"  split {m['path']}: {m['rel']:.3e} of its largest element from the CPU's "
                  f"bf16 gradient, {m['from_fp32']:.3e} from the fp32 one where the CPU's bf16 "
                  f"one is {m['cpu_from_fp32']:.3e}")
        if split_misses:
            fail(f"{small.name} bf16 step: {len(misses)} gradients miss the rule in the whole "
                 f"step and {len(split_misses)} in the step split at the residual stream")
        split = {"split_gradients": len(split_cpu), "split_grad_worst_rel": split_worst,
                 "split_grad_worst_path": split_path,
                 "split_worst_ratio": split_ratio, "split_layer_output_rel": split_out,
                 "whole_step_misses": [m["path"] for m in misses]}
    del card
    torch.cuda.empty_cache()
    print(f"{small.name} with {small.n_layers} layers at init_scale 1 in bf16, one train step "
          f"card vs CPU (batch {tuple(tokens.shape)}): loss {lc:.6f} vs {lp:.6f}; all "
          f"{len(grads_cpu)} gradients present and non-zero, worst max|dg|/max|g| against the "
          f"CPU's bf16 {worst:.3e} ({worst_path})"
          + (f" (CPU fp32 loss {fp32_loss['loss_cpu_fp32']:.6f}, worst distance from fp32 "
             f"against the CPU bf16's {ratio:.2f}x)" if fp32_loss else "")
          + (f"; {len(misses)} missed both ways, and split at the residual stream all "
             f"{split['split_gradients']} gradients meet the rule (worst "
             f"{split['split_grad_worst_rel']:.3e} from the CPU's bf16 at "
             f"{split['split_grad_worst_path']}, distance from fp32 "
             f"{split['split_worst_ratio']:.2f}x the CPU bf16's; layer outputs "
             f"{split['split_layer_output_rel']:.3e})" if split else "")
          + f"; {len(routes_card)} routings with equal expert sets ({reordered} tokens ranking "
          f"them apart, moe_local's output there {reordered_err:.3e} of its largest element "
          f"from the CPU's); launches {launches}")
    return {"arch": small.name, "label": f"{small.name} bf16", "layers": small.n_layers,
            "loss_card": lc, "loss_cpu": lp, **fp32_loss, **split,
            "grad_tensors": len(grads_cpu), "grad_worst_rel": worst, "grad_worst_path": worst_path,
            "grad_worst_ratio_to_cpu_bf16_vs_fp32": ratio, "routings_equal": len(routes_card),
            "tokens_ranking_experts_apart": reordered,
            "reordered_moe_output_rel": reordered_err, "launches": launches}


def bf16_full_depth() -> dict:
    """StableLM-3B at its full width and all 32 layers in bf16, on train_4k's
    microbatch: ``TRAIN_4K_ROWS`` rows of ``TRAIN_4K_SEQ`` tokens of
    ``build_dataset`` (exactly 2 ``text_scan`` launches), ``BF16_STEPS``
    steps of the launcher's donating step (one microbatch) with AdamW's fp32
    moments: exactly 64 flash forward and 32 backward launches a step (the
    forward again under remat), finite losses; seconds a step, tokens/s,
    peak memory, one more step traced, and 6 x active parameters x tokens a
    second as a share of the card's bf16 peak (the dry run's model_flops,
    src/repro/launch/dryrun.py:297)."""
    from repro_torch.configs import get
    from repro_torch.kernels.text_clean import ops as clean_ops
    from repro_torch.launch.serve import profile
    from repro_torch.launch.train import build_dataset, train_step_of
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime.train_loop import params_of

    cfg = get(LM_TRAIN_ARCH)
    clean_ops.LAUNCHES["text_scan"] = 0
    t0 = time.perf_counter()
    rows = build_dataset(cfg, TRAIN_4K_SEQ, LM_TRAIN_CORPUS_MB, seed=SEED, device="cuda")
    dataset_seconds = time.perf_counter() - t0
    scans = clean_ops.LAUNCHES["text_scan"]
    if scans != P3SAPP_SCANS[True]:
        fail(f"build_dataset made {scans} text_scan launches, expected {P3SAPP_SCANS[True]}")
    if len(rows) < TRAIN_4K_ROWS:
        fail(f"build_dataset gave {len(rows)} rows of {TRAIN_4K_SEQ}, fewer than a microbatch")
    t0 = time.perf_counter()
    model = LM(cfg, "cuda", dtype=torch.bfloat16, seed=SEED)
    opt = AdamW(learning_rate=warmup_cosine(BF16_LR, BF16_WARMUP, BF16_STEPS))
    step = train_step_of(model, opt)
    params = params_of(model)
    state = opt.init(params)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 8)

    def next_batch():
        idx = rng.choice(len(rows), size=TRAIN_4K_ROWS, replace=False)
        return {"tokens": torch.from_numpy(rows[idx]).cuda()}

    torch.cuda.reset_peak_memory_stats()
    counters = lm_train_counters()
    zero_counters(counters)
    losses, step_seconds = [], []
    for _ in range(BF16_STEPS):
        batch = next_batch()
        t1 = time.perf_counter()
        _, _, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        step_seconds.append(time.perf_counter() - t1)
    launches = {name: counter[name] for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = step_launches(model.kinds, BF16_STEPS)
    if launches != want:
        fail(f"StableLM-3B in bf16 at full depth made launches {launches}, expected {want}")
    if not np.isfinite(losses).all():
        fail(f"a non-finite bf16 loss at full depth: {losses}")
    if {p.dtype for name, p in params.items() if "router" not in name} != {torch.bfloat16}:
        fail("the bf16 model's parameters left bf16")
    traced = profile(lambda: step(params, state, next_batch()), torch.device("cuda"),
                     torch.cuda.synchronize, f"one bf16 {cfg.name} train step at all "
                     f"{cfg.n_layers} layers, {TRAIN_4K_ROWS} x {TRAIN_4K_SEQ}")
    steady = statistics.median(step_seconds[1:])
    tokens = TRAIN_4K_ROWS * TRAIN_4K_SEQ
    peak_flops = bf16_peak(torch.cuda.get_device_name(0))
    share = 6 * cfg.active_param_count() * tokens / steady / peak_flops
    print(f"LM train in bf16 at full depth: {cfg.name}, all {cfg.n_layers} layers "
          f"({model.param_count()} parameters, built with its AdamW state in {built:.1f} s), "
          f"{BF16_STEPS} donating steps of {TRAIN_4K_ROWS} x {TRAIN_4K_SEQ} (one microbatch of "
          f"train_4k), median after the first {steady:.3f} s a step, {tokens / steady:.0f} "
          f"tokens/s, {share:.2%} of the bf16 peak ({peak_flops / 1e12:.0f} TFLOP/s) as 6 x "
          f"{cfg.active_param_count()} active parameters x tokens; losses {losses}; peak memory "
          f"{peak / 1e9:.2f} GB; launches {launches}; {len(rows)} rows from build_dataset in "
          f"{dataset_seconds:.2f} s ({scans} text_scan)")
    line = {"arch": cfg.name, "layers": cfg.n_layers, "params": model.param_count(),
            "active_params": cfg.active_param_count(), "dtype": "bfloat16",
            "moment_dtype": "float32", "rows": TRAIN_4K_ROWS, "seq": TRAIN_4K_SEQ,
            "microbatches": 1, "steps": BF16_STEPS, "lr": BF16_LR,
            "reduced": "train_4k's 32 microbatches x dp of 8 rows cut to one microbatch a step",
            "step_seconds": step_seconds, "median_step_seconds": steady,
            "tokens_per_s": tokens / steady, "bf16_peak_share": share,
            "bf16_peak_flops": peak_flops, "peak_memory_bytes": peak, "losses": losses,
            "launches": launches, "traced_step": traced, "build_seconds": built,
            "build_dataset_rows": len(rows), "build_dataset_seconds": dataset_seconds,
            "build_dataset_text_scan_launches": scans}
    del model, params, state, step
    torch.cuda.empty_cache()
    return line


def lm_train_bf16(bw: float) -> tuple[dict, dict]:
    """The lm_train_bf16 phase; returns its line and the bf16 kernels' rows."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 9)  # the earlier checks' draws unchanged
    flops = bf16_peak(torch.cuda.get_device_name(0))
    e_out, e_grad, e_lse = check_flash_bf16(gen)
    rows = {label: time_flash_bf16(case, gen, bw, flops)
            for label, case in FLASH_BF16_TIMED.items()}
    checked = []
    for arch in BF16_CHECKED:
        checked.append(bf16_step_card_vs_cpu(arch))
        torch.cuda.empty_cache()
    line = {"flash_max_abs_err": {"out": e_out, "grads": e_grad, "lse_of_slack": e_lse},
            "card_vs_cpu": checked, "full_depth": bf16_full_depth()}
    line["phase_seconds"] = time.perf_counter() - t0
    print(f"lm_train_bf16 phase: {line['phase_seconds']:.1f} s")
    return line, rows


# The dryrun phase: the cell counted at full size on meta, and the steps
# counted on the card and on meta: (arch, layers, rows, seq, bytes equal).
DRYRUN_CELL = ("stablelm_3b", "train_4k")
DRYRUN_STEPS = (("stablelm_3b", 2, TRAIN_4K_ROWS, TRAIN_4K_SEQ, True),
                ("deepseek_moe_16b", 2, 2, 64, False))


def dryrun_card_vs_meta(arch: str, layers: int, rows: int, seq: int, exact: bool) -> dict:
    """One bf16 donating step of ``arch`` at full width and ``layers``
    layers on ``rows`` x ``seq`` tokens (one microbatch, as the dry run
    builds a train cell), counted by ``launch/hlo_cost.py`` on meta and
    then run on the card under it: FLOPs equal, bytes equal (``exact``) or
    the card's at most the meta count, each kernel's calls its launches,
    the arguments' bytes within 1% of what the card allocated for them."""
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import analyze

    cfg = dataclasses.replace(get(arch), n_layers=layers)
    kw = dict(cfg=cfg, shape=ShapeConfig("train", seq, rows, "train"),
              plan={**dryrun.BASELINE_PLAN, "micro_rows": rows})
    t0 = time.perf_counter()
    meta = dryrun.count_cell(arch, "train", **kw)
    meta_seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    step, args, _ = dryrun.build_cell(arch, "train", device="cuda", seed=SEED, **kw)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    counters = lm_train_counters()
    zero_counters(counters)
    t0 = time.perf_counter()
    card = analyze(step, *args)
    torch.cuda.synchronize()
    card_seconds = time.perf_counter() - t0
    launches = {name: counter[name] for name, counter in counters.items() if counter[name]}
    card_peak = torch.cuda.max_memory_allocated() - before - allocated
    if card["flops"] != meta["flops"]:
        fail(f"dryrun {arch}: the card counted {card['flops']} FLOPs, meta {meta['flops']}")
    if (card["bytes"] != meta["bytes"]) if exact else (card["bytes"] > meta["bytes"]):
        fail(f"dryrun {arch}: the card counted {card['bytes']} bytes, meta {meta['bytes']}")
    calls = {name: k["calls"] for name, k in card["kernels"].items()}
    if calls != launches or {n: k["calls"] for n, k in meta["kernels"].items()} != launches:
        fail(f"dryrun {arch}: counted kernel calls {calls} (meta "
             f"{ {n: k['calls'] for n, k in meta['kernels'].items()} }), launches {launches}")
    if arch == "stablelm_3b" and launches != {"flash_attention": 2 * layers,
                                              "flash_attention_bwd": layers}:
        fail(f"dryrun {arch}: launches {launches}, expected {2 * layers} and {layers}")
    argument = meta["memory"]["argument"]
    if card["memory"]["argument"] != argument or abs(argument - allocated) > 0.01 * allocated:
        fail(f"dryrun {arch}: argument bytes {argument} (card {card['memory']['argument']}), "
             f"the card allocated {allocated} for them")
    print(f"dryrun {cfg.name} at {layers} layers, {rows} x {seq} bf16: {card['flops']:.6e} "
          f"FLOPs on card and meta, bytes card {card['bytes']:.6e} meta {meta['bytes']:.6e}; "
          f"kernel calls {calls} = launches; arguments {argument} B (card allocated "
          f"{allocated}); peak beyond them: meta {meta['memory']['temp']} B, card "
          f"{card_peak} B; counted in {meta_seconds:.1f} s on meta, {card_seconds:.1f} s on "
          f"the card")
    return {"arch": cfg.name, "layers": layers, "rows": rows, "seq": seq, "dtype": "bfloat16",
            "flops": card["flops"], "card_bytes": card["bytes"], "meta_bytes": meta["bytes"],
            "kernels": card["kernels"], "launches": launches, "argument_bytes": argument,
            "card_allocated_bytes": allocated, "meta_temp_bytes": meta["memory"]["temp"],
            "card_peak_bytes": card_peak, "meta_seconds": meta_seconds,
            "card_seconds": card_seconds}


def dryrun_phase(bf16_line: dict) -> dict:
    """The dryrun phase: the StableLM-3B train_4k cell on meta at full size,
    its counted share of the bf16 peak from phase 16's full-depth step,
    then ``DRYRUN_STEPS`` card vs meta."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    arch, shape = DRYRUN_CELL
    rec = dryrun.run_cell(arch, shape, ROOT / "build" / "dryrun_torch",
                          plan=dryrun.BASELINE_PLAN)
    if not rec["ok"]:
        fail(f"dryrun {arch} x {shape}: {rec['error']}")
    flops, n_micro = rec["cost_analysis"]["flops"], rec["n_microbatches"]
    full = bf16_line["full_depth"]
    if (full["rows"], full["seq"]) != (rec["micro_rows"], TRAIN_4K_SEQ):
        fail(f"the full-depth step's {full['rows']} x {full['seq']} is not the cell's "
             f"microbatch of {rec['micro_rows']} x {TRAIN_4K_SEQ}")
    step = full["median_step_seconds"]
    peak = full["bf16_peak_flops"]
    counted_share = flops / n_micro / step / peak
    print(f"dryrun {arch} x {shape} on meta: {flops:.6e} FLOPs, "
          f"{rec['cost_analysis']['bytes']:.6e} bytes, model_flops {rec['model_flops']:.6e} "
          f"({flops / rec['model_flops']:.4f}x), {n_micro} microbatches, counted in "
          f"{rec['count_s']} s; one counted microbatch over the full-depth step's {step:.3f} s: "
          f"{counted_share:.2%} of the bf16 peak ({peak / 1e12:.0f} TFLOP/s), against "
          f"{full['bf16_peak_share']:.2%} as 6·N·T")
    line = {"cell": {k: rec[k] for k in ("arch", "shape", "cost_analysis", "model_flops",
                                         "memory_analysis", "fits_one_card", "n_microbatches",
                                         "micro_rows", "count_s")},
            "flops_over_model_flops": flops / rec["model_flops"],
            "microbatch_flops": flops / n_micro, "full_depth_step_seconds": step,
            "counted_bf16_peak_share": counted_share,
            "six_n_t_bf16_peak_share": full["bf16_peak_share"],
            "card_vs_meta": [dryrun_card_vs_meta(*case) for case in DRYRUN_STEPS]}
    torch.cuda.empty_cache()
    line["phase_seconds"] = time.perf_counter() - t0
    print(f"dryrun phase: {line['phase_seconds']:.1f} s")
    return line


# The mesh phase: the multi-device layer on a one-rank NCCL mesh. StableLM-3B
# at full width and 2 of its 32 layers, MESH_STEPS donating steps on 8 x 64
# tokens fed by DeviceFeed(sharding=...); RecurrentGemma-9B and xLSTM-1.3B
# forwards at SMOKE; one DeepSeek-MoE-16B MoE layer at full width through
# moe_ep on 4 x 128 tokens and on a decode step's 8 x 1; each held to the
# same work off the mesh. Decoding on the mesh (MESH_DECODES: arch, layers
# at full width or None for SMOKE, rows, prefill, steps): a block prefill,
# then greedy one-token steps over the state of init_decode_state on the
# mesh, bit for bit the same decode off it; RecurrentGemma-9B's SMOKE ring
# of 16 slots is passed at position 16.
MESH_LAYERS, MESH_STEPS, MESH_BATCH, MESH_LR = 2, 3, (8, 64), 1e-4
MESH_FORWARD_BATCH, MESH_MOE_TOKENS, MESH_TOL = (8, 64), (4, 128), 2e-5
MESH_DECODES = (("stablelm_3b", 2, 8, 64, 16), ("recurrentgemma_9b", None, 4, 12, 8),
                ("xlstm_1_3b", None, 4, 8, 4))
MESH_MOE_DECODE_TOKENS = (8, 1)


def mesh_held(got, want, what: str) -> float:
    """``got`` within MESH_TOL of ``want`` (rtol, and atol relative to
    want's largest element); returns the largest absolute difference."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=MESH_TOL, atol=MESH_TOL * scale):
        fail(f"mesh: {what} differs from off the mesh by {err:.3e} (scale {scale:.3e})")
    return err


def mesh_decode(mctx, counters, rng, arch: str, layers, rows: int, prefill: int,
                steps: int) -> dict:
    """``LM.decode_step`` on the mesh (``functional_decode`` over DTensor
    parameters, the DTensor state of ``init_decode_state``) against the
    same decode off it: a block prefill of ``prefill`` tokens, then
    ``steps`` greedy steps. The logits and tokens must be bit for bit the
    same, and each layer kind's kernel launched exactly once a layer and
    call in the mesh decode, counted from 0 around it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get, get_smoke
    from repro_torch.models.lm import LM
    from repro_torch.runtime.train_loop import functional_decode, params_of

    cfg = dataclasses.replace(get(arch), n_layers=layers) if layers else get_smoke(arch)
    plain = LM(cfg, "cuda", seed=SEED)
    meshed = LM(cfg, "cuda", mctx=mctx, seed=SEED)
    meshed.load_state_dict(plain.state_dict())
    prompt = torch.from_numpy(rng.integers(4, cfg.vocab_size, (rows, prefill))).cuda()

    def run(step, state):
        logits, tokens, pos, toks = [], [], 0, prompt
        for _ in range(steps + 1):
            out, state = step(toks, state, pos)
            out = out.full_tensor() if isinstance(out, DTensor) else out
            pos += toks.shape[1]
            toks = out[:, -1].argmax(-1, keepdim=True)
            logits.append(out)
            tokens.append(toks)
        return torch.cat(logits, 1), torch.cat(tokens, 1), state

    want, want_tokens, _ = run(plain.decode_step, plain.init_decode_state(rows, prefill + steps))
    dparams = meshed.distribute_params(params_of(meshed))
    decode = functional_decode(meshed)
    zero_counters(counters)
    t1 = time.perf_counter()
    got, tokens, state = run(lambda t, st, pos: decode(dparams, t, st, pos),
                             meshed.init_decode_state(rows, prefill + steps))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    n = {k: counters[k][k] for k in ("flash_attention", "rg_lru", "mlstm_chunk")}
    kinds = meshed.kinds
    expect = {"flash_attention": kinds.count("attn") * (steps + 1),
              "rg_lru": kinds.count("rglru") * (steps + 1),
              "mlstm_chunk": kinds.count("mlstm") * (steps + 1)}
    if n != expect or not any(n.values()):
        fail(f"mesh: {cfg.name}'s decode on the mesh launched {n}, expected {expect}")
    if not all(isinstance(t, DTensor) for layer in state for t in layer):
        fail(f"mesh: {cfg.name}'s decode state left the mesh")
    err = mesh_held(got, want, f"{cfg.name}'s decode logits")
    bit_equal = torch.equal(got, want) and torch.equal(tokens, want_tokens)
    if not bit_equal:
        fail(f"mesh: {cfg.name}'s decode on the mesh is not bit for bit the decode off it "
             f"(logits err {err:.3e}, tokens equal {torch.equal(tokens, want_tokens)})")
    del plain, meshed, dparams, state
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "width": "full" if layers else "smoke",
            "rows": rows, "prefill": prefill, "steps": steps,
            "window": cfg.window, "launches": {k: v for k, v in n.items() if v},
            "max_abs_err": err, "bit_equal": bit_equal, "seconds": seconds}


def mesh_phase() -> dict:
    """The mesh phase (``launch/mesh.py``, ``distributed/sharding.py``,
    ``MeshContext``, ``moe_ep``, ``optim/grad_compression.py``,
    ``runtime/elastic.py``, ``DeviceFeed(sharding=...)``) on a ``(1, 1)``
    mesh over an NCCL group of one rank, which the phase leaves on its way
    out. At one rank every redistribution is a no-op: each check holds the
    mesh's result to the same work off the mesh at MESH_TOL and says
    whether they are equal bit for bit. The kernels' launches are counted
    from 0 around each mesh run and must be above 0."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.func import functional_call

    from repro_torch.configs import get, get_smoke
    from repro_torch.core.device_pipeline import DeviceFeed
    from repro_torch.distributed.sharding import NamedSharding, batch_spec, data_axis_names
    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
    from repro_torch.launch.train import train_step_of
    from repro_torch.models import moe as MOE
    from repro_torch.models.lm import LM, MeshContext
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.grad_compression import (compress_tree, decompress_tree,
                                                    psum_compressed)
    from repro_torch.runtime.elastic import remesh
    from repro_torch.runtime.train_loop import params_of

    t0 = time.perf_counter()
    counters = lm_train_counters()
    rng = np.random.default_rng(SEED + 9)
    mesh = make_host_mesh(1, device="cuda")
    try:
        mctx = MeshContext(mesh, data_axis_names(mesh), "model")
        line = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "backend": torch.distributed.get_backend()}

        # StableLM-3B: MESH_STEPS donating steps off the mesh, then on it
        cfg = dataclasses.replace(get("stablelm_3b"), n_layers=MESH_LAYERS)
        plain = LM(cfg, "cuda", seed=SEED)
        meshed = LM(cfg, "cuda", mctx=mctx, seed=SEED)
        meshed.load_state_dict(plain.state_dict())
        host = [{"tokens": rng.integers(4, cfg.vocab_size, MESH_BATCH).astype(np.int64)}
                for _ in range(MESH_STEPS)]
        opt = AdamW(learning_rate=MESH_LR)
        params = {k: t.clone() for k, t in params_of(plain).items()}
        state, step = opt.init(params), train_step_of(plain, opt)
        off = []
        for b in host:
            params, state, m = step(params, state, {"tokens": torch.from_numpy(b["tokens"])
                                                    .cuda()})
            off.append(m["loss"])
        zero_counters(counters)
        t1 = time.perf_counter()
        dparams = meshed.distribute_params(params_of(meshed))
        dstate, dstep = opt.init(dparams), train_step_of(meshed, opt)
        feed = DeviceFeed(iter(host), sharding=NamedSharding(mesh, batch_spec(mesh, MESH_BATCH[0])),
                          device="cuda", prefetch=1)
        on = []
        for batch in feed:
            if not isinstance(batch["tokens"], DTensor):
                fail("mesh: DeviceFeed(sharding=...) gave a plain tensor")
            with feed.step(batch):
                dparams, dstate, m = dstep(dparams, dstate, {"tokens": batch["tokens"]})
                on.append(m["loss"])
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t1
        launches = {k: counters[k][k] for k in ("flash_attention", "flash_attention_bwd")}
        if not all(launches.values()) or len(on) != MESH_STEPS:
            fail(f"mesh: the sharded steps ran {len(on)} steps with launches {launches}")
        loss_err = mesh_held(torch.stack(on), torch.stack(off), "the sharded steps' losses")
        param_err = max(mesh_held(dparams[k].full_tensor(), params[k], f"parameter {k}")
                        for k in params)
        bit_equal = all(torch.equal(a, b) for a, b in zip(on, off)) and all(
            torch.equal(dparams[k].full_tensor(), params[k]) for k in params)
        placed = remesh(dparams, meshed.param_axes(), mesh)
        remesh_equal = all(torch.equal(placed[k].full_tensor(), dparams[k].full_tensor())
                           for k in dparams)
        if not remesh_equal:
            fail("mesh: a remesh round trip changed a parameter")
        line["stablelm"] = {
            "arch": cfg.name, "layers": MESH_LAYERS, "published_layers": get("stablelm_3b").n_layers,
            "batch": list(MESH_BATCH), "steps": MESH_STEPS, "lr": MESH_LR,
            "losses_on": [float(x) for x in on], "losses_off": [float(x) for x in off],
            "loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
            "bit_equal": bit_equal, "remesh_bit_equal": remesh_equal,
            "launches": launches, "seconds": train_seconds}
        del plain, meshed, params, state, dparams, dstate, placed
        torch.cuda.empty_cache()

        # the recurrent families' forwards at SMOKE, their kernels on the mesh
        line["forwards"] = []
        for arch, kernel in (("recurrentgemma_9b", "rg_lru"), ("xlstm_1_3b", "mlstm_chunk")):
            cfg = get_smoke(arch)
            plain = LM(cfg, "cuda", seed=SEED)
            meshed = LM(cfg, "cuda", mctx=mctx, seed=SEED)
            meshed.load_state_dict(plain.state_dict())
            tokens = torch.from_numpy(rng.integers(4, cfg.vocab_size, MESH_FORWARD_BATCH)).cuda()
            want = plain({"tokens": tokens})
            zero_counters(counters)
            dparams = meshed.distribute_params(params_of(meshed))
            got = functional_call(meshed, {k.replace("/", "."): v for k, v in dparams.items()},
                                  ({"tokens": tokens},))
            torch.cuda.synchronize()
            n = {k: counters[k][k] for k in ("flash_attention", "rg_lru", "mlstm_chunk")}
            if not n[kernel]:
                fail(f"mesh: {cfg.name}'s forward on the mesh launched no {kernel}")
            err = mesh_held(got.full_tensor(), want, f"{cfg.name}'s logits")
            line["forwards"].append({"arch": cfg.name, "batch": list(MESH_FORWARD_BATCH),
                                     "launches": {k: v for k, v in n.items() if v},
                                     "max_abs_err": err,
                                     "bit_equal": torch.equal(got.full_tensor(), want)})

        # decoding on the mesh, each kernel on the state's local blocks
        line["decodes"] = [mesh_decode(mctx, counters, rng, *case) for case in MESH_DECODES]

        # one DeepSeek-MoE-16B MoE layer at full width through moe_ep
        cfg = get("deepseek_moe_16b")
        g = torch.Generator(device="cuda").manual_seed(SEED + 10)
        p = MOE.init_moe(cfg, g, device="cuda")
        x = torch.randn((*MESH_MOE_TOKENS, cfg.d_model), generator=g, device="cuda") * 0.5
        want_y, want_aux = MOE.moe_local(p, x, cfg)
        rep, ex = [Replicate(), Replicate()], [Replicate(), Shard(0)]
        pd = {k: DTensor.from_local(p[k], mesh, ex if k.startswith("w_") else rep)
              for k in ("router", "w_gate", "w_up", "w_down")}
        t1 = time.perf_counter()
        y, aux = MOE.moe_ep(pd, DTensor.from_local(x, mesh, [Shard(0), Replicate()]), cfg,
                            mesh, ("data",), "model")
        y, aux = y.full_tensor(), aux.full_tensor()
        torch.cuda.synchronize()
        line["moe_ep"] = {"arch": cfg.name, "experts": cfg.moe.n_experts,
                          "d_model": cfg.d_model, "d_expert": cfg.moe.d_expert,
                          "tokens": list(MESH_MOE_TOKENS),
                          "y_max_abs_err": mesh_held(y, want_y, "moe_ep's y"),
                          "aux_abs_err": mesh_held(aux, want_aux, "moe_ep's aux"),
                          "bit_equal": torch.equal(y, want_y) and torch.equal(aux, want_aux),
                          "seconds": time.perf_counter() - t1}
        # and a decode step's tokens through it: one a row
        x1 = torch.randn((*MESH_MOE_DECODE_TOKENS, cfg.d_model), generator=g, device="cuda") * 0.5
        want_y1, want_aux1 = MOE.moe_local(p, x1, cfg)
        y1, aux1 = MOE.moe_ep(pd, DTensor.from_local(x1, mesh, [Shard(0), Replicate()]), cfg,
                              mesh, ("data",), "model")
        y1, aux1 = y1.full_tensor(), aux1.full_tensor()
        line["moe_ep"]["decode"] = {
            "tokens": list(MESH_MOE_DECODE_TOKENS),
            "y_max_abs_err": mesh_held(y1, want_y1, "moe_ep's decode-step y"),
            "aux_abs_err": mesh_held(aux1, want_aux1, "moe_ep's decode-step aux"),
            "bit_equal": torch.equal(y1, want_y1) and torch.equal(aux1, want_aux1)}
        del p, pd, x, y, want_y, x1, y1, want_y1
        torch.cuda.empty_cache()

        # the int8 all-reduce over NCCL against compress -> decompress
        grads = {f"g{i}": torch.randn(shape, generator=g, device="cuda") * 10.0 ** -i
                 for i, shape in enumerate(((2560, 2560), (6912,), (3, 5, 7)))}
        summed, err = psum_compressed(grads, (mesh, data_axis_names(mesh)))
        q, s, err_ref = compress_tree(grads)
        deq = decompress_tree(q, s)
        psum_equal = all(torch.equal(summed[k], deq[k]) and torch.equal(err[k], err_ref[k])
                         for k in grads)
        if not psum_equal:
            fail("mesh: psum_compressed over NCCL differs from compress -> decompress")
        line["psum_compressed"] = {"leaves": {k: list(t.shape) for k, t in grads.items()},
                                   "bit_equal": psum_equal}
    finally:
        destroy_process_group()
    torch.cuda.empty_cache()
    runs = line["forwards"] + line["decodes"]
    line["launches"] = {
        "flash_attention": line["stablelm"]["launches"]["flash_attention"]
        + sum(f["launches"].get("flash_attention", 0) for f in runs),
        "flash_attention_bwd": line["stablelm"]["launches"]["flash_attention_bwd"],
        **{k: sum(f["launches"].get(k, 0) for f in runs) for k in ("rg_lru", "mlstm_chunk")}}
    line["phase_seconds"] = time.perf_counter() - t0
    print(f"mesh: {line['stablelm']['arch']} at {MESH_LAYERS} layers, {MESH_STEPS} sharded "
          f"steps on the {line['mesh']} {line['backend']} mesh held to the steps off it "
          f"(loss err {line['stablelm']['loss_max_abs_err']:.3e}, params "
          f"{line['stablelm']['param_max_abs_err']:.3e}, bit-equal "
          f"{line['stablelm']['bit_equal']}); forwards "
          + ", ".join(f"{f['arch']} err {f['max_abs_err']:.3e} bit-equal {f['bit_equal']}"
                      for f in line["forwards"])
          + "; decodes " + ", ".join(
              f"{d['arch']} ({d['prefill']} + {d['steps']} steps) bit-equal {d['bit_equal']} "
              f"launches {d['launches']}" for d in line["decodes"])
          + f"; moe_ep y err {line['moe_ep']['y_max_abs_err']:.3e} bit-equal "
          f"{line['moe_ep']['bit_equal']}, decode step y err "
          f"{line['moe_ep']['decode']['y_max_abs_err']:.3e}; psum_compressed bit-equal; "
          f"remesh bit-equal; "
          f"launches {line['launches']}; {line['phase_seconds']:.1f} s")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    step_seconds, last = {}, [started]

    def mark(step: str) -> None:
        """Prints and keeps the seconds since the previous step ended."""
        now = time.perf_counter()
        step_seconds[step], last[0] = now - last[0], now
        print(f"step {step}: {step_seconds[step]:.1f} s", flush=True)

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

    mark("1-2 card and build")

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
    layer_gen = torch.Generator().manual_seed(SEED + 5)  # the draws above unchanged
    layer_err = check_lstm_layer_bwd(layer_gen)

    mark("3 kernels against plain")

    # 4. timings
    lstm_t = time_lstm_cell(gen, bw, flops)
    scan_t = time_text_scan(abstracts, bw)
    timed = {"flash_attention": time_flash_attention(gen, bw, flops),
             "rg_lru": time_rg_lru(gen, bw, flops),
             "mlstm_chunk": time_mlstm_chunk(gen, bw, flops)}
    bwd_t = time_lstm_cell_bwd(train_gen, bw, flops)
    layer_t = time_lstm_layer_bwd(layer_gen, bw, flops)

    mark("4 timings")

    # 5. the summarizer at CONFIG width
    launches, serve_line = serve(abstracts, titles)

    mark("5 summarizer serving")

    # 6. each LM at CONFIG width and depth, then card vs CPU at a few layers
    from repro_torch.configs import get

    lm_launches = {name: {} for name in timed}
    serve_lm_lines = []
    for arch in LM_ARCHS:
        cfg = get(arch)
        if arch in SERVE_LM_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=SERVE_LM_LAYERS[arch])
        counts, line = serve_lm(cfg)
        if arch in SERVE_LM_LAYERS:
            line["published_layers"] = get(arch).n_layers
            line["reduced"] = (f"depth {SERVE_LM_LAYERS[arch]} of {get(arch).n_layers} layers "
                               f"(fp32 weights of all of them fill too much of the card)")
        for kernel, n in counts.items():
            if n:
                lm_launches[kernel][cfg.name] = n
        torch.cuda.empty_cache()
        line.update(lm_card_vs_cpu(cfg, CARD_VS_CPU_LAYERS[arch]))
        torch.cuda.empty_cache()
        serve_lm_lines.append(line)

    mark("6 LM serving and card vs CPU")

    # 7. preprocessing: corpus -> ingest -> pre_clean -> device cleaning
    workdir = ROOT / "build" / "chip_smoke_corpus"
    cleaned, pre_cleaned, abstracts_flat, clean_launches, preprocess_line = preprocess(workdir)
    clean_t = time_text_clean(gen, abstracts_flat, bw)
    del abstracts_flat
    torch.cuda.empty_cache()

    mark("7 preprocessing")

    # 8. the paper's comparison: the abstract column's scan, CA, P3SAPP
    scan_held, scan_column = check_p3sapp_scan(pre_cleaned)
    scan_t["p3sapp_column"] = time_text_scan_column(scan_column, bw)
    del scan_column, pre_cleaned
    torch.cuda.empty_cache()
    p3sapp_launches, p3sapp_line, p3sapp_records = p3sapp(workdir, scan_held)
    torch.cuda.empty_cache()

    mark("8 p3sapp")

    # 9. the Dataset planner on the same corpus: whole frame, streamed, cached, fed
    dataset_launches, dataset_line = dataset(workdir, p3sapp_records)
    del p3sapp_records
    torch.cuda.empty_cache()

    mark("9 dataset")

    # 10. threads against processes and remote workers on the same corpus
    executors_launches, executors_line = executors(workdir)
    torch.cuda.empty_cache()

    mark("10 executors")

    # 11. text serving through a row program of the same corpus's plan
    serve_text_launches, serve_text_line = serve_text_phase(workdir)
    shutil.rmtree(workdir)
    torch.cuda.empty_cache()

    mark("11 serve_text")

    # 12. the feed into the summarizer's encoder
    feed_line = feed(cleaned)
    torch.cuda.empty_cache()

    mark("12 feed")

    # 13. training: card vs CPU, 40 steps with a checkpoint, resume
    train_line = train(cleaned)
    torch.cuda.empty_cache()

    mark("13 summarizer training")

    # 14. the LM launcher's training path: backward kernels, card vs CPU,
    # StableLM-3B at full width (4 layers, then all 32 through the donating
    # step), the launcher with a resume
    lm_train_line, lm_rows = lm_train(bw, flops)
    torch.cuda.empty_cache()

    mark("14 lm_train")

    # 15. the two configurations with a frontend: flash at their shapes,
    # card vs CPU, HuBERT X-Large at all 48 layers
    frontends_line, frontend_rows = frontends(bw, flops)
    torch.cuda.empty_cache()

    mark("15 frontends")

    # 16. bf16 training: the bf16 flash kernels against their plain
    # versions, card vs CPU, StableLM-3B at all 32 layers on train_4k's
    # microbatch
    bf16_line, bf16_rows = lm_train_bf16(bw)

    mark("16 lm_train_bf16")

    # 17. the dry run: a cell counted on meta at full size, its counted share
    # of the bf16 peak, and two steps counted on the card and on meta
    dryrun_line = dryrun_phase(bf16_line)

    mark("17 dryrun")

    # 18. the multi-device layer on a one-rank NCCL mesh
    mesh_line = mesh_phase()

    mark("18 mesh")

    # 19. report
    def train_paths(name):
        """A kernel's launches on each LM training path that reached it."""
        paths = {c["label"]: c["launches"][name] for c in lm_train_line["card_vs_cpu"]}
        paths.update({f"launcher {r['arch']}": r["launches"][name]
                      for r in lm_train_line["launcher_archs"]})
        paths[f"full depth {lm_train_line['full_depth']['arch']}"] = \
            lm_train_line["full_depth"]["launches"][name]
        paths.update({c["label"]: c["launches"][name] for c in frontends_line["card_vs_cpu"]})
        hubert = frontends_line["hubert_full_depth"]
        paths[f"{hubert['arch']} train steps"] = hubert["launches"][name]
        return {label: n for label, n in paths.items() if n}

    def lm_kernel(name, err, source, replaces):
        """Headline: the decode row, most of a serving run's launches; all
        timed rows nested; launches summed over the served LMs."""
        rows = timed[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(lm_launches[name].values()),
                "launches_by_arch": lm_launches[name],
                "launches_by_path": {**{f"serve {a}": n for a, n in lm_launches[name].items()},
                                     "mesh": mesh_line["launches"][name]},
                "max_abs_err": err,
                **{k: rows["decode"][k] for k in ("ms", "plain_ms", "library_ms", "ms_burst",
                                                  "library_ms_burst", "bound_ms", "bound_by")},
                **rows}

    def train_forward_row(name, timed_with, source, replaces, by_path, launches):
        """A training forward's row from the timings of its backward's."""
        row = lm_rows[timed_with]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": row["train_forward_max_abs_err"], "ms": row["train_forward_ms"],
                "ms_burst": row["train_forward_ms_burst"],
                "plain_ms": row["train_forward_plain_ms"],
                "bound_ms": row["train_forward_bound_ms"],
                "bound_by": row["train_forward_bound_by"],
                "library_ms": row.get("library_forward_ms"),
                "library_ms_burst": row.get("library_forward_ms_burst"),
                "library": ("scaled_dot_product_attention forward" if "library_forward_ms" in row
                            else "none: no single PyTorch call"),
                "shape": row["shape"]}

    def bf16_row(name, part, source, replaces, err):
        """A bf16 training kernel's row: its launches on the bf16 paths,
        each counted from 0 around it; its times at train_4k's microbatch
        (the full-depth run's shape), both timed shapes nested."""
        key = "flash_attention" if part == "forward" else "flash_attention_bwd"
        by_path = {c["label"]: c["launches"][key] for c in bf16_line["card_vs_cpu"]}
        by_path[f"full depth {bf16_line['full_depth']['arch']} bf16"] = \
            bf16_line["full_depth"]["launches"][key]
        for c in dryrun_line["card_vs_meta"]:
            by_path[f"dryrun {c['arch']}"] = c["launches"].get(key, 0)
        head = bf16_rows["8x4096"][part]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err,
                **{k: head[k] for k in ("ms", "ms_burst", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "library_ms_burst", "library")},
                "shape": bf16_rows["8x4096"]["shape"],
                "shapes": {label: {**r[part], "shape": r["shape"]}
                           for label, r in bf16_rows.items()}}

    kernels = [
        {"name": "lstm_cell", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
         "replaces": "src/repro/kernels/lstm_cell/lstm_cell.py:23",
         "launches": launches["lstm_cell"], "max_abs_err": lstm_err, **lstm_t,
         "train_launches": train_line["lstm_cell_launches"],
         "dataset_launches": dataset_launches["lstm_cell"],
         "executors_launches": executors_launches["lstm_cell"]},
        {"name": "text_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/text_scan.cu",
         "replaces": "src/repro/kernels/text_clean/text_clean.py:77",
         "launches": launches["text_scan"], "max_abs_err": scan_err, **scan_t,
         "p3sapp_launches": p3sapp_launches, "dataset_launches": dataset_launches["text_scan"],
         "executors_launches": executors_launches["text_scan"],
         "serve_text_launches": serve_text_launches["text_scan"]},
        {**lm_kernel("flash_attention", flash_err,
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/flash_attention.py:27"),
         "serve_text_launches": serve_text_launches["flash_attention"],
         "lm_train_launches": lm_train_line["launches"]["flash_attention"],
         "lm_train_launches_by_path": train_paths("flash_attention"),
         "frontend_forward_launches": {
             frontends_line["hubert_full_depth"]["arch"]:
                 frontends_line["hubert_full_depth"]["forward_launches"]["flash_attention"]},
         "frontend_shapes": {k: r for k, r in frontend_rows.items() if not k.startswith("train")},
         "frontend_max_abs_err": frontends_line["flash_max_abs_err"]["serve"],
         "train_forward": {k: lm_rows["flash_attention_bwd"][k] for k in
                           ("train_forward_ms", "train_forward_ms_burst", "train_forward_plain_ms",
                            "train_forward_bound_ms", "train_forward_bound_by",
                            "train_forward_max_abs_err", "shape")}},
        lm_kernel("rg_lru", rg_err, "src/repro_torch/kernels/csrc/rg_lru.cu",
                  "src/repro/kernels/rg_lru/rg_lru.py:28"),
        {**lm_kernel("mlstm_chunk", mlstm_err, "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                     "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:32"),
         "state_max_rel_err": mlstm_state_err,
         "lm_train_launches_by_path": train_paths("mlstm_chunk"),
         "train_forward": {k: lm_rows["mlstm_chunk_bwd"][k] for k in
                           ("train_forward_ms", "train_forward_ms_burst", "train_forward_plain_ms",
                            "train_forward_bound_ms", "train_forward_bound_by",
                            "train_forward_max_abs_err", "shape")}},
        {"name": "text_clean", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/text_clean.cu",
         "replaces": "src/repro/kernels/text_clean/text_clean.py:34",
         "launches": clean_launches, "max_abs_err": clean_err,
         **{k: clean_t["matrix"][k] for k in
            ("ms", "ms_burst", "plain_ms", "library_ms", "bound_ms", "bound_by")}, **clean_t},
        # off the main path since lstm_layer_bwd: only lstm_cell_op called
        # alone under grad reaches it (its launches above are 0 by design)
        {"name": "lstm_cell_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_cell_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/seq2seq.py:63 lstm_cell",
         "launches": train_line["lstm_cell_bwd_launches"], "max_abs_err": bwd_err, **bwd_t,
         "on_main_path": False,
         "dataset_launches": dataset_launches["lstm_cell_bwd"],
         "executors_launches": executors_launches["lstm_cell_bwd"]},
        {"name": "lstm_layer_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_layer_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/seq2seq.py:73 lstm_scan",
         "launches": train_line["lstm_layer_bwd_launches"], "max_abs_err": layer_err,
         **layer_t, "dataset_launches": dataset_launches["lstm_layer_bwd"],
         "executors_launches": executors_launches["lstm_layer_bwd"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/attention.py:97 sdpa",
         "launches": lm_train_line["launches"]["flash_attention_bwd"],
         "launches_by_path": {"lm_train_steps": lm_train_line["launches"]["flash_attention_bwd"],
                              **train_paths("flash_attention_bwd"),
                              "mesh": mesh_line["launches"]["flash_attention_bwd"]},
         **lm_rows["flash_attention_bwd"],
         "frontend_shapes": {k: r for k, r in frontend_rows.items() if k.startswith("train")},
         "frontend_max_abs_err": frontends_line["flash_max_abs_err"]["bwd"]},
        # the training forwards count under their serving kernels' names
        # (LAUNCHES["flash_attention"], LAUNCHES["mlstm_chunk"]): every
        # launch on the training paths below is theirs
        train_forward_row("flash_attention_train", "flash_attention_bwd",
                          "src/repro_torch/kernels/csrc/flash_attention_train.cu",
                          "none: XLA runs the training forward of "
                          "src/repro/models/attention.py:97 sdpa",
                          {"lm_train_steps": lm_train_line["launches"]["flash_attention"],
                           **train_paths("flash_attention")},
                          lm_train_line["launches"]["flash_attention"]),
        # StableLM-3B's steps have no RG-LRU layer: its launches are the
        # RecurrentGemma-9B step's, counted from 0 around that step
        {"name": "rg_lru_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rg_lru_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/rglru.py:82 rglru_scan",
         "launches": sum(c["launches"]["rg_lru_bwd"] for c in lm_train_line["card_vs_cpu"]),
         **lm_rows["rg_lru_bwd"]},
        # xLSTM-1.3B's steps card vs CPU (with and without remat) and the
        # launcher's xLSTM run, each counted from 0 around it
        {"name": "mlstm_chunk_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
         "replaces": "none: XLA differentiates src/repro/models/xlstm.py:130 _mlstm_chunked",
         "launches": sum(train_paths("mlstm_chunk_bwd").values()),
         "launches_by_path": train_paths("mlstm_chunk_bwd"), **lm_rows["mlstm_chunk_bwd"]},
        train_forward_row("mlstm_chunk_train", "mlstm_chunk_bwd",
                          "src/repro_torch/kernels/csrc/mlstm_chunk_train.cu",
                          "none: XLA runs the training forward of "
                          "src/repro/models/xlstm.py:130 _mlstm_chunked",
                          train_paths("mlstm_chunk"), sum(train_paths("mlstm_chunk").values())),
        # the bf16 training kernels count under the fp32 ones' names
        # (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]):
        # every launch on the bf16 paths is theirs
        bf16_row("flash_attention_train_bf16", "forward",
                 "src/repro_torch/kernels/csrc/flash_attention_train_bf16.cu",
                 "none: XLA runs the training forward of src/repro/models/attention.py:97 sdpa "
                 "in bf16", bf16_line["flash_max_abs_err"]["out"]),
        bf16_row("flash_attention_bwd_bf16", "backward",
                 "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
                 "none: XLA differentiates src/repro/models/attention.py:97 sdpa in bf16",
                 bf16_line["flash_max_abs_err"]["grads"]),
    ]
    for entry in kernels:
        if entry.get("on_main_path", True) and not entry["launches"]:
            fail(f"{entry['name']} was launched no time on its path")
        if entry["name"] == "lstm_cell_bwd" and entry["launches"]:
            fail(f"lstm_cell_bwd was launched {entry['launches']} times on the train path, "
                 f"which lstm_layer_bwd now takes")
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
    print(f"chip_smoke.py ran its phases in {time.perf_counter() - started:.1f} s (before the "
          f"mesh phase: {BEFORE_PHASES_SECONDS} s); by step: "
          + ", ".join(f"{step} {seconds:.1f}" for step, seconds in step_seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {**serve_line, "card": card}}))
    for line in serve_lm_lines:
        print(json.dumps({"serve_lm": {**line, "card": card}}))
    print(json.dumps({"preprocess": {**preprocess_line, "card": card}}))
    print(json.dumps({"feed": {**feed_line, "card": card}}))
    print(json.dumps({"train": {**train_line, "card": card}}))
    print(json.dumps({"p3sapp": {**p3sapp_line, "card": card}}))
    print(json.dumps({"dataset": {**dataset_line, "card": card}}))
    print(json.dumps({"executors": {**executors_line, "card": card}}))
    print(json.dumps({"serve_text": {**serve_text_line, "card": card}}))
    print(json.dumps({"lm_train": {**lm_train_line, "card": card}}))
    print(json.dumps({"frontends": {**frontends_line, "card": card}}))
    print(json.dumps({"lm_train_bf16": {**bf16_line, "card": card}}))
    print(json.dumps({"dryrun": {**dryrun_line, "card": card}}))
    print(json.dumps({"mesh": {**mesh_line, "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
