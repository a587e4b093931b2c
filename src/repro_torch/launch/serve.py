"""Serving launcher: the title generator, or an LM through continuous batching.

``--arch p3sapp_summarizer`` (the default) serves the title generator: the
sequence of ``examples/train_summarizer.py:108-114`` (paper Algorithm 3)
as a serving call, clean -> tokenize -> greedy generate -> decode, one
batch at a time. ``--arch stablelm_3b`` (or another LM of
``repro_torch.configs.ARCH_IDS``) does what ``repro/launch/serve.py:21-55``
does: random weights from the seed, prompts of 4-15 random tokens, and
``serve_requests`` through ``--slots`` decode slots; ``--arch
qwen2_vl_72b`` serves such token prompts too (no patches), and ``--arch
hubert_xlarge`` exits with the reference's message, since an encoder-only
model has no decode serving. Both run on the card unless ``--device`` names
another.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get, get_smoke
from ..configs.p3sapp_summarizer import CONFIG, SMOKE
from ..core.clean import clean_abstracts, clean_titles
from ..data.synthetic import abstracts_and_titles
from ..data.tokenizer import WordTokenizer
from ..models.lm import LM
from ..models.seq2seq import Seq2Seq
from ..runtime.serve_loop import Request, serve_requests


def encode_abstracts(model: Seq2Seq, tok: WordTokenizer, abstracts: Sequence[str]) -> torch.Tensor:
    """Raw abstracts -> encoder tokens ``(b, max_abstract_len)`` on the
    model's device (cleaned on that device)."""
    cleaned = clean_abstracts(abstracts, model.device)
    ids = np.stack([tok.encode(t, model.cfg.max_abstract_len) for t in cleaned])
    return torch.from_numpy(ids).to(model.device)


def serve_abstracts(model: Seq2Seq, tok: WordTokenizer, abstracts: Sequence[str], *,
                    batch_size: int = 64) -> list[str]:
    """One generated title per raw abstract, in order."""
    titles: list[str] = []
    for i in range(0, len(abstracts), batch_size):
        enc = encode_abstracts(model, tok, abstracts[i : i + batch_size])
        gen = model.generate(enc).cpu().numpy()
        titles.extend(tok.decode(row) for row in gen)
    return titles


def lm_requests(cfg, n: int, *, max_new: int, seed: int = 0) -> list[Request]:
    """The prompts of ``repro/launch/serve.py:37-45``: lengths 4-15, tokens
    4..vocab-1, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [
        Request(uid=i, max_new=max_new,
                prompt=rng.integers(4, cfg.vocab_size,
                                    size=int(rng.integers(4, 16))).astype(np.int32))
        for i in range(n)
    ]


def main(argv: Sequence[str] | None = None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=["p3sapp_summarizer", *ARCH_IDS],
                    default="p3sapp_summarizer")
    ap.add_argument("--requests", type=int, default=None,
                    help="64 for the summarizer, 8 for an LM")
    ap.add_argument("--batch-size", type=int, default=64, help="summarizer batch")
    ap.add_argument("--slots", type=int, default=4, help="LM decode slots")
    ap.add_argument("--max-new", type=int, default=12, help="LM tokens per request")
    ap.add_argument("--max-seq", type=int, default=128, help="LM KV cache length")
    ap.add_argument("--smoke", action="store_true", help="tiny model config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more batch (summarizer) or one request's prefill and "
                         "decode (LM) with torch.profiler and print device time by kernel "
                         "and the device's busy share")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.arch == "p3sapp_summarizer":
        serve_summarizer(args, device, sync)
    else:
        serve_lm(args, device, sync)


def serve_summarizer(args, device: torch.device, sync: Callable[[], None]) -> None:
    cfg = SMOKE if args.smoke else CONFIG
    n = args.requests or 64
    abstracts, titles = abstracts_and_titles(n, seed=args.seed)
    tok = WordTokenizer.fit(clean_abstracts(abstracts, device) + clean_titles(titles, device),
                            vocab_size=cfg.vocab_size)
    model = Seq2Seq(cfg, device, seed=args.seed)
    serve_abstracts(model, tok, abstracts[: args.batch_size])  # warm-up: build, library init
    sync()
    t0 = time.perf_counter()
    out = serve_abstracts(model, tok, abstracts, batch_size=args.batch_size)
    sync()
    dt = time.perf_counter() - t0
    n_words = sum(len(t.split()) for t in out)
    print(f"served {len(out)} requests / {n_words} title words in {dt:.3f}s "
          f"({n_words / dt:.1f} words/s, {len(out) * cfg.max_title_len / dt:.1f} "
          f"decode tokens/s) on {_where(device)}")
    for a, t in list(zip(abstracts, out))[:3]:
        print(f"  {a[:60]!r}... -> {t!r}")
    if args.profile:
        batch = abstracts[: args.batch_size]
        profile(lambda: serve_abstracts(model, tok, batch, batch_size=len(batch)), device,
                sync, f"batch of {len(batch)}")


def serve_lm(args, device: torch.device, sync: Callable[[], None]) -> None:
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if not cfg.causal:  # repro/launch/serve.py:32-33
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    model = LM(cfg, device, seed=args.seed)
    reqs = lm_requests(cfg, args.requests or 8, max_new=args.max_new, seed=args.seed)
    kw = dict(slots=args.slots, max_seq=args.max_seq)
    serve_requests(model, reqs[:1], **kw)  # warm-up: build, library init
    sync()
    t0 = time.perf_counter()
    results = serve_requests(model, reqs, **kw)
    sync()
    dt = time.perf_counter() - t0
    n_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {n_tokens} tokens in {dt:.3f}s "
          f"({len(results) / dt:.2f} requests/s, {n_tokens / dt:.1f} tok/s through "
          f"{args.slots} slots) with {cfg.name} on {_where(device)}")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid]}")
    if args.profile:
        req = reqs[0]
        profile(lambda: serve_requests(model, [req], slots=1, max_seq=args.max_seq), device,
                sync, f"request of {len(req.prompt)} prompt tokens, {req.max_new} new")


# kernel names of csrc/*.cu, as the profiler lists them
HAND_WRITTEN = ("lstm_cell_kernel", "lstm_cell_bwd_kernel", "lstm_layer_bwd_kernel",
                "text_scan_kernel", "text_clean_kernel", "flash_attention_kernel",
                "flash_train_kernel", "flash_bwd_delta_kernel", "flash_bwd_kernel",
                "flash_bwd_dq_sum_kernel", "flash_bwd_dkv_sum_kernel", "flash_train_bf16_kernel",
                "flash_bwd_bf16_query_kernel", "flash_bwd_bf16_key_kernel",
                "flash_bwd_bf16_dkv_sum_kernel", "rg_lru_kernel",
                "rg_lru_bwd_kernel", "mlstm_chunk_kernel", "mlstm_decode_kernel",
                "mlstm_train_slices_kernel", "mlstm_train_scores_kernel",
                "mlstm_train_rows_kernel", "mlstm_bwd_slices_kernel", "mlstm_bwd_gates_kernel",
                "mlstm_bwd_state_kernel", "mlstm_bwd_products_kernel",
                "mlstm_bwd_scalars_kernel")
# substrings of cuBLAS's matrix-product kernel names, lower-cased
GEMM = ("gemm", "gemv", "nvjet")  # nvjet: cuBLAS's Hopper kernels (bf16 among them)


def _where(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def profile(fn: Callable[[], object], device: torch.device, sync: Callable[[], None],
            label: str) -> dict:
    """Trace one call of ``fn``; print device time by kernel and the share
    of its wall time in which the device ran a kernel, and return the wall
    and busy milliseconds, the idle share and the count of ``aten::mm``
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    stats = prof.key_averages()
    print(stats.table(sort_by="self_device_time_total", row_limit=15))
    # kernels only: an operator's own device time repeats its kernels'
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    for e in kernels:  # the port's hand-written kernels, wherever they rank
        if any(name in e.key for name in HAND_WRITTEN):
            print(f"  {e.key[:60]}: {e.count} launches, {e.self_device_time_total / 1e3:.3f} ms "
                  f"({e.self_device_time_total / e.count:.3f} us each, "
                  f"{e.self_device_time_total / busy_us:.2%} of the device time)")
    gemm_us = sum(e.self_device_time_total for e in kernels
                  if any(g in e.key.lower() for g in GEMM))
    if busy_us:
        print(f"  matrix products (cuBLAS gemm/gemv): {gemm_us / 1e3:.3f} ms "
              f"({gemm_us / busy_us:.2%} of the device time)")
    mm_calls = sum(e.count for e in stats if e.key == "aten::mm")
    print(f"profiled {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.2%}), idle {1 - busy_us / wall_us:.2%}; "
          f"{mm_calls} aten::mm calls")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us, "mm_calls": mm_calls}


if __name__ == "__main__":
    main()
