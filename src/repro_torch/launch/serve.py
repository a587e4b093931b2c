"""Serve the title generator: abstracts in, generated titles out.

The sequence of ``examples/train_summarizer.py:108-114`` (paper Algorithm
3) as a serving call: clean -> tokenize -> greedy generate -> decode, one
batch at a time, on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch

from ..configs.p3sapp_summarizer import CONFIG, SMOKE
from ..core.clean import clean_abstracts, clean_titles
from ..data.synthetic import abstracts_and_titles
from ..data.tokenizer import WordTokenizer
from ..models.seq2seq import Seq2Seq


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


def main(argv: Sequence[str] | None = None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", help="tiny model config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more batch with torch.profiler and print device "
                         "time by kernel and the device's busy share")
    args = ap.parse_args(argv)

    cfg = SMOKE if args.smoke else CONFIG
    device = torch.device(args.device)
    abstracts, titles = abstracts_and_titles(args.requests, seed=args.seed)
    tok = WordTokenizer.fit(clean_abstracts(abstracts, device) + clean_titles(titles, device),
                            vocab_size=cfg.vocab_size)
    model = Seq2Seq(cfg, device, seed=args.seed)
    serve_abstracts(model, tok, abstracts[: args.batch_size])  # warm-up: build, library init

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = serve_abstracts(model, tok, abstracts, batch_size=args.batch_size)
    sync()
    dt = time.perf_counter() - t0
    n_words = sum(len(t.split()) for t in out)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"served {len(out)} requests / {n_words} title words in {dt:.3f}s "
          f"({n_words / dt:.1f} words/s, {len(out) * cfg.max_title_len / dt:.1f} "
          f"decode tokens/s) on {where}")
    for a, t in list(zip(abstracts, out))[:3]:
        print(f"  {a[:60]!r}... -> {t!r}")
    if args.profile:
        profile_batch(model, tok, abstracts[: args.batch_size], sync)


def profile_batch(model: Seq2Seq, tok: WordTokenizer, batch: Sequence[str], sync) -> None:
    """Trace one served batch; print device time by kernel and the share of
    the batch's wall time in which the device ran a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        serve_abstracts(model, tok, batch, batch_size=len(batch))
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    stats = prof.key_averages()
    print(stats.table(sort_by="self_device_time_total", row_limit=15))
    # kernels only: an operator's own device time repeats its kernels'
    busy_us = sum(e.self_device_time_total for e in stats if e.device_type == DeviceType.CUDA)
    print(f"profiled batch of {len(batch)}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.2%}), idle {1 - busy_us / wall_us:.2%}")


if __name__ == "__main__":
    main()
