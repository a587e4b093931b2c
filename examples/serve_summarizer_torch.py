"""Text-in/title-out serving with the PyTorch/CUDA port: the zero-skew
request path.

The port's counterpart of ``examples/serve_summarizer.py``: the same tiny
corpus, plan and vocabulary, lowered by ``Dataset.row_program()`` to the
same compiled program the shard executors run, then raw abstracts served
through ``serve_text``: a bounded admission queue, fixed decode slots
refilled by block prefill, and a ring cache that answers a repeated
abstract without touching the model. Two waves, so the repeat arrives
after the original's answer is cached. The model is the SMOKE StableLM-3B
with its vocabulary swapped for the fitted tokenizer's and random weights
from seed 0: the example exercises the serving runtime, not model
quality. It runs on the card (the row program's scan passes on the
``text_scan`` kernel, attention on ``flash_attention``) unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_summarizer_torch.py
    PYTHONPATH=src python examples/serve_summarizer_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

from repro_torch.configs import get_smoke
from repro_torch.core.dataset import Dataset
from repro_torch.core.expr import abstract_expr, col
from repro_torch.data.batching import TokenSpec
from repro_torch.device import resolve
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import RingCache, ServeStats, TextRequest, serve_text

CORPUS = [
    {"abstract": "Deep learning methods now drive scholarly data applications."},
    {"abstract": "A Spark ML pipeline cleans abstracts before model training."},
    {"abstract": "Continuous batching keeps decode slots busy between requests."},
    {"abstract": "Columnar byte kernels make text preprocessing vectorized."},
    {"abstract": "The ring cache answers repeated prompts without decoding."},
    {"abstract": "Shard executors stream token batches to the training loop."},
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve(args.device)

    # 1. Fit the plan and vocabulary on the corpus, as training would, then
    # lower it to a per-request row program.
    with tempfile.TemporaryDirectory(prefix="serve_corpus_") as tmp:
        corpus_dir = Path(tmp) / "shards"
        corpus_dir.mkdir()
        with open(corpus_dir / "shard-0.jsonl", "w", encoding="utf-8") as f:
            for rec in CORPUS:
                f.write(json.dumps(rec) + "\n")
        ds = (Dataset.from_json_dirs([corpus_dir], fields=("abstract",))
              .where(col("abstract").not_empty())
              .transform(abstract=abstract_expr())
              .device(str(device)))
        tok = ds.fit_vocab(vocab_size=200)
        row_program = ds.tokenize(tok, [TokenSpec("abstract", 32)]).batched(4).prefetch(2) \
            .row_program()
    print(f"row program: fields={row_program.fields} backend={row_program.backend} "
          f"device={row_program.device}")

    # 2. A small decoder LM stands in for a trained summarizer.
    cfg = dataclasses.replace(get_smoke("stablelm_3b"), vocab_size=len(tok.itos))
    model = LM(cfg, device, seed=0)

    # 3. Serve raw text. The last request repeats the first abstract and
    # completes from the ring cache; the empty one is filtered by the plan.
    texts = [rec["abstract"] for rec in CORPUS] + ["", CORPUS[0]["abstract"]]
    reqs = [TextRequest(uid, t, max_new=args.max_new) for uid, t in enumerate(texts)]
    cache = RingCache(slots=32)
    stats = ServeStats()
    results = dict(serve_text(model, row_program, reqs[:-1], slots=args.slots, max_seq=64,
                              cache=cache, stats=stats))
    results.update(serve_text(model, row_program, reqs[-1:], slots=args.slots, max_seq=64,
                              cache=cache, stats=stats))

    for uid in sorted(results):
        toks = results[uid]
        title = tok.decode(toks) if toks else "(filtered)"
        print(f"request {uid}: {texts[uid][:48]!r:50} -> {title!r}")
    print(f"served {stats.served}/{len(reqs)} through {args.slots} slots: "
          f"{stats.filtered} filtered, {stats.cache_hits} cache hit(s), "
          f"preprocess {stats.preprocess_s * 1e3:.1f} ms / decode {stats.decode_s * 1e3:.1f} ms")
    assert len(results) == len(reqs)
    assert stats.cache_hits >= 1 and results[len(texts) - 1] == results[0]


if __name__ == "__main__":
    main()
