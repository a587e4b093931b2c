"""Quickstart with the PyTorch/CUDA port: the paper's pipeline as one lazy
``Dataset`` plan, against the conventional approach (Algorithm 2).

The port's counterpart of ``examples/quickstart.py``. It writes a
synthetic CORE-style corpus, declares the P3SAPP flow (ingest -> filter ->
per-column expressions -> records) as one chain and prints its
``explain()``: ``where`` predicates on raw byte buffers pushed toward the
source, expression chains fused per column. It executes the plan (each
column's scan pass on the card's ``text_scan`` kernel, the rest of the
chain on the host), runs ``run_conventional``, and prints both runs' stage
timings, the ingestion, preprocessing and cumulative reductions (paper eq.
7), the record match per field (paper Tables 5-6) and a sample record.
The same plan then carries into token space: ``fit_vocab`` -> ``tokenize``
-> fixed, length-bucketed and paired 2-D ``batched`` batches, with their
pad fractions.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --corpus-bytes 300000

It runs on the card unless ``--device cpu`` is given; on the CPU the scan
pass is the kernel's plain PyTorch version.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Sequence

from repro_torch.core.dataset import Dataset
from repro_torch.core.expr import abstract_expr, col, title_expr
from repro_torch.core.p3sapp import record_match_accuracy, run_conventional
from repro_torch.data.batching import pad_token_fraction, seq2seq_specs
from repro_torch.data.synthetic import write_corpus

FIELDS = ("title", "abstract")


def reduction(pa: float, ca: float) -> float:
    """Per cent of the conventional approach's time saved (paper eq. 7)."""
    return 100 * (1 - pa / ca)


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--corpus-bytes", type=int, default=3_000_000)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="p3sapp_quickstart_") as corpus:
        write_corpus(corpus, args.corpus_bytes, n_files=6, seed=42)
        # Nothing below executes until .execute(): the chain is a logical
        # plan the planner fuses (per-column expression chains) and
        # reorders (where-predicate pushdown).
        keep = col("title").not_empty() & col("abstract").not_empty()
        ds = (
            Dataset.from_json_dirs([corpus])
            .where(keep)
            .drop_duplicates()
            .transform(abstract=abstract_expr(), title=title_expr())
            .where(keep)
            .device(args.device)
        )
        plan = ds.explain()
        print(plan)
        pa_records, t_pa = ds.execute(optimize=True)
        ca_records, t_ca = run_conventional([corpus])

    print(f"\nP3SAPP ({args.device}): {t_pa.as_dict()}")
    print(f"CA              : {t_ca.as_dict()}")
    reductions = {stage: reduction(getattr(t_pa, stage), getattr(t_ca, stage))
                  for stage in ("ingestion", "preprocessing", "cumulative")}
    for stage, r in reductions.items():
        print(f"{stage + ' reduction':23s}: {r:.1f}%")
    matches = {}
    for field in FIELDS:
        matches[field] = record_match_accuracy(ca_records, pa_records, field)["percentage"]
        print(f"record match ({field:8s}): {matches[field]:.2f}%")

    print("\nsample cleaned record:")
    r = pa_records[0]
    print(f"  title   : {r['title'][:70]}")
    print(f"  abstract: {r['abstract'][:70]}...")

    # -- token space: the same plan, continued ------------------------------
    # The cleaned frame above is memoized, so none of this re-reads or
    # re-cleans the corpus.
    tok = ds.fit_vocab(vocab_size=4000)
    specs = seq2seq_specs(max_abstract_len=64, max_title_len=12)
    runs = {
        "fixed": ds.tokenize(tok, specs).batch(32, shuffle=False),
        "bucketed": ds.tokenize(tok, specs).batched(32, shuffle=False,
                                                    bucket_by="encoder_tokens"),
        "paired 2-D": ds.tokenize(tok, specs).batched(
            32, shuffle=False, bucket_by=("encoder_tokens", "decoder_tokens")),
    }
    batches = {name: list(chain.iter_batches()) for name, chain in runs.items()}
    print(f"\nvocab: {len(tok)} words, {len(batches['bucketed'])} batches")
    pad = {}
    for name, bs in batches.items():
        pad[name] = {c: pad_token_fraction(bs, c) for c in ("encoder_tokens", "decoder_tokens")}
        print(f"pad fraction {name:10s}: encoder {100 * pad[name]['encoder_tokens']:.1f}%  "
              f"decoder {100 * pad[name]['decoder_tokens']:.1f}%")
    shapes = sorted({(b["encoder_tokens"].shape[1], b["decoder_tokens"].shape[1])
                     for b in batches["paired 2-D"]})
    print(f"paired (encoder, decoder) widths: {shapes}")
    return {"records": len(pa_records), "p3sapp": t_pa.as_dict(), "ca": t_ca.as_dict(),
            "reductions": reductions, "record_match": matches, "explain": plan,
            "vocab": len(tok), "pad_fraction": pad, "paired_widths": shapes}


if __name__ == "__main__":
    main()
