"""Quickstart with the PyTorch/CUDA port: the paper's comparison of P3SAPP
(Algorithm 1) against the conventional approach (Algorithm 2).

The port's counterpart of ``examples/quickstart.py:26-61``. It writes a
synthetic CORE-style corpus, runs ``run_p3sapp`` (each column's scan pass
on the card's ``text_scan`` kernel, the rest of the chain on the host) and
then ``run_conventional``, and prints both runs' stage timings, the
ingestion, preprocessing and cumulative reductions (paper eq. 7), the
record match per field (paper Tables 5-6) and a sample record.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --corpus-bytes 300000

It runs on the card unless ``--device cpu`` is given; on the CPU the scan
pass is the kernel's plain PyTorch version. The reference's ``explain()``
of the plan and its token-space half (``fit_vocab``, ``tokenize``,
``batched``) wait for the port of the ``Dataset`` planner.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Sequence

from repro_torch.core.p3sapp import record_match_accuracy, run_conventional, run_p3sapp
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
        pa_records, t_pa = run_p3sapp([corpus], optimize=True, device=args.device)
        ca_records, t_ca = run_conventional([corpus])

    print(f"P3SAPP ({args.device}): {t_pa.as_dict()}")
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
    return {"records": len(pa_records), "p3sapp": t_pa.as_dict(), "ca": t_ca.as_dict(),
            "reductions": reductions, "record_match": matches}


if __name__ == "__main__":
    main()
