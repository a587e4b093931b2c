#!/usr/bin/env python3
"""Time the byte kernels of this checkout beside those of another checkout.

    python3 tools/byte_kernel_times.py [--baseline DIR]   # on a machine with an H100

Builds ``csrc/text_clean.cu`` and ``csrc/text_scan.cu`` of this checkout,
and of the checkout at DIR where one is given (for example a ``git
archive`` of an earlier commit), with nvcc into ``build/byte_kernel_times/``,
each pair into a library of its own, and times each library's kernels in
turns (baseline, this, this, baseline), in one process on one card, at the
shapes ``chip_smoke.py`` times: ``text_clean`` over a 4,096 x 512 matrix
and over the abstract column of ``chip_smoke.py``'s corpus (written,
ingested and pre-cleaned as there), and ``text_scan`` over one served batch
of 64 abstracts with all three flags. Every launch's output is first held
against the plain version. Two timers, as in ``chip_smoke.py``: ``ms``, the
median of 60 launches each between two CUDA events, and ``ms_burst``, 200
launches back to back. Prints one JSON line a turn and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (inputs and timers of the smoke script)
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "byte_kernel_times"


def build(label: str, csrc: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{label}.so"
    srcs = [str(csrc / "text_clean.cu"), str(csrc / "text_scan.cu")]
    p = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", *srcs, "-o", str(so)],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"byte_kernel_times: nvcc failed for {label}:\n{p.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for name in ("text_clean", "text_scan"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
    return lib


def cases():
    """label -> (kernel name, input, offsets or None, arguments after the
    pointers, plain version's output)."""
    from repro_torch.core.ingest import ingest, pre_clean
    from repro_torch.data.synthetic import abstracts_and_titles, write_corpus
    from repro_torch.kernels.text_clean.ref import (text_clean_flat_ref, text_clean_ref,
                                                    text_scan_ref)

    gen = torch.Generator().manual_seed(cs.SEED)
    mat = torch.randint(32, 127, (4096, 512), generator=gen, dtype=torch.uint8).cuda()
    corpus = ROOT / "build" / "byte_kernel_times_corpus"
    write_corpus(corpus, cs.CORPUS_BYTES, n_files=cs.CORPUS_FILES, seed=cs.SEED)
    column = cs.flat_column(pre_clean(ingest([corpus], cs.FIELDS), list(cs.FIELDS))["abstract"])
    abstracts, _ = abstracts_and_titles(cs.N_CORPUS, seed=cs.SEED)
    batch = cs.flat_rows(abstracts[:cs.BATCH])
    flags = dict(lower=True, strip_html=True, strip_parens=True)
    n_abs = column[1].numel() - 1
    return {
        "text_clean matrix": ("text_clean", mat.view(-1), None, (4096, 512, 1),
                              text_clean_ref(mat).view(-1)),
        "text_clean abstracts": ("text_clean", column[0], column[1], (n_abs, 0, 1),
                                 text_clean_flat_ref(*column)),
        "text_scan batch": ("text_scan", batch[0], batch[1],
                            (batch[1].numel() - 1, 1, 1, 1), text_scan_ref(*batch, **flags)),
    }


def time_library(lib, label: str, inputs) -> dict:
    stream = torch.cuda.current_stream().cuda_stream
    row = {"library": label}
    for case, (name, buf, offsets, args, want) in inputs.items():
        out = torch.empty_like(buf)
        fn = getattr(lib, name)

        def run():
            err = fn(buf.data_ptr(), out.data_ptr(),
                     None if offsets is None else offsets.data_ptr(), *args, stream)
            if err:
                raise SystemExit(f"byte_kernel_times: {label} {name} launch failed ({err})")

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"byte_kernel_times: {label} {case} differs from the plain version")
        row[case] = {"ms": cs.device_ms(run), "ms_burst": cs.device_ms_burst(run)}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("byte_kernel_times: needs a CUDA card")
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, help="root of another checkout")
    opts = parser.parse_args()
    from repro_torch.device import card

    this = build("this", _build.CSRC)
    libs = [("this", this), ("this", this)]
    if opts.baseline:
        base = build("baseline", opts.baseline / "src" / "repro_torch" / "kernels" / "csrc")
        libs = [("baseline", base), *libs, ("baseline", base)]
    inputs = cases()
    for label, lib in libs:
        time_library(lib, label, inputs)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
