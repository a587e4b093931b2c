#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``executors`` phase alone on the card.

    python3 tools/executors_phase.py   # on a machine with an H100, from a checkout

Builds the kernels, writes the phase's 64 MB corpus (``write_corpus``, 8
shards, seed 0) under ``build/``, and calls ``chip_smoke.executors``: the
thread, process and remote shard executors, 4 workers each, under the
``device`` backend, with every check of that phase (exact ``text_scan``,
``lstm_cell`` and ``lstm_layer_bwd`` counts, vocabularies, batches and
cache counters equal to the thread executor's, the remote epoch with a
worker SIGKILLed). About 3 minutes there against about 10 for the whole
script. The process executor's spawned workers import this script again,
which imports no torch at module level, where ``chip_smoke.py`` does: so
its workers' start is not that of the whole script. Prints the card, the
phase's lines, its launches and its ``executors`` JSON line; exits
non-zero on any failed check.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C
    from repro_torch import device
    from repro_torch.data.synthetic import write_corpus
    from repro_torch.kernels import _build

    print(device.card(), flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)
    workdir = ROOT / "build" / "executors_corpus"
    t0 = time.perf_counter()
    write_corpus(workdir, C.CORPUS_BYTES, n_files=C.CORPUS_FILES, seed=C.SEED)
    print(f"corpus written in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, line = C.executors(workdir)
    print(json.dumps({"launches": launches}))
    print(json.dumps({"executors": {**line, "card": device.card()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
