"""LM training launcher on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b --smoke \\
        --steps 30 --batch 8 --seq-len 64 --ckpt /tmp/run1 --device cpu

Copy of ``repro/launch/train.py``: P3SAPP preprocessing on the port's
``Dataset`` planner (the scan passes on the card's ``text_scan`` kernel) ->
packed LM token rows -> the microbatched train step over ``LM.loss`` ->
the fault-tolerant checkpointed loop (resume from the latest committed
step on restart). It runs on the card unless ``--device`` names another.
The reference's mesh, ``tree_shardings`` and ``set_mesh`` become plain
single-card tensors, so ``--model-parallel`` above 1 and
``--production-mesh`` raise; ``jax.jit(step, donate_argnums=(0, 1))`` is
``train_step_of``, the donating step (``make_train_step(..., donate=True)``:
params and AdamW state updated in place), which lets StableLM-3B train at
all 32 layers on one card. ``--arch qwen2_vl_72b`` trains on the token rows
alone (no patches), as the reference does. ``--arch hubert_xlarge`` is
refused up front: its loss needs frames and labels, which the token rows
cannot give (the reference's launcher fails on it inside ``LM.loss``); it
trains through ``make_train_step`` over ``LM.loss`` with frame batches.
The reference's ``apply_tuned_env``
(XLA flags and tcmalloc for forked workers) is left out: nothing here
reads XLA's flags, and the planner's workers are spawned.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get, get_smoke
from ..core.dataset import Dataset
from ..core.expr import abstract_expr, col, title_expr
from ..data.synthetic import write_corpus
from ..models.lm import LM
from ..optim.adamw import AdamW, warmup_cosine
from ..runtime.fault_tolerance import TrainController
from ..runtime.train_loop import TrainStepConfig, functional_loss, make_train_step, params_of


def build_dataset(cfg, seq_len: int, corpus_mb: float, seed: int, device=None) -> np.ndarray:
    """Rows of ``seq_len`` int32 tokens: a ``write_corpus`` corpus of
    ``corpus_mb`` MB through the reference example's chain, the abstracts'
    words mapped by a vocabulary of ``cfg.vocab_size`` fitted on them (3 for
    an unknown word), concatenated and cut into rows. The chain's scans run
    on ``device`` (the card when None). Copy of
    ``repro/launch/train.py:35 build_dataset``; the corpus goes when the
    rows are made."""
    with tempfile.TemporaryDirectory(prefix="p3sapp_train_") as corpus:
        write_corpus(corpus, total_bytes=int(corpus_mb * 1e6), n_files=6, seed=seed)
        keep = col("title").not_empty() & col("abstract").not_empty()
        ds = (
            Dataset.from_json_dirs([corpus])
            .where(keep)
            .drop_duplicates()
            .transform(abstract=abstract_expr(), title=title_expr())
            .where(keep)
        )
        if device is not None:
            ds = ds.device(device)
        records, timings = ds.execute(optimize=True)
        print(f"P3SAPP: {len(records)} records in {timings.cumulative:.2f}s")
        # fit_vocab reuses the memoized frame
        tok = ds.fit_vocab(["abstract"], vocab_size=cfg.vocab_size)
    stream: list[int] = []
    for r in records:
        stream.extend(tok.stoi.get(w, 3) for w in r["abstract"].split())
    n = (len(stream) // seq_len) * seq_len
    return np.asarray(stream[:n], np.int32).reshape(-1, seq_len) % cfg.vocab_size


def train_step_of(model: LM, opt: AdamW, n_microbatches: int = 1):
    """The launcher's step: ``make_train_step`` over ``model.loss``,
    donating its params and optimizer state, as the reference launcher's
    ``jax.jit(step, donate_argnums=(0, 1))`` does."""
    return make_train_step(functional_loss(model), opt, TrainStepConfig(n_microbatches),
                           donate=True)


def main(argv: Sequence[str] | None = None) -> list[dict]:
    """Train as the flags say; returns the run's per-step metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm_3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--corpus-mb", type=float, default=2.0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh or args.model_parallel > 1:
        raise NotImplementedError(f"--model-parallel {args.model_parallel} / --production-mesh: "
                                  "the port trains on one card (multi-device training is "
                                  "ROADMAP.md Queue 1 item 6)")
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.frontend == "audio":
        raise SystemExit(f"{cfg.name} is encoder-only: its loss needs frames and labels, which "
                         "the launcher's token rows cannot give; train it through "
                         "make_train_step over LM.loss with frame batches")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    print(f"arch={cfg.name} device={device} params~{cfg.param_count() / 1e6:.1f}M")

    seqs = build_dataset(cfg, args.seq_len, args.corpus_mb, seed=0, device=device)
    model = LM(cfg, device, remat=True, dtype=torch.float32)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps))
    step = train_step_of(model, opt, args.microbatches)

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="p3sapp_ckpt_")
    controller = TrainController(ckpt, step, init_state, save_every=args.save_every)
    if controller.resumed:
        print(f"resumed from step {controller.step}")
    rng = np.random.default_rng(controller.step)

    def stream():
        while True:
            idx = rng.integers(0, len(seqs), size=args.batch)
            yield {"tokens": torch.from_numpy(seqs[idx]).to(device)}

    history = controller.run(stream(), n_steps=args.steps)
    for h in history[:: max(len(history) // 6, 1)]:
        print(f"step {h['step']:5d} loss={h['loss']:.4f} gnorm={h['grad_norm']:.3f}")
    print(f"final checkpoint at step {controller.step} in {ckpt}")
    return history


if __name__ == "__main__":
    main()
