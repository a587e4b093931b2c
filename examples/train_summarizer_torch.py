"""Train the paper's summarizer with the PyTorch/CUDA port (paper §4.2.3).

The port's counterpart of ``examples/train_summarizer.py``, on the same
``Dataset`` chain (``examples/train_summarizer.py:50-78``):
``write_corpus`` -> ``from_json_dirs`` -> ``where(keep)`` ->
``drop_duplicates`` -> ``transform(abstract=abstract_expr(),
title=title_expr())`` -> ``where(keep)``, executed once (the scan passes
on the card's ``text_scan`` kernel) -> ``fit_vocab`` -> ``split(0.1)`` ->
``tokenize(seq2seq_specs)`` -> ``batched`` on the paired 2-D bucket grid
-> ``prefetch(2)`` -> ``make_input_pipeline(overlap=True)``, a
``DeviceFeed`` -> ``TrainController`` over ``make_train_step`` with AdamW
and ``warmup_cosine`` (checkpoints every 100 steps, resume on restart) ->
the validation loss on 64 rows and 3 greedy titles (Algorithm 3).

    PYTHONPATH=src python examples/train_summarizer_torch.py --steps 300
    PYTHONPATH=src python examples/train_summarizer_torch.py --smoke --device cpu \\
        --steps 20 --corpus-mb 1

It runs on the card unless ``--device cpu`` is given. ``--profile`` traces
one more train step with ``torch.profiler`` and prints where its device
time goes.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Sequence

import torch

from repro_torch.configs.p3sapp_summarizer import CONFIG, SMOKE
from repro_torch.core.dataset import Dataset
from repro_torch.core.expr import abstract_expr, col, title_expr
from repro_torch.data.batching import seq2seq_specs
from repro_torch.data.synthetic import write_corpus
from repro_torch.data.tokenizer import PAD
from repro_torch.launch.serve import profile
from repro_torch.models.seq2seq import Seq2Seq
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainController
from repro_torch.runtime.train_loop import (
    functional_loss,
    make_input_pipeline,
    make_train_step,
    params_of,
)


def clean_dataset(corpus_dir: str, device) -> Dataset:
    """The reference example's cleaning chain, its terminals on ``device``."""
    keep = col("title").not_empty() & col("abstract").not_empty()
    return (
        Dataset.from_json_dirs([corpus_dir])
        .where(keep)
        .drop_duplicates()
        .transform(abstract=abstract_expr(), title=title_expr())
        .where(keep)
        .device(device)
    )


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--corpus-mb", type=float, default=4.0)
    ap.add_argument("--smoke", action="store_true", help="tiny model config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more train step and print device time by kernel")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = SMOKE if args.smoke else CONFIG
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="p3sapp_corpus_") as corpus:
        write_corpus(corpus, total_bytes=int(args.corpus_mb * 1e6), n_files=8, seed=1)
        clean = clean_dataset(corpus, device)
        # the one pass over the corpus; every terminal below reuses its frame
        records, timings = clean.execute(optimize=True)
    print(f"P3SAPP preprocessing: {timings.cumulative:.2f}s, {len(records)} records")
    tok = clean.fit_vocab(vocab_size=cfg.vocab_size)
    train_ds, val_ds = clean.split(val_fraction=0.1, seed=0)
    specs = seq2seq_specs(cfg.max_abstract_len, cfg.max_title_len)
    train_batches = (train_ds.tokenize(tok, specs)
                     .batched(args.batch_size, shuffle=True,
                              bucket_by=("encoder_tokens", "decoder_tokens"))
                     .prefetch(2))
    val = val_ds.tokenize(tok, specs).arrays()
    n_val = len(val["encoder_tokens"])
    print(f"preprocessing: {time.perf_counter() - t0:.2f}s; train={len(records) - n_val} "
          f"val={n_val}")

    model = Seq2Seq(cfg, device, seed=0)
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, args.steps), weight_decay=1e-4)
    train_step = make_train_step(functional_loss(model), opt)
    feed = make_input_pipeline(train_batches, epochs=None, overlap=True, device=device)
    grid = feed.grid
    tokens = []

    def fed_step(params, opt_state, batch):
        with feed.step(batch):
            tokens.append(sum(int((batch[k] != PAD).sum()) for k in grid.widths))
            out = train_step(params, opt_state, batch)
            sync()
        return out

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="p3sapp_ckpt_")
    controller = TrainController(ckpt_dir, fed_step, init_state, save_every=100)
    if controller.resumed:
        print(f"resumed from step {controller.step}")
    t1 = time.perf_counter()
    try:
        history = controller.run(iter(feed), n_steps=args.steps)
    finally:
        feed.close()
    seconds = time.perf_counter() - t1
    report = feed.report()
    if history:
        print(f"step {history[0]['step']}: loss={history[0]['loss']:.3f}")
        print(f"step {history[-1]['step']}: loss={history[-1]['loss']:.3f}")
        print(f"{len(history)} steps in {seconds:.2f}s ({seconds / len(history) * 1e3:.1f} ms a "
              f"step, {sum(tokens) / seconds:.0f} training tokens/s); device idle "
              f"{report.device_idle_fraction:.2%} by the feed's report")

    # validation loss + greedy samples (paper Algorithm 3)
    model.load_state_dict({k.replace("/", "."): v for k, v in controller.params.items()})
    head = {k: torch.from_numpy(v[:64]).to(device) for k, v in val.items()}
    with torch.no_grad():
        val_loss = float(model.loss(head))
    print(f"val loss: {val_loss:.3f}")
    gen = model.generate(head["encoder_tokens"][:3]).cpu().numpy()
    for i in range(min(3, len(gen))):
        print(f"  gold: {tok.decode(val['decoder_tokens'][i])}")
        print(f"  pred: {tok.decode(gen[i])}\n")
    if args.profile:
        host = next(iter(train_batches.iter_batches()))
        batch = {k: torch.from_numpy(v).to(device) for k, v in grid.snap(host).items()}
        profile(lambda: train_step(controller.params, controller.opt_state, batch), device,
                sync, f"train step at {tuple(batch['encoder_tokens'].shape)} encoder, "
                      f"{tuple(batch['decoder_tokens'].shape)} decoder tokens")
    print(f"total wall time: {time.perf_counter() - t0:.1f}s")
    return {"history": history, "val_loss": val_loss, "seconds": seconds,
            "tokens": sum(tokens), "report": report.as_dict(), "step": controller.step}


if __name__ == "__main__":
    main()
