"""LM training launcher, on one card or over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b --smoke \\
        --steps 30 --batch 8 --seq-len 64 --ckpt /tmp/run1 --device cpu

    # four ranks, a (2, 2) mesh of (data, model)
    PYTHONPATH=src python -m repro_torch.launch.env --devices 4 -- \\
        python -m repro_torch.launch.train --smoke --device cpu --model-parallel 2

Copy of ``repro/launch/train.py``: P3SAPP preprocessing on the port's
``Dataset`` planner (the scan passes on the card's ``text_scan`` kernel) ->
packed LM token rows -> the microbatched train step over ``LM.loss`` ->
the fault-tolerant checkpointed loop (resume from the latest committed
step on restart). It runs on the card unless ``--device`` names another.

With ``--model-parallel N`` above 1, ``--production-mesh`` or more than
one rank (``torchrun``'s ``WORLD_SIZE``), it trains as the reference does
over its mesh (``repro/launch/train.py:86-116``): ``make_host_mesh`` or
``make_production_mesh`` (256 ranks), ``MeshContext(mesh,
data_axis_names(mesh), "model")``, parameters placed by
``tree_shardings(..., DEFAULT_RULES)``, each batch's rows over the data
axes and ``TrainController`` restoring with those shardings. Every rank
builds the same token rows from the same seed and draws the same batches;
only rank 0 prints the history. On one rank without those flags no mesh is
made, and the step is the one-card step bit for bit. ``jax.jit(step,
donate_argnums=(0, 1))`` is ``train_step_of``, the donating step
(``make_train_step(..., donate=True)``: params and AdamW state updated in
place), which lets StableLM-3B train at all 32 layers on one card.
``--arch qwen2_vl_72b`` trains on the token rows alone (no patches), as the
reference does. ``--arch hubert_xlarge`` is refused up front: its loss
needs frames and labels, which the token rows cannot give (the reference's
launcher fails on it inside ``LM.loss``); it trains through
``make_train_step`` over ``LM.loss`` with frame batches. The reference's
``apply_tuned_env`` (XLA flags and tcmalloc for forked workers) is left
out: nothing here reads XLA's flags, and the planner's workers are
spawned.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get, get_smoke
from ..core.async_loader import put_sharded
from ..core.dataset import Dataset
from ..core.expr import abstract_expr, col, title_expr
from ..data.synthetic import write_corpus
from ..distributed.sharding import NamedSharding, batch_spec, data_axis_names
from ..models.lm import LM, MeshContext
from ..optim.adamw import AdamW, AdamWState, warmup_cosine
from ..runtime.fault_tolerance import TrainController
from ..runtime.train_loop import TrainStepConfig, functional_loss, make_train_step, params_of
from .mesh import destroy_process_group, make_host_mesh, make_production_mesh


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
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.frontend == "audio":
        raise SystemExit(f"{cfg.name} is encoder-only: its loss needs frames and labels, which "
                         "the launcher's token rows cannot give; train it through "
                         "make_train_step over LM.loss with frame batches")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    meshed = (args.model_parallel > 1 or args.production_mesh
              or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    owned = meshed and not dist.is_initialized()  # a group this call joins, it leaves
    try:
        return _train(args, cfg, meshed)
    finally:
        if owned:
            destroy_process_group()


def _train(args, cfg, meshed: bool) -> list[dict]:
    """``main``'s run, off the mesh or, when ``meshed``, over the
    reference's mesh (``repro/launch/train.py:86-116``) on every rank of
    the process group."""
    mesh = None
    if meshed:
        mesh = (make_production_mesh(device=args.device) if args.production_mesh
                else make_host_mesh(args.model_parallel, device=args.device))
    rank = dist.get_rank() if meshed else 0
    device = torch.device(args.device)
    if meshed and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if rank == 0:
        where = (f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}" if meshed
                 else f"device={device}")
        print(f"arch={cfg.name} {where} params~{cfg.param_count() / 1e6:.1f}M")

    seqs = build_dataset(cfg, args.seq_len, args.corpus_mb, seed=0, device=device)
    mctx = MeshContext(mesh, data_axis_names(mesh), "model") if meshed else None
    model = LM(cfg, device, mctx=mctx, remat=True, dtype=torch.float32)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps))
    step = train_step_of(model, opt, args.microbatches)

    def init_state():
        params = params_of(model)
        if meshed:
            params = model.distribute_params(params)
        return params, opt.init(params)

    ckpt = args.ckpt or (tempfile.mkdtemp(prefix="p3sapp_ckpt_") if rank == 0 else None)
    shardings = None
    if meshed:  # every rank checkpoints into rank 0's directory
        ckpt = [ckpt]
        dist.broadcast_object_list(ckpt, src=0)
        ckpt = ckpt[0]
        placed = model.param_shardings()
        shardings = (placed, AdamWState(None, placed, placed))
    controller = TrainController(ckpt, step, init_state, save_every=args.save_every,
                                 shardings=shardings)
    if controller.resumed and rank == 0:
        print(f"resumed from step {controller.step}")
    bsh = NamedSharding(mesh, batch_spec(mesh, args.batch)) if meshed else None
    rng = np.random.default_rng(controller.step)

    def stream():
        while True:
            idx = rng.integers(0, len(seqs), size=args.batch)
            rows = seqs[idx]
            yield {"tokens": put_sharded(rows, bsh, device) if meshed
                   else torch.from_numpy(rows).to(device)}

    history = controller.run(stream(), n_steps=args.steps)
    if rank == 0:
        for h in history[:: max(len(history) // 6, 1)]:
            print(f"step {h['step']:5d} loss={h['loss']:.4f} gnorm={h['grad_norm']:.3f}")
        print(f"final checkpoint at step {controller.step} in {ckpt}")
    return history


if __name__ == "__main__":
    main()
