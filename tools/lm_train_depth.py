#!/usr/bin/env python3
"""Train StableLM-3B at full width cut to a few layers on the card, with the
flash kernels or with their plain versions, and print the losses.

    python3 tools/lm_train_depth.py --layers 8 --lr 3e-3 [--plain]   # on a machine with an H100

The steps of ``chip_smoke.py``'s ``lm_train`` phase at another depth or
learning rate: rows of the LM launcher's ``build_dataset`` (a 2 MB corpus,
seed 0) built on the card, ``make_train_step`` over ``LM.loss`` (remat)
with AdamW on ``warmup_cosine(lr, 10, steps)``, batches of 8 x 64 drawn
from seed 0. With ``--plain`` the attention's training forward and
backward run their plain versions on the card (``flash_attention_train_ref``,
``flash_attention_bwd_ref``) in place of the kernels, so a loss curve that
the two share is the depth's and the learning rate's, not a kernel's.
Prints one JSON line (losses, gradient norms, the steps' peak
``torch.cuda.max_memory_allocated``) and the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref,
    flash_attention_train_ref,
)
from repro_torch.launch.train import build_dataset  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adamw import AdamW, warmup_cosine  # noqa: E402
from repro_torch.runtime.train_loop import functional_loss, make_train_step, params_of  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--plain", action="store_true",
                    help="the attention's plain versions on the card in place of the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lm_train_depth: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.plain:
        flash_ops.flash_attention_train = flash_attention_train_ref
        flash_ops.flash_attention_bwd = flash_attention_bwd_ref
    cfg = dataclasses.replace(get("stablelm_3b"), n_layers=args.layers)
    seqs = build_dataset(cfg, 64, 2.0, seed=0, device="cuda")
    model = LM(cfg, "cuda", seed=0)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps))
    step = make_train_step(functional_loss(model), opt)
    params = params_of(model)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    losses, norms = [], []
    for _ in range(args.steps):
        idx = rng.integers(0, len(seqs), size=8)
        batch = {"tokens": torch.from_numpy(seqs[idx]).cuda()}
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    print(json.dumps({"layers": args.layers, "lr": args.lr, "plain": args.plain,
                      "flash_launches": dict(flash_ops.LAUNCHES), "losses": losses,
                      "grad_norms": norms,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()}))
    print(device.card())


if __name__ == "__main__":
    main()
