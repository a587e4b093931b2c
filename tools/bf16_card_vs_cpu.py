#!/usr/bin/env python3
"""The bf16 train step, card against CPU: the card's products under three
settings, the CPU's step under two perturbations of its roundings, and
the check's rule between every pair, over several seeds.

    python3 tools/bf16_card_vs_cpu.py [--archs xlstm_1_3b ...] [--seeds 0 1 2] [--check-flash]   # on an H100

For each architecture (``chip_smoke.CARD_VS_CPU_LAYERS`` full-width layers,
``init_scale=1``, parameters drawn in bf16 from the seed, a 2 x 64 batch of
tokens from the seed) it takes one ``value_and_grad`` of ``LM.loss`` in
bf16 on the card three times:

- ``card_reduced``: cuBLAS allowed to add its split-K partial sums in bf16
  (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  True, PyTorch's default);
- ``card``: that flag False, as the port's entry points and
  ``chip_smoke.py`` set it;
- ``card_fp32_products``: every ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
  (the products ``@``, ``matmul`` and ``einsum`` reach) whose operands are
  all bf16 computed in fp32 and rounded to bf16 once, forward, backward and
  recompute (one rounding of an fp32 sum, as the CPU's bf16 products
  give); every other operation, the kernels included, as it runs;

and on the CPU in fp32 (the same rounded parameters) and in bf16 three
times:

- ``cpu``: the step ``chip_smoke.py`` holds the card to;
- ``cpu_fp32_products``: the CPU's products as ``card_fp32_products``;
- ``cpu_mlstm_fp64``: the mLSTM's plain versions computed in fp64 and
  rounded to fp32 (an mLSTM more exact than the fp32 one).

Prints, for each architecture and seed, each step's loss, and for each
ordered pair (X, Y) of bf16 steps the gradients of X that miss
``chip_smoke.bf16_grad_misses``' rule with Y in the CPU bf16 step's place;
then the same for the step split at the residual stream as ``chip_smoke``
splits it (``bf16_split_step`` from ``cpu``'s boundary values): ``card``,
``cpu_fp32_products`` and ``cpu_mlstm_fp64`` against ``cpu``, with each
layer's output; then one JSON line, also written to ``chiprun_out/bf16_card_vs_cpu.json``.
Exits non-zero on an error, not on a miss.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]

CARD_STEPS = ("card_reduced", "card", "card_fp32_products")
CPU_STEPS = ("cpu", "cpu_fp32_products", "cpu_mlstm_fp64")
_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}


class Fp32Products(TorchDispatchMode):
    """Products over bf16 operands computed in fp32 and rounded once. A mode
    under autograd: it takes the backward's products, and a remat layer's
    recompute, as well as the forward's. Counts what it took in ``calls``."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if func in _PRODUCTS and tensors and all(t.dtype == torch.bfloat16 for t in tensors):
            self.calls += 1
            up = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
            return func(*up, **kwargs).to(torch.bfloat16)
        return func(*args, **kwargs)


def card_step(card, tokens, name: str):
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = name == "card_reduced"
    with Fp32Products() if name == "card_fp32_products" else contextlib.nullcontext():
        loss, grads = value_and_grad(functional_loss(card))(params_of(card),
                                                            {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return loss.item(), {k: g.cpu() for k, g in grads.items()}


@contextlib.contextmanager
def mlstm_fp64():
    """The mLSTM's plain versions in fp64, their outputs rounded to fp32."""
    from unittest import mock

    from repro_torch.kernels.mlstm_chunk import ops

    def in_fp64(plain):
        def run(*args, **kwargs):
            return tuple(t.float() if isinstance(t, torch.Tensor) and t.dtype == torch.float64
                         else t for t in plain(*args, dtype=torch.float64, **kwargs))
        return run

    with mock.patch.object(ops, "mlstm_chunk_train_ref", in_fp64(ops.mlstm_chunk_train_ref)), \
            mock.patch.object(ops, "mlstm_chunk_bwd_ref", in_fp64(ops.mlstm_chunk_bwd_ref)):
        yield


def cpu_step(small, state, tokens, name: str, dtype=torch.bfloat16):
    from repro_torch.models.lm import LM
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    cpu = LM(small, "meta", dtype=dtype)
    cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: t.to(dtype) if t.dtype == torch.bfloat16 else t
                         for k, t in state.items()})
    perturbed = {"cpu_fp32_products": Fp32Products, "cpu_mlstm_fp64": mlstm_fp64}
    with perturbed.get(name, contextlib.nullcontext)():
        loss, grads = value_and_grad(functional_loss(cpu))(params_of(cpu), {"tokens": tokens})
    return loss.item(), grads


def one(arch: str, seed: int) -> dict:
    import chip_smoke as C
    from repro_torch.configs import get
    from repro_torch.models.lm import LM

    small = dataclasses.replace(get(arch), n_layers=C.CARD_VS_CPU_LAYERS[arch], init_scale=1.0)
    card = LM(small, "cuda", dtype=torch.bfloat16, seed=seed)
    state = {k: t.cpu() for k, t in card.state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        4, small.vocab_size, size=(C.LM_TRAIN_CHECK_BATCH, C.LM_TRAIN_SEQ)).astype(np.int32))
    steps = {name: card_step(card, tokens, name) for name in CARD_STEPS}
    for name in CPU_STEPS:
        steps[name] = cpu_step(small, state, tokens, name)
    loss_fp32, grads_fp32 = cpu_step(small, state, tokens, "cpu", torch.float32)
    out = {"arch": small.name, "layers": small.n_layers, "seed": seed, "loss_cpu_fp32": loss_fp32,
           "losses": {name: loss for name, (loss, _) in steps.items()}, "pairs": []}
    print(f"{small.name} seed {seed}: losses "
          + ", ".join(f"{name} {loss:.6f}" for name, (loss, _) in steps.items())
          + f", cpu fp32 {loss_fp32:.6f}", flush=True)
    for x, (_, gx) in steps.items():
        for y, (_, gy) in steps.items():
            if x == y or (x.startswith("card") and y.startswith("card")):
                continue
            worst, path, ratio, misses = C.bf16_grad_misses(small.name, gx, gy,
                                                            lambda: grads_fp32)
            out["pairs"].append({"steps": [x, y], "grad_worst_rel": worst, "worst_path": path,
                                 "worst_ratio": ratio, "misses": misses})
            print(f"  {x} against {y}: worst {worst:.3e} of a gradient's largest element "
                  f"({path}), "
                  f"worst distance from fp32 {ratio:.2f}x {y}'s; {len(misses)} misses"
                  + "".join(f"\n    {m['path']}: {m['rel']:.3e}; from fp32 {m['from_fp32']:.3e} "
                            f"where {y}'s is {m['cpu_from_fp32']:.3e}" for m in misses),
                  flush=True)
    out["split"] = split(small, state, tokens, card)
    del card
    torch.cuda.empty_cache()
    return out


def split(small, state, tokens, card) -> list:
    """``chip_smoke``'s split step (each layer, the embedding and the head
    alone on the CPU's bf16 residual stream) of the card and of the CPU's
    perturbed steps, each held to the rule against the CPU's bf16 and fp32
    split steps."""
    import chip_smoke as C
    from repro_torch.models.lm import LM
    from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

    def model(dtype):
        m = LM(small, "meta", dtype=dtype)
        m.to_empty(device="cpu")
        m.load_state_dict({k: t.to(dtype) if t.dtype == torch.bfloat16 else t
                           for k, t in state.items()})
        return m

    cpu = model(torch.bfloat16)
    with C.residual_stream(cpu) as (xs, dxs):
        value_and_grad(functional_loss(cpu))(params_of(cpu), {"tokens": tokens})
    dxs = [dxs[i] for i in range(len(xs))]
    want, outs = C.bf16_split_step(cpu, tokens, xs, dxs)
    want32 = C.bf16_split_step(model(torch.float32), tokens, xs, dxs)[0]
    got = {"card": C.bf16_split_step(card, tokens, xs, dxs),
           "cpu_fp32_products": None, "cpu_mlstm_fp64": None}
    with Fp32Products():
        got["cpu_fp32_products"] = C.bf16_split_step(cpu, tokens, xs, dxs)
    with mlstm_fp64():
        got["cpu_mlstm_fp64"] = C.bf16_split_step(cpu, tokens, xs, dxs)
    rows = []
    for name, (grads, layer_outs) in got.items():
        out_err = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                      for a, b in zip(layer_outs, outs))
        worst, path, ratio, misses = C.bf16_grad_misses(small.name, grads, want, lambda: want32)
        rows.append({"step": name, "grad_worst_rel": worst, "worst_path": path,
                     "worst_ratio": ratio,
                     "misses": misses, "layer_output_rel": out_err})
        print(f"  split, {name} against cpu: worst {worst:.3e} of a gradient's largest "
              f"element ({path}), worst distance from fp32 {ratio:.2f}x cpu's, layer outputs "
              f"{out_err:.3e}; {len(misses)} misses"
              + "".join(f"\n    {m['path']}: {m['rel']:.3e}; from fp32 {m['from_fp32']:.3e} "
                        f"where cpu's is {m['cpu_from_fp32']:.3e}" for m in misses), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=["xlstm_1_3b"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--check-flash", action="store_true",
                    help="first chip_smoke's flash training checks, fp32 and bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bf16_card_vs_cpu: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device.card(), flush=True)
    _build.library()
    if args.check_flash:
        import chip_smoke as C

        C.check_flash_bwd(torch.Generator().manual_seed(C.SEED + 2))
        C.check_flash_bf16(torch.Generator().manual_seed(C.SEED + 9))
    runs = [one(arch, seed) for arch in args.archs for seed in args.seeds]
    line = json.dumps({"bf16_card_vs_cpu": runs, "card": device.card()})
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "bf16_card_vs_cpu.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
