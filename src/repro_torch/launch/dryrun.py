"""The dry run: every (configuration × shape) cell's FLOPs, bytes and memory,
counted on meta tensors.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for a 256- or 512-device mesh and reads the compiled program. The
port counts the step it runs: ``launch/hlo_cost.py`` counts one eager run
on the meta device, where nothing is computed or allocated, so a cell at
the published width and depth is counted on the CPU without a card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells stablelm_3b:train_4k

Each cell writes ``build/dryrun_torch/card/<arch>__<shape>.json``: the
counter's FLOPs, bytes, collectives and kernel calls, the memory (the
arguments' bytes, the output's, and ``temp``, the run's peak), the
analytic ``model_flops`` and whether the arguments and the peak fit one
80 GB card. A cell is one device: its per-device counts over the
reference's 256- or 512-device meshes are what is left of ROADMAP.md
Queue 1 item 6.4, so ``--mesh single`` and ``multi`` raise, and under
``--plan optimized`` the plan keys that need a mesh are listed in the
record under ``not_applied``.

A cell is built as the reference's ``build_cell`` (``:189``) builds it:
``LM(cfg, "meta", dtype=torch.bfloat16, remat=True)``; a train cell is
``make_train_step`` with AdamW and its state, donating, over
``MICRO_ROWS`` rows a microbatch; a prefill is ``decode_step`` from
position 0 into a cache of the sequence (``forward`` for a model that is
not causal); a decode is one token against a cache of the sequence. On
meta a train cell runs the whole step, all ``global_batch // micro_rows``
microbatches, but the loss and gradient of the first microbatch only: the
others replay its count (``hlo_cost.replay``), since they would only
repeat its operators (Kimi-K2's cell has 256 microbatches of 61 layers).
The batched MoE path (``--plan optimized`` for the MoE configurations)
does not run on meta: its capacity mask's shape depends on the routing,
and such a cell is recorded ``ok: false`` with that reason.

Importing this module sets nothing (the reference sets ``XLA_FLAGS`` at
import).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import SHAPES, all_cells, get
from ..models.lm import LM
from ..optim.adamw import AdamW
from ..runtime.train_loop import (TrainStepConfig, functional_loss, make_train_step, params_of,
                                  value_and_grad)
from . import hlo_cost

# Per-arch training microbatch rows (repro/launch/dryrun.py:43).
MICRO_ROWS = {
    "hubert_xlarge": 4,
    "deepseek_moe_16b": 2,
    "kimi_k2_1t_a32b": 1,
    "stablelm_3b": 8,
    "command_r_plus_104b": 1,
    "granite_20b": 2,
    "qwen2_5_32b": 2,
    "recurrentgemma_9b": 4,
    "xlstm_1_3b": 8,
    "qwen2_vl_72b": 1,
}

# The baseline plan (repro/launch/dryrun.py:416-420): full-size (non-ring)
# KV caches, ragged experts.
BASELINE_PLAN = {"cfg_updates": {"ring_kv": False}}

# --plan optimized (repro/launch/dryrun.py:77-99). ``rules`` (a sharding
# rule set) and ``seq_parallel`` need a mesh: a cell lists them under
# ``not_applied``.
OPTIMIZED_PLANS: dict[str, dict] = {
    "xlstm_1_3b": {},
    "qwen2_5_32b": {"rules": "SP_RULES", "micro_rows": 16, "seq_parallel": True,
                    "cfg_updates": {"attn_q_chunk": 0}},
    "kimi_k2_1t_a32b": {"rules": "FSDP_RULES with expert_ff over data, kv_heads and head_dim "
                                 "replicated", "micro_rows": 4, "moe_impl": "batched"},
    "deepseek_moe_16b": {"moe_impl": "batched"},
}
MESH_KEYS = ("rules", "seq_parallel")
CARD_BYTES = 80e9  # one H100's memory: a cell whose arguments and peak fit it
OUT = Path("build/dryrun_torch")


def input_specs(cfg, shape, device="meta", rows: int | None = None) -> dict[str, torch.Tensor]:
    """The inputs of a cell (``repro/launch/dryrun.py:144``): tokens
    ``(b, s)`` int32, with the vision frontend's patches ``(b,
    n_frontend_tokens, frontend_dim)`` bf16 for train and prefill; the
    audio frontend's frames ``(b, s, frontend_dim)`` bf16 (and labels for
    train); one token ``(b, 1)`` for decode. ``rows`` in place of the
    global batch. Zeros, which are valid tokens, on a device that holds
    data."""
    b, s = rows or shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s = 1

    def zeros(*dims, dtype=torch.int32):
        return torch.zeros(dims, dtype=dtype, device=device)

    if cfg.frontend == "audio":
        batch = {"frames": zeros(b, s, cfg.frontend_dim, dtype=torch.bfloat16)}
        if shape.kind == "train":
            batch["labels"] = zeros(b, s)
        return batch
    batch = {"tokens": zeros(b, s)}
    if cfg.frontend == "vision" and shape.kind != "decode":
        batch["patches"] = zeros(b, cfg.n_frontend_tokens, cfg.frontend_dim, dtype=torch.bfloat16)
    return batch


def plan_config(cfg, plan: dict):
    """``cfg`` with the plan's ``cfg_updates`` and ``moe_impl``."""
    if plan.get("cfg_updates"):
        cfg = dataclasses.replace(cfg, **plan["cfg_updates"])
    if plan.get("moe_impl") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               expert_impl=plan["moe_impl"]))
    return cfg


class ReplayGrads:
    """``grads_of`` for ``make_train_step``: the first call runs the loss
    and gradient and counts them; each later call returns fresh tensors of
    the same shapes (empty: on meta no values exist) and adds the first
    call's count to the counters listening."""

    def __init__(self, loss_fn):
        self.grads_of = value_and_grad(loss_fn)
        self.count: dict | None = None

    def __call__(self, params, batch):
        if self.count is None:
            with hlo_cost.CostCounter(exclude=(params, batch)) as counter:
                loss, grads = self.grads_of(params, batch)
            self.count = counter.result()
            self.shapes = (loss, grads)
            return loss, grads
        hlo_cost.replay(self.count)
        loss, grads = self.shapes
        return torch.empty_like(loss), {k: torch.empty_like(g) for k, g in grads.items()}


def build_cell(arch: str, shape_name: str, *, plan: dict | None = None, cfg=None, shape=None,
               device="meta", seed: int = 0):
    """-> (fn, args, extra): the cell's step and its arguments, as
    ``repro/launch/dryrun.py:189 build_cell`` makes them on one device.
    ``cfg`` and ``shape`` in place of ``get(arch)`` and ``SHAPES[shape_name]``
    (tests and ``chip_smoke.py`` cut them); ``extra`` holds
    ``n_microbatches`` and ``micro_rows`` for a train cell."""
    plan = plan or {}
    cfg = plan_config(cfg or get(arch), plan)
    shape = shape or SHAPES[shape_name]
    model = LM(cfg, device, dtype=torch.bfloat16, seed=seed, remat=True)
    # the parameters lead the arguments, as the reference's jitted steps
    # take them; a serving call reads the model's own (the same storages)
    params = params_of(model)
    if shape.kind == "train":
        micro_rows = min(plan.get("micro_rows", MICRO_ROWS.get(arch, 4)), shape.global_batch)
        n_micro = max(1, shape.global_batch // micro_rows)
        opt = AdamW(learning_rate=1e-4)
        loss_fn = functional_loss(model)
        replay = n_micro > 1 and torch.device(device).type == "meta"  # data: every microbatch
        step = make_train_step(loss_fn, opt, TrainStepConfig(n_micro), donate=True,
                               grads_of=ReplayGrads(loss_fn) if replay else None)
        batch = input_specs(cfg, shape, device, rows=n_micro * micro_rows)
        return step, (params, opt.init(params), batch), {"n_microbatches": n_micro,
                                                         "micro_rows": micro_rows}
    batch = input_specs(cfg, shape, device)
    if shape.kind == "prefill" and not cfg.causal:
        return (lambda params, batch: model.forward(batch)), (params, batch), {}
    state = model.init_decode_state(shape.global_batch, shape.seq_len)
    pos = 0 if shape.kind == "prefill" else shape.seq_len - 1
    return (lambda params, tokens, state: model.decode_step(tokens, state, pos)), \
        (params, batch["tokens"], state), {}


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs: 6·N_active·tokens (train) or 2·N_active·tokens
    (inference). Copy of ``repro/launch/dryrun.py:297``."""
    cfg = get(arch)
    shp = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch  # one token per request


def count_cell(arch: str, shape_name: str, **kw) -> dict:
    """The counter's record of one cell (``build_cell``'s arguments)."""
    fn, args, extra = build_cell(arch, shape_name, **kw)
    return {**hlo_cost.analyze(fn, *args), **extra}


def run_cell(arch: str, shape_name: str, out_dir: Path = OUT, plan: dict | None = None) -> dict:
    """Count one cell at its published size and write its record
    (``repro/launch/dryrun.py:313 run_cell``'s keys, on one device)."""
    out_path = out_dir / "card" / f"{arch}__{shape_name}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": "card", "mesh_shape": {"card": 1},
                 "n_devices": 1}
    plan = plan or {}
    if plan:
        rec["plan"] = {k: str(v)[:200] for k, v in plan.items()}
    rec["not_applied"] = [k for k in MESH_KEYS if k in plan]
    try:
        t0 = time.time()
        count = count_cell(arch, shape_name, plan=plan)
        rec["count_s"] = round(time.time() - t0, 2)
        mem = count.pop("memory")
        rec["cost_analysis"] = {"flops": count["flops"], "bytes": count["bytes"]}
        rec["hlo_cost"] = {k: v for k, v in count.items()
                           if k not in ("n_microbatches", "micro_rows")}
        rec["collectives"] = {"bytes": count["collective_bytes"],
                              "counts": count["collective_counts"],
                              "total_bytes": count["collective_total"]}
        rec["memory_analysis"] = {"argument_size_in_bytes": mem["argument"],
                                  "output_size_in_bytes": mem["output"],
                                  "temp_size_in_bytes": mem["temp"]}
        rec["fits_one_card"] = mem["argument"] + mem["temp"] <= CARD_BYTES
        rec["model_flops"] = model_flops(arch, shape_name)
        rec["params"] = get(arch).param_count()
        rec["active_params"] = get(arch).active_param_count()
        rec.update({k: count[k] for k in ("n_microbatches", "micro_rows") if k in count})
        rec["ok"] = True
    except Exception as e:  # a cell that cannot be counted is recorded, not fatal
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    out_path.write_text(json.dumps(rec, indent=1))
    if rec["ok"]:
        mem = rec["memory_analysis"]
        status = (f"OK {rec['cost_analysis']['flops']:.4e} FLOPs "
                  f"({rec['cost_analysis']['flops'] / rec['model_flops']:.3f} x model_flops), "
                  f"{rec['cost_analysis']['bytes']:.4e} bytes, arguments "
                  f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, peak "
                  f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB, "
                  f"{'fits' if rec['fits_one_card'] else 'does not fit'} one card")
    else:
        status = f"FAIL ({rec['error'][:120]})"
    print(f"[card] {arch} x {shape_name}: {status}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"], default="card")
    ap.add_argument("--cells", default="all", help="all | arch:shape[,arch:shape...]")
    ap.add_argument("--arch", default=None, help="restrict to one architecture")
    ap.add_argument("--plan", choices=["baseline", "optimized"], default="baseline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh != "card":
        raise SystemExit(f"--mesh {args.mesh}: the dry run's per-device counts over a mesh "
                         f"are what is left of ROADMAP.md Queue 1 item 6.4; a cell is one card "
                         f"(--mesh card)")
    out_dir = Path(args.out) if args.out else OUT if args.plan == "baseline" else \
        OUT.with_name("dryrun_torch_opt")
    cells = all_cells()
    if args.cells != "all":
        want = [tuple(c.split(":")) for c in args.cells.split(",")]
        cells = [c for c in cells if c in want]
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    n_fail = 0
    for arch, shape in cells:
        p = out_dir / "card" / f"{arch}__{shape}.json"
        if args.skip_existing and p.exists() and json.loads(p.read_text()).get("ok"):
            print(f"[card] {arch} x {shape}: cached OK", flush=True)
            continue
        plan = OPTIMIZED_PLANS.get(arch, {}) if args.plan == "optimized" else BASELINE_PLAN
        rec = run_cell(arch, shape, out_dir, plan=plan)
        n_fail += 0 if rec["ok"] else 1
    print(f"dry-run complete, {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
