"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX dry
run's cost model: each cell kind's FLOPs at SMOKE size (train on 2 × 64
tokens with remat, prefill of 2 × 64, decode of 2 against a cache of 64;
bf16) counted on meta tensors against ``repro.launch.hlo_cost``'s count of
the reference's compiled step, for the attention-and-MLP families here
(the recurrent and MoE ones in ``test_torch_dryrun_mixers.py``, which
imports this file's helpers); every cell's ``model_flops`` against the
reference's formula; the grid; the CLI's records and refusals.

The JAX step is built as ``repro/launch/dryrun.py:189 build_cell`` builds
it on one device, without importing that module (it sets ``XLA_FLAGS`` at
import). The counts agree within 1% once three differences, each stated
here and exact, are taken out:

* remat: the reference checkpoints each scanned unit of layers
  (``repro/models/lm.py:291``), and XLA drops from the recompute the
  unit's last product, whose output only feeds the residual stream; the
  port checkpoints every layer (``torch.utils.checkpoint``), whose early
  stop drops each layer's last product. So the port recomputes the
  unscanned head and tail layers too, and the reference the other layers'
  last products of a unit (``remat_difference``);
* the sLSTM's scan: XLA transposes the first step's ``h @ r`` like every
  other step's; the port's first step has a constant h, so autograd skips
  its gradient (one ``2·b·dr·4dr`` product a layer);
* MoE: XLA on the CPU lowers ``jax.lax.ragged_dot`` to a dense product
  over every expert, E times the exact count, in the forward, the
  recompute and the backward (``port + (E − 1) × the port's expert
  FLOPs``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_cells as ref_all_cells
from repro.configs import get as ref_get
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.hlo_cost import analyze as ref_analyze
from repro.models.lm import LM as RefLM
from repro.optim.adamw import AdamW as RefAdamW
from repro.runtime.train_loop import TrainStepConfig as RefStepConfig
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import SHAPES, ShapeConfig, all_cells, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import analyze
from repro_torch.models.lm import LM, layer_kinds, moe_layers
from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

B, S = 2, 64  # SMOKE cells: 2 rows of 64 tokens, decode against a cache of 64
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def smoke_shape(kind: str) -> ShapeConfig:
    return ShapeConfig(kind, S, B, kind)


def port_count(arch: str, kind: str, device="meta") -> dict:
    """The dry run's count of a SMOKE cell on ``device``, one microbatch."""
    return dryrun.count_cell(arch, kind, cfg=get_smoke(arch), shape=smoke_shape(kind),
                             plan={**dryrun.BASELINE_PLAN, "micro_rows": B}, device=device)


def ref_count(arch: str, kind: str) -> dict:
    """``repro.launch.hlo_cost.analyze`` of the reference's compiled SMOKE
    cell: the donating train step with AdamW, prefill through
    ``decode_step`` from 0 (``forward`` when not causal), decode of one
    token against the cache."""
    cfg = dataclasses.replace(ref_get_smoke(arch), ring_kv=False)
    model = RefLM(cfg, remat=True, dtype=jnp.bfloat16)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    if cfg.frontend == "audio":
        batch = {"frames": sds((B, S, cfg.frontend_dim), jnp.bfloat16)}
        if kind == "train":
            batch["labels"] = sds((B, S), jnp.int32)
    else:
        batch = {"tokens": sds((B, S), jnp.int32)}
        if cfg.frontend == "vision":
            batch["patches"] = sds((B, cfg.n_frontend_tokens, cfg.frontend_dim), jnp.bfloat16)
    if kind == "train":
        opt = RefAdamW(learning_rate=1e-4)
        step = ref_make_train_step(model.loss, opt, RefStepConfig(n_microbatches=1))
        fn = jax.jit(step, donate_argnums=(0, 1))
        args = (params, jax.eval_shape(opt.init, params), batch)
    elif kind == "prefill" and not cfg.causal:
        fn, args = jax.jit(lambda p, bt: model.forward(p, bt)[0]), (params, batch)
    else:
        state = jax.eval_shape(lambda: model.init_decode_state(B, S, jnp.bfloat16))
        if kind == "prefill":
            fn = jax.jit(lambda p, t, st: model.decode_step(p, t, st, jnp.int32(0)))
            args = (params, batch["tokens"], state)
        else:
            fn = jax.jit(lambda p, t, st, pos: model.decode_step(p, t, st, pos))
            args = (params, sds((B, 1), jnp.int32), state, sds((), jnp.int32))
    return ref_analyze(fn.lower(*args).compile().as_text())


def grad_flops(cfg, remat: bool) -> float:
    model = LM(cfg, "meta", dtype=torch.bfloat16, remat=remat)
    batch = dryrun.input_specs(cfg, smoke_shape("train"))
    return analyze(value_and_grad(functional_loss(model)), params_of(model), batch)["flops"]


def recompute(cfg, kind: str, moe: bool) -> float:
    """The FLOPs the port's remat recomputes for one layer of this kind."""
    one = dataclasses.replace(
        cfg, n_layers=1, block_pattern=(kind,),
        moe=dataclasses.replace(cfg.moe, first_k_dense=0 if moe else 1) if cfg.moe else None)
    return grad_flops(one, True) - grad_flops(one, False)


def last_product(cfg, kind: str, moe: bool) -> int:
    """A layer's last product, whose output only feeds the residual
    stream: the MLP's down projection (a MoE layer's shared experts'),
    the xLSTM blocks' ``w_down``."""
    rows, d = B * S, cfg.d_model
    if kind in ("mlstm", "slstm"):
        return 2 * rows * cfg.resolved_d_rnn * d
    if moe:
        return 2 * rows * cfg.moe.n_shared * cfg.moe.d_expert * d
    return 2 * rows * (cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff) * d


def remat_difference(cfg) -> float:
    """Reference minus port FLOPs from where each recomputes (see the
    module's docstring): the reference's head (``first_k_dense``) and
    tail (the layers after the last whole unit) are not checkpointed; in a
    unit, every layer but the last keeps its last product in the
    reference's recompute."""
    head = cfg.moe.first_k_dense if cfg.moe else 0
    unit = 1 if cfg.moe else len(cfg.block_pattern)
    end = head + (cfg.n_layers - head) // unit * unit
    diff = 0.0
    for i, (kind, moe) in enumerate(zip(layer_kinds(cfg), moe_layers(cfg))):
        if i < head or i >= end:
            diff -= recompute(cfg, kind, moe)
        elif (i - head) % unit != unit - 1:
            diff += last_product(cfg, kind, moe)
    return diff


def expert_flops(cfg, kind: str) -> int:
    """The port's FLOPs in the routed experts' three products over all
    ``m = tokens · top_k`` rows, ``2·m·d·f`` each: once in a forward;
    forward, recompute and a backward of two products each in training."""
    if cfg.moe is None:
        return 0
    tokens = B * (1 if kind == "decode" else S)
    per_product = 2 * tokens * cfg.moe.top_k * cfg.d_model * cfg.moe.d_expert
    layers = cfg.n_layers - cfg.moe.first_k_dense
    return layers * 3 * per_product * (4 if kind == "train" else 1)


def stated_reference(arch: str, kind: str, port_flops: float) -> float:
    """The reference's count predicted from the port's by the three stated
    differences."""
    cfg = get_smoke(arch)
    want = port_flops
    if cfg.moe is not None:
        want += (cfg.moe.n_experts - 1) * expert_flops(cfg, kind)
    if kind == "train":
        want += remat_difference(cfg)
        dr = cfg.resolved_d_rnn
        want += layer_kinds(cfg).count("slstm") * 2 * B * dr * 4 * dr
    return want


# the families with attention and an MLP only; the recurrent and MoE ones
# are in test_torch_dryrun_mixers.py, meta against the CPU and the
# microbatches in test_torch_dryrun_meta.py (each file within a minute)
DENSE = ("stablelm_3b", "command_r_plus_104b", "granite_20b", "qwen2_5_32b", "hubert_xlarge",
         "qwen2_vl_72b")


def check_against_reference(arch: str, kind: str) -> None:
    """The port's meta count of a SMOKE cell within 1% of the reference's,
    after the stated differences."""
    got, want = port_count(arch, kind), ref_count(arch, kind)
    assert want["unresolved_whiles"] == 0 and got["unresolved_whiles"] == 0
    if kind == "train":
        assert got["n_microbatches"] == 1
    predicted = stated_reference(arch, kind, got["flops"])
    assert abs(predicted - want["flops"]) <= 0.01 * want["flops"], (predicted, want["flops"])


def cases(archs):
    return [(a, k) for a in archs for k in KINDS if k != "decode" or get_smoke(a).causal]


@pytest.mark.parametrize("arch,kind", cases(DENSE))
def test_flops_match_the_reference(arch, kind):
    check_against_reference(arch, kind)


@pytest.mark.parametrize("arch,shape", all_cells())
def test_model_flops_is_the_references_formula(arch, shape):
    shp = SHAPES[shape]
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    factor = 6.0 if shp.kind == "train" else 2.0
    assert dryrun.model_flops(arch, shape) == factor * ref_get(arch).active_param_count() * tokens


def test_the_grid_is_the_references():
    assert sorted(all_cells()) == sorted(ref_all_cells())
    assert len(all_cells()) == 31


def test_the_cli_writes_a_record_per_cell(tmp_path, capsys):
    cells = "stablelm_3b:decode_32k,xlstm_1_3b:long_500k"
    assert dryrun.main(["--cells", cells, "--out", str(tmp_path)]) == 0
    for cell in cells.split(","):
        arch, shape = cell.split(":")
        rec = json.loads((tmp_path / "card" / f"{arch}__{shape}.json").read_text())
        assert rec["ok"], rec.get("error")
        assert rec["mesh"] == "card" and rec["n_devices"] == 1 and rec["not_applied"] == []
        assert rec["model_flops"] == dryrun.model_flops(arch, shape)
        assert rec["cost_analysis"]["flops"] == rec["hlo_cost"]["flops"] > 0
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 2 * ref_get(arch).param_count()  # bf16 and the cache
        assert rec["fits_one_card"] == (mem["argument_size_in_bytes"]
                                        + mem["temp_size_in_bytes"] <= dryrun.CARD_BYTES)
    assert dryrun.main(["--cells", cells, "--out", str(tmp_path), "--skip-existing"]) == 0
    assert capsys.readouterr().out.count("cached OK") == 2


def test_the_cli_refuses_a_mesh_and_lists_what_a_plan_cannot_apply(tmp_path):
    with pytest.raises(SystemExit, match="Queue 1 item 6.4"):
        dryrun.main(["--mesh", "single", "--cells", "stablelm_3b:decode_32k"])
    assert dryrun.main(["--plan", "optimized", "--cells", "qwen2_5_32b:decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "card" / "qwen2_5_32b__decode_32k.json").read_text())
    assert rec["ok"] and rec["not_applied"] == ["rules", "seq_parallel"]
