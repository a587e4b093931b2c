"""The dry run's meta path against the CPU and against itself: a SMOKE
cell counted on meta tensors counts what the same cell run on the CPU
(with the kernels' plain versions) counts, FLOPs and bytes, for every
family and cell kind (MoE: equal FLOPs, and the CPU's bytes at most the
meta count, which takes the routing that hits the most experts); each
kernel wrapper's meta branch returns what its plain version returns,
shapes, dtypes and layout, and records the same cost; a train cell of 2
or 3 microbatches, one counted and the rest replayed, counts what the
whole step counts op by op."""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, ShapeConfig, get_smoke
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import analyze
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.train_loop import (TrainStepConfig, functional_loss, make_train_step,
                                            params_of)
from test_torch_dryrun import B, S, cases, one_torch_thread, port_count  # noqa: F401


@pytest.mark.parametrize("arch,kind", cases(ARCH_IDS))
def test_a_meta_cell_counts_what_the_cpu_runs(arch, kind):
    meta, cpu = port_count(arch, kind), port_count(arch, kind, device="cpu")
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["kernels"] == cpu["kernels"]
    if get_smoke(arch).moe is None:
        assert meta["bytes"] == cpu["bytes"]
    else:
        assert cpu["bytes"] <= meta["bytes"]
    assert meta["memory"]["argument"] == cpu["memory"]["argument"]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("arch", ["stablelm_3b", "deepseek_moe_16b"])
def test_microbatches_replay_the_first(arch, n):
    """A train cell of n microbatches (the first counted, the rest replayed)
    counts what the whole step counts op by op."""
    cfg = get_smoke(arch)
    shape = ShapeConfig("train", S, B * n, "train")
    got = dryrun.count_cell(arch, "train", cfg=cfg, shape=shape,
                            plan={**dryrun.BASELINE_PLAN, "micro_rows": B})
    assert got["n_microbatches"] == n and got["micro_rows"] == B
    model = LM(dryrun.plan_config(cfg, dryrun.BASELINE_PLAN), "meta", dtype=torch.bfloat16)
    params = params_of(model)
    opt = AdamW(learning_rate=1e-4)
    step = make_train_step(functional_loss(model), opt, TrainStepConfig(n), donate=True)
    whole = analyze(step, params, opt.init(params), dryrun.input_specs(cfg, shape))
    for key in ("flops", "bytes", "kernels", "collective_total"):
        assert got[key] == whole[key], key
    one = port_count(arch, "train")
    assert got["kernels"]["flash_attention"]["calls"] == \
        n * one["kernels"]["flash_attention"]["calls"]


def rand(*shape, dtype=torch.float32, g):
    return torch.randn(*shape, generator=g).to(dtype)


def flash_cases(g):
    q, k, v = rand(2, 5, 4, 8, g=g), rand(2, 12, 2, 8, g=g), rand(2, 12, 2, 8, g=g)
    yield "serve", flash_ops.flash_attention_op, (q, k, v), dict(q_offset=7, kv_len=12)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (rand(2, 16, n, 12, dtype=dtype, g=g) for n in (4, 2, 2, 4))
        out, lse = flash_ops.flash_attention_train(q, k, v, window=6)
        yield f"serve {dtype}", flash_ops.flash_attention_op, (q, k, v), {}
        yield f"train {dtype}", flash_ops.flash_attention_train, (q, k, v), dict(window=6)
        yield f"bwd {dtype}", flash_ops.flash_attention_bwd, (q, k, v, out, lse, dout), \
            dict(window=6)


def rg_cases(g):
    a, b, h0 = torch.rand(2, 9, 16, generator=g), rand(2, 9, 16, g=g), rand(2, 16, g=g)
    yield "serve", rg_ops.rg_lru_op, (a, b, h0), {}
    yield "serve bf16", rg_ops.rg_lru_op, (a.bfloat16(), b.bfloat16(), None), {}
    h, _ = rg_ops.rg_lru_op(a, b, h0)
    yield "bwd", rg_ops.rg_lru_bwd, (a, h, h0, rand(2, 9, 16, g=g), rand(2, 16, g=g)), {}
    yield "bwd no h0", rg_ops.rg_lru_bwd, (a, h, None, None, rand(2, 16, g=g)), {}


def mlstm_cases(g):
    for s in (1, 130):
        q, k, v = (rand(2, s, 3, 8, g=g) for _ in range(3))
        i, f = rand(2, s, 3, g=g), rand(2, s, 3, g=g) + 3
        c, n, m = rand(2, 3, 8, 8, g=g), rand(2, 3, 8, g=g), torch.zeros(2, 3)
        yield f"serve {s}", mlstm_ops.mlstm_chunk_op, (q, k, v, i, f, c, n, m), {}
        yield f"train {s}", mlstm_ops.mlstm_chunk_train, (q, k, v, i, f, c, n, m), {}
        h, _, _, _, cs, ns, ms = mlstm_ops.mlstm_chunk_train(q, k, v, i, f, c, n, m)
        yield f"bwd {s}", mlstm_ops.mlstm_chunk_bwd, \
            (q, k, v, i, f, cs, ns, ms, h, torch.ones_like(h), None, rand(2, 3, 8, g=g), None), {}


def leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("family", [flash_cases, rg_cases, mlstm_cases],
                         ids=["flash_attention", "rg_lru", "mlstm_chunk"])
def test_a_kernels_meta_outputs_are_its_plain_versions(family):
    for label, fn, args, kw in family(torch.Generator().manual_seed(0)):
        meta_args = tuple(None if t is None else t.to("meta") for t in args)
        cpu = analyze(lambda *a: fn(*a, **kw), *args)
        meta = analyze(lambda *a: fn(*a, **kw), *meta_args)
        assert meta["kernels"] == cpu["kernels"] and meta["flops"] == cpu["flops"], label
        assert meta["bytes"] == cpu["bytes"] and len(meta["kernels"]) == 1, label
        got, want = leaves(fn(*meta_args, **kw)), leaves(fn(*args, **kw))
        assert len(got) == len(want), label
        for g, w in zip(got, want):
            assert (g is None) == (w is None), label
            if w is not None:
                assert (g.shape, g.dtype, g.is_contiguous()) == (w.shape, w.dtype, True), label
        if fn is mlstm_ops.mlstm_chunk_op:  # C is written in place and returned
            assert got[1] is meta_args[5]
