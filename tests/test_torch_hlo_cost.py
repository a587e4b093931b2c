"""The port's cost counter (``repro_torch.launch.hlo_cost``) against the
reference's HLO cost model (``repro.launch.hlo_cost``), the counterparts of
``tests/test_hlo_cost.py``: a product's FLOPs and bytes equal the
reference's count of the same ``jnp.dot`` compiled in JAX on the CPU; a
7-trip loop counts 7 bodies; each byte rule; a kernel wrapper's inner
operators are not counted (its recorded cost stands for them); an
all-reduce and an all-gather in a one-process gloo group count by the
reference's collective rule; the memory peak follows storages' lifetimes.
"""

import socket
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_cost import analyze as ref_analyze
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch.hlo_cost import CostCounter, analyze


def test_one_product_counts_as_the_reference_counts_its_dot():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((128, 64), np.float32), rng.standard_normal((64, 32), np.float32)
    hlo = jax.jit(jnp.dot).lower(a, b).compile().as_text()
    want = ref_analyze(hlo)
    got = analyze(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 128 * 32 * 64
    assert got["bytes"] == want["bytes"] == 4 * (128 * 32 + 128 * 64 + 64 * 32)
    assert got["unresolved_whiles"] == want["unresolved_whiles"] == 0


def test_a_loop_counts_every_trip():
    x = torch.randn(16, 16)

    def body(x):
        return x @ x

    def loop(x):
        for _ in range(7):
            x = body(x)
        return x

    one, seven = analyze(body, x), analyze(loop, x)
    assert seven["flops"] == 7 * one["flops"] == 7 * 2 * 16**3
    assert seven["bytes"] == 7 * one["bytes"]
    assert seven["unresolved_whiles"] == 0


def byte_count(fn, *args) -> float:
    return analyze(fn, *args)["bytes"]


def test_byte_rules():
    x = torch.randn(8, 32)  # 1 KiB
    idx = torch.tensor([0, 3, 5])
    n = x.element_size()
    # a view moves nothing; a copying slice or gather 2 x its result
    assert byte_count(lambda x: x[:, 4:12], x) == 0
    assert byte_count(lambda x: x.t(), x) == 0
    assert byte_count(lambda x: x[idx], x) == 2 * 3 * 32 * n
    assert byte_count(lambda x: torch.index_select(x, 0, idx), x) == 2 * 3 * 32 * n
    # an update into a region: 2 x the update
    upd = torch.randn(3, 32)
    assert byte_count(lambda x, u: x.index_put_((idx,), u), x.clone(), upd) == 2 * upd.numel() * n
    assert byte_count(lambda x, u: x[:3].copy_(u), x.clone(), upd) == 2 * upd.numel() * n
    # fills and arange: the result; an allocation alone: nothing
    assert byte_count(lambda: torch.zeros(10, 10)) == 400
    assert byte_count(lambda: torch.arange(100)) == 800
    assert byte_count(lambda: torch.empty(10, 10)) == 0
    # a copy between devices is not a device's memory traffic
    assert byte_count(lambda x: x.to("meta"), x) == 0
    # every other operator: operands plus result
    assert byte_count(torch.add, x, x) == 3 * x.numel() * n
    assert byte_count(lambda x: x.float().sum(0), x) == (x.numel() + 32) * n


def test_a_kernel_wrappers_inner_operators_are_not_counted():
    """On the CPU the wrapper runs the plain version, which does products
    of its own; the count is the kernel's recorded cost, once."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k, v = torch.randn(2, 16, 2, 8, generator=g), torch.randn(2, 16, 2, 8, generator=g)
    plain = analyze(lambda q, k, v: flash_attention_ref(q, k, v, causal=True), q, k, v)
    assert plain["flops"] > 0 and plain["n_ops"] > 5
    got = analyze(lambda q, k, v: flash_ops.flash_attention_op(q, k, v, causal=True), q, k, v)
    flops = 4 * 2 * 4 * 16 * 16 * 8
    assert got["flops"] == flops == flash_ops.attention_flops(q, k)
    assert got["bytes"] == cost.nbytes(q, k, v, q)
    assert got["n_ops"] == 0
    assert got["kernels"] == {"flash_attention": {"calls": 1, "flops": flops,
                                                  "bytes": cost.nbytes(q, k, v, q)}}
    # nested counters both see the call; no counter listens afterwards
    with CostCounter() as outer, CostCounter() as inner:
        flash_ops.flash_attention_op(q, k, v, causal=True)
    assert outer.flops == inner.flops == flops and not cost.COUNTERS


def test_record_adds_outside_a_kernel_only():
    with CostCounter() as c:
        cost.record(flops=10, moved=20)
        with cost.kernel("k", 1, 2):
            cost.record(flops=100, moved=200)
    assert (c.flops, c.bytes) == (11, 22)


COLLECTIVE = textwrap.dedent("""
    HloModule coll

    ENTRY %main.3 (p: f32[1024,512]) -> f32[1024,512] {
      %p = f32[1024,512]{1,0} parameter(0)
      %ar = f32[1024,512]{1,0} all-reduce(%p), replica_groups={}, to_apply=%add.1
      ROOT %ag = f32[1024,512]{1,0} all-gather(%ar), dimensions={0}
    }

    %add.1 (a: f32[], b: f32[]) -> f32[] {
      %a = f32[] parameter(0)
      %b = f32[] parameter(1)
      ROOT %s = f32[] add(%a, %b)
    }
""")


@pytest.fixture
def one_process_group():
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD.group_name
    finally:
        dist.destroy_process_group()


def test_collectives_count_by_the_references_rule(one_process_group):
    name = one_process_group
    functional = torch.ops._c10d_functional

    def fn(x):
        y = functional.wait_tensor(functional.all_reduce(x, "sum", name))
        return functional.wait_tensor(functional.all_gather_into_tensor(y, 1, name))

    x = torch.ones(1024, 512)
    got = analyze(fn, x)
    want = ref_analyze(COLLECTIVE)
    n = x.numel() * 4
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["collective_bytes"]["all-reduce"] == 2 * n  # ring wire: twice
    assert got["collective_bytes"]["all-gather"] == n
    assert got["collective_counts"]["all-reduce"] == got["collective_counts"]["all-gather"] == 1
    assert got["collective_total"] == want["collective_total"] == 3 * n
    assert got["bytes"] == 2 * n  # each collective's result, once, as the reference adds it


def test_memory_follows_storage_lifetimes():
    x = torch.empty(256, device="meta")  # 1 KiB argument

    def fn(x):
        a = x * 2  # 1 KiB
        b = torch.empty(1024, device="meta")  # 4 KiB
        del b
        c = torch.cat([a, a])  # 2 KiB, a still alive: 3 KiB
        return c

    got = analyze(fn, x)
    assert got["memory"] == {"argument": 1024, "output": 2048, "temp": 5 * 1024}
    # an operator in place and a view make no storage
    assert analyze(lambda x: x.add_(1).view(16, 16), x.clone())["memory"]["temp"] == 0
