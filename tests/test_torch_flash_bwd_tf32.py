"""The tensor-core arithmetic of ``csrc/flash_attention_bwd.cu`` on the
CPU: its five products in 3xTF32 (each fp32 operand split into a TF32
high part and the TF32 rounding of the rest, the low-low product dropped),
emulated by ``flash_attention_bwd_ref(..., split_tf32=True)``, held to the
tolerance ``chip_smoke.py`` holds the kernel to (2e-5 abs/rel elementwise,
or 1e-5 of the tensor's largest element) against the fp32 plain version
and against ``jax.vjp`` of the JAX package's oracle, at CPU-sized shapes
of every kind in ``chip_smoke.py``'s ``FLASH_BWD_CASES``: causal,
windowed, non-causal, a non-causal window, MQA and GQA, hd 80, 128 and
256, one position, and lengths past one key tile. Also the host-side plan
of the backward: keys a block owns, the tiles whose partial dQ the
scratch holds, and the blocks that share a kv group's query heads."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_train_ref,
    split_einsum,
    tf32,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def held(got, want) -> bool:
    """chip_smoke.py's held_fp32: 2e-5 abs/rel elementwise, or 1e-5 of the
    tensor's largest element."""
    err = (got - want).abs()
    return bool(torch.all(err <= 2e-5 + 2e-5 * want.abs())) or \
        err.max().item() <= 1e-5 * want.abs().max().item()


def test_tf32_rounds_to_ten_mantissa_bits_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + 3 * ulp / 2,
                      3.0, 1 + ulp / 2 - 2.0 ** -20, 0.0])
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 1.0, 0.0])
    assert torch.equal(tf32(x), want)
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 1e3
    hi = tf32(r)
    bits = hi.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)  # 13 low mantissa bits clear
    assert torch.all((r - hi).abs() <= hi.abs() * 2.0 ** -11)
    lo = tf32(r - hi)
    assert torch.all((r - hi - lo).abs() <= (r - hi).abs() * 2.0 ** -11)


def test_split_einsum_is_near_fp32():
    """hi·hi′ + hi·lo′ + lo·hi′ misses the fp32 product by about 2^-21 of
    the terms' magnitudes; plain TF32 (hi·hi′ alone) by about 2^-11."""
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, 80, generator=g), torch.randn(80, 48, generator=g)
    exact = (a.double() @ b.double())
    size = (a.abs().double() @ b.abs().double())
    split_err = ((split_einsum("ik,kj->ij", a, b).double() - exact).abs() / size).max().item()
    tf32_err = ((tf32(a).double() @ tf32(b).double() - exact).abs() / size).max().item()
    assert split_err < 2e-6 < 1e-4 < tf32_err * 10


# (b, s, nq, nkv, hd, causal, window): the kinds of FLASH_BWD_CASES at CPU
# sizes; 65 keys pass hd 80's and hd 128's 64-key tile, 40 hd 256's 32
CASES = [
    (2, 64, 4, 4, 80, True, 0),  # StableLM-3B's heads, one key tile
    (2, 40, 16, 1, 256, True, 20),  # RecurrentGemma-9B's MQA, windowed, two tiles
    (1, 64, 4, 4, 128, True, 0),  # DeepSeek-MoE-16B's heads
    (1, 1, 4, 4, 80, True, 0),  # one position
    (1, 65, 4, 4, 80, True, 0),  # past one tile
    (2, 64, 8, 2, 80, True, 17),  # GQA, windowed
    (1, 70, 2, 2, 256, False, 0),  # non-causal, three tiles
    (2, 65, 4, 1, 256, False, 9),  # a non-causal window, MQA
    (1, 130, 2, 1, 80, True, 50),  # a window past one tile
]


def draw(case, seed):
    b, s, nq, nkv, hd = case[:5]
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return rnd(b, s, nq, hd), rnd(b, s, nkv, hd), rnd(b, s, nkv, hd), rnd(b, s, nq, hd)


def jax_grads(q, k, v, dout, causal, window):
    nq, nkv = q.shape[2], k.shape[2]

    def pack(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(-1, x.shape[1], x.shape[3])

    def unpack(x, like):
        b, s, h, d = like.shape
        return torch.from_numpy(np.asarray(jnp.moveaxis(x.reshape(b, h, s, d), 1, 2)))

    def f(qp, kp, vp):
        return jax_flash_ref(qp, kp, vp, n_q_heads=nq, n_kv_heads=nkv, causal=causal,
                             window=window)

    _, vjp = jax.vjp(f, pack(q), pack(k), pack(v))
    return [unpack(g, t) for g, t in zip(vjp(pack(dout)), (q, k, v))]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_products_meet_the_kernels_tolerance(case):
    causal, window = case[5:]
    arrays = draw(case, seed=sum(case[:5]))
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    out, lse = flash_attention_train_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    split = flash_attention_bwd_ref(q, k, v, out, lse, dout, split_tf32=True, **kw)
    oracle = jax_grads(*arrays, causal, window)
    for name, s, p, j in zip("qkv", split, plain, oracle):
        assert held(s, p), f"d{name}: split vs fp32 plain {(s - p).abs().max().item():.3e}"
        assert held(s, j), f"d{name}: split vs jax.vjp {(s - j).abs().max().item():.3e}"
        assert not torch.equal(s, p)  # the emulation changes the arithmetic


@pytest.mark.parametrize("hd,tile", [(1, 64), (80, 64), (128, 64), (129, 32), (256, 32)])
def test_key_tile_follows_the_head_width(hd, tile):
    assert ops.bwd_key_tile(hd) == tile


@pytest.mark.parametrize("b,s,nq,hd,want", [
    (8, 64, 32, 80, 0),  # StableLM-3B's step: one tile, dQ in the block
    (2, 64, 16, 256, 2),  # two 32-key tiles, one round
    (1, 300, 2, 256, 10),  # ten tiles, one round
    (1, 65, 4, 80, 2),
    (1, 1, 4, 80, 0),
])
def test_part_tiles_hold_a_round(b, s, nq, hd, want):
    assert ops.bwd_part_tiles(b, s, s, nq, hd) == want


def test_part_tiles_split_a_long_sequence_into_rounds():
    """Past the scratch budget the tiles go in rounds: at least one tile a
    round, the scratch within ``BWD_PART_BYTES`` when one tile fits it."""
    b, s, nq, hd = 2, 4096, 8, 128
    tiles = math.ceil(s / ops.bwd_key_tile(hd))
    slots = ops.bwd_part_tiles(b, s, s, nq, hd)
    assert 1 <= slots < tiles
    assert slots * 4 * b * s * nq * hd <= ops.BWD_PART_BYTES
    assert (slots + 1) * 4 * b * s * nq * hd > ops.BWD_PART_BYTES
    assert ops.bwd_part_tiles(8, 4096, 4096, 32, 128) == 1  # one tile's dQ past the budget


@pytest.mark.parametrize("b,s,nq,nkv,hd,want", [
    (8, 64, 32, 32, 80, 1),  # StableLM-3B's training step: group 1
    (2, 64, 16, 1, 256, 16),  # RecurrentGemma-9B's checked step: 4 blocks unsplit
    (2, 2048, 16, 1, 256, 16),  # 4 tiles a round, 8 blocks unsplit
    (8, 64, 8, 2, 80, 4),  # 16 blocks: split until the group runs out
    (32, 64, 32, 8, 128, 2),  # 256 blocks, just short of 264
    (40, 64, 32, 8, 128, 1),  # 320 blocks: enough
    (8, 4096, 16, 1, 256, 4),  # 8 blocks, but 8 splits' dK, dV pass 256 MiB
])
def test_head_split_fills_the_card_within_the_scratch(b, s, nq, nkv, hd, want):
    assert ops.bwd_head_split(b, s, s, nq, nkv, hd) == want


def test_head_split_divides_the_group_and_is_the_least_that_fills():
    for b in (1, 2, 3, 8, 33):
        for s in (1, 64, 65, 300, 2048):
            for nq, nkv in ((16, 1), (32, 8), (12, 3), (8, 8), (48, 4)):
                for hd in (80, 256):
                    split = ops.bwd_head_split(b, s, s, nq, nkv, hd)
                    group = nq // nkv
                    assert group % split == 0
                    kv_bytes = 4 * b * s * nkv * hd
                    assert split == 1 or 2 * split * kv_bytes <= ops.BWD_PART_BYTES
                    blocks = b * nkv * (ops.bwd_part_tiles(b, s, s, nq, hd) or 1)
                    smaller = [d for d in range(1, split) if group % d == 0]
                    assert all(blocks * d < ops.BWD_BLOCKS for d in smaller)
