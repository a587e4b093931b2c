"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's: the Pallas kernel in interpret mode over the
JAX suite's cases, and the model's ``sdpa`` with a query offset and a KV
length, on the same seeded numpy inputs.

fp32 at rtol=atol=2e-5 (the JAX suite's own tolerance: the same products
summed in another order); bf16 at 2e-2 (the port's plain version scores in
fp32, the JAX code rounds the products to bf16). On the CPU the wrapper
takes the plain version and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op as jax_flash_attention_op
from repro.models.attention import sdpa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# (b, sq, skv, nq, nkv, hd, causal, window, blk): FLASH_CASES of
# tests/test_kernels.py, then a narrow window whose early 64-key tiles are
# fully masked for the late rows of a 64-row Pallas block.
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, 64),
    (1, 256, 256, 8, 2, 32, True, 0, 128),
    (2, 128, 128, 4, 1, 64, True, 64, 64),  # MQA + sliding window
    (1, 96, 96, 4, 4, 64, False, 0, 64),  # encoder (non-divisible seq)
    (1, 200, 200, 2, 2, 128, True, 0, 128),  # padded seq
    (1, 256, 256, 2, 1, 32, True, 16, 64),  # fully masked early tiles
    (1, 64, 64, 16, 1, 256, True, 16, 32),  # RecurrentGemma's heads: MQA at hd 256
]
jax_sdpa = jax.jit(sdpa, static_argnames=("causal", "window"))
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def qkv(b, sq, skv, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nq, hd), dtype=np.float32),
            rng.standard_normal((b, skv, nkv, hd), dtype=np.float32),
            rng.standard_normal((b, skv, nkv, hd), dtype=np.float32))


def as_f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_matches_pallas_kernel(case, dtype):
    b, sq, skv, nq, nkv, hd, causal, window, blk = case
    jdt, tdt, tol = DTYPES[dtype]
    arrays = qkv(b, sq, skv, nq, nkv, hd)
    want = jax_flash_attention_op(*(jnp.asarray(a, jdt) for a in arrays), causal=causal,
                                  window=window, blk_q=blk, blk_k=blk, interpret=True)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(*(torch.from_numpy(a).to(tdt) for a in arrays),
                                 causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before, "a CPU tensor launched the kernel"
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, nq, hd)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


# (sq, skv, nq, nkv, q_offset, kv_len, window) at the served head_dim, 80:
# block prefill into a longer cache, then decode steps over a partly
# filled one.
SDPA_CASES = [
    (10, 32, 4, 4, 0, 10, 0),
    (1, 32, 4, 4, 0, 1, 0),
    (1, 32, 4, 4, 17, 18, 0),
    (1, 32, 8, 2, 30, 31, 0),
    (6, 40, 8, 2, 12, 18, 0),  # a block written past earlier tokens
    (3, 64, 8, 2, 40, 43, 8),  # a windowed block deep in the cache
]


@pytest.mark.parametrize("case", SDPA_CASES, ids=[str(c) for c in SDPA_CASES])
def test_port_matches_model_sdpa_with_offset_and_kv_len(case):
    sq, skv, nq, nkv, q_offset, kv_len, window = case
    q, k, v = qkv(1, sq, skv, nq, nkv, 80, seed=sq + skv)
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    window=window, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention_op(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# (sq, skv, causal, window, q_offset, kv_len) at RecurrentGemma's heads (16
# query heads of 256 over one kv head): block prefill and decode into a
# 128-long cache with the 2048 window, and a decode step over a wrapped ring
# of 16 slots, which attends to every slot without a mask.
RING_CASES = [
    (13, 128, True, 2048, 0, 13),
    (1, 128, True, 2048, 20, 21),
    (1, 16, True, 16, 9, 10),
    (1, 16, False, 0, 0, 16),
]


@pytest.mark.parametrize("case", RING_CASES, ids=[str(c) for c in RING_CASES])
def test_port_matches_model_sdpa_at_head_dim_256(case):
    sq, skv, causal, window, q_offset, kv_len = case
    q, k, v = qkv(1, sq, skv, 16, 1, 256, seed=sq + skv)
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    window=window, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention_op(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_keys_past_kv_len_change_nothing():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 1, 32, 4, 4, 80))
    got = ops.flash_attention_op(q, k, v, q_offset=9, kv_len=10)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:], v2[:, 10:] = 1e4, -1e4
    assert torch.equal(ops.flash_attention_op(q, k2, v2, q_offset=9, kv_len=10), got)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 4, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="v has shape"):
        ops.flash_attention_op(q, k, v[:, :-1])
    with pytest.raises(ValueError, match="k has shape"):
        ops.flash_attention_op(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="must be 4-D"):
        ops.flash_attention_op(q[0], k, v)
    with pytest.raises(ValueError, match="do not split"):
        ops.flash_attention_op(torch.zeros(1, 4, 3, 16), k, v)
    with pytest.raises(TypeError, match="expected torch.float32"):
        ops.flash_attention_op(q, k.double(), v)
    with pytest.raises(ValueError, match="head_dim 320 exceeds 256"):
        ops.flash_attention_op(*(torch.zeros(1, 2, 2, 320) for _ in range(3)))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention_op(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention_op(q, k, v, kv_len=-2)
    with pytest.raises(ValueError, match="k is on meta"):
        ops.flash_attention_op(q, k.to("meta"), v)
    # meta tensors (the dry run) get an empty output of the kernel's shape;
    # the checks still hold there
    out = ops.flash_attention_op(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape and out.is_contiguous()
    with pytest.raises(ValueError, match="v has shape"):
        ops.flash_attention_op(q.to("meta"), k.to("meta"), v[:, :-1].to("meta"))


@pytest.mark.parametrize("case", [
    dict(sq=2, kv_len=0),  # no key at all
    dict(sq=2, q_offset=6, kv_len=4, window=2),  # the window starts past kv_len
    dict(sq=4, q_offset=1, kv_len=3, window=2),  # only the last row is blind
    dict(sq=2, q_offset=5, kv_len=3, window=2, causal=False),
], ids=str)
def test_wrapper_refuses_a_row_that_sees_no_key(case):
    sq = case.pop("sq")
    q, k, v = (torch.from_numpy(a) for a in qkv(1, sq, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="sees no key"):
        ops.flash_attention_op(q, k, v, **case)


@pytest.mark.parametrize("causal", [True, False])
def test_refusal_is_exactly_the_blind_rows(causal):
    """Over a grid of shapes, the wrapper refuses a call iff some row's mask
    (as the plain version builds it) is empty, and otherwise equals the
    plain version."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 5, 6, 2, 2, 8))
    taken = 0
    for sq in (1, 2, 5):
        for q_offset in range(0, 8):
            for kv_len in range(0, 7):
                for window in range(0, 5):
                    q_pos = torch.arange(sq)[:, None] + q_offset
                    k_pos = torch.arange(6)[None, :]
                    mask = k_pos < kv_len
                    if causal:
                        mask = mask & (k_pos <= q_pos)
                    if window > 0:
                        mask = mask & (k_pos > q_pos - window)
                    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
                    if not mask.any(1).all():
                        with pytest.raises(ValueError, match="sees no key"):
                            ops.flash_attention_op(q[:, :sq], k, v, **kw)
                    else:
                        got = ops.flash_attention_op(q[:, :sq], k, v, **kw)
                        assert torch.equal(got, flash_attention_ref(q[:, :sq], k, v, **kw))
                        taken += 1
    assert taken > 100


def test_plain_version_is_the_wrapper_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 5, 9, 4, 1, 8, seed=3))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=False, window=3, q_offset=4, kv_len=7)
    assert ops.LAUNCHES["flash_attention"] == before == 0
    want = flash_attention_ref(q, k, v, causal=False, window=3, q_offset=4, kv_len=7)
    assert torch.equal(got, want)
