"""The tensor-core arithmetic of ``csrc/flash_attention_train.cu`` on the
CPU: its two products, S = Q Kᵀ and P V, in 3xTF32 (``kernels/tf32.py``),
emulated by ``flash_attention_train_ref(..., split_tf32=True)``, held to
the tolerance ``chip_smoke.py`` holds the kernel to (out and lse 2e-5
abs/rel elementwise, or 1e-5 of the tensor's largest element) against the
fp32 plain version and against the JAX package's oracle
(``repro.kernels.flash_attention.ref.flash_attention_ref`` for out; for
lse, the log-sum-exp of the same masked scores in jnp), at CPU-sized
shapes of every kind in ``chip_smoke.py``'s ``FLASH_BWD_CASES``: causal,
windowed, non-causal, a non-causal window, MQA and GQA, hd 80, 128 and
256, one position, and lengths past the kernel's key tile (64 keys up to
hd 128, 32 at hd 256)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import NEG_INF
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_train_ref


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


# (b, s, nq, nkv, hd, causal, window): the kinds of FLASH_BWD_CASES at CPU
# sizes; 65 and 130 keys pass hd 80's and hd 128's 64-key tile, 40 and 70
# hd 256's 32
CASES = [
    (2, 64, 4, 4, 80, True, 0),  # StableLM-3B's heads, one key tile
    (2, 40, 16, 1, 256, True, 20),  # RecurrentGemma-9B's MQA, windowed, two tiles
    (1, 64, 4, 4, 128, True, 0),  # DeepSeek-MoE-16B's heads
    (1, 1, 4, 4, 80, True, 0),  # one position
    (1, 1, 16, 1, 256, True, 2048),  # one position, MQA
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

    return rnd(b, s, nq, hd), rnd(b, s, nkv, hd), rnd(b, s, nkv, hd)


def jax_forward(q, k, v, causal, window):
    """(out (b, s, nq, hd), lse (b, nq, s)) by the JAX package's oracle and
    the log-sum-exp of its scores."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]

    def pack(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(-1, x.shape[1], x.shape[3])

    out = jax_flash_ref(pack(q), pack(k), pack(v), n_q_heads=nq, n_kv_heads=nkv, causal=causal,
                        window=window)
    out = jnp.moveaxis(out.reshape(b, nq, s, hd), 1, 2)
    qg = jnp.asarray(q).reshape(b, s, nkv, nq // nkv, hd)
    scores = jnp.einsum("bsngk,btnk->bngst", qg, jnp.asarray(k)) / np.sqrt(hd)
    pos = jnp.arange(s)
    mask = jnp.ones((s, s), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    lse = jax.nn.logsumexp(jnp.where(mask, scores, NEG_INF), axis=-1).reshape(b, nq, s)
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse))


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_forward_meets_the_kernels_tolerance(case):
    causal, window = case[5:]
    arrays = draw(case, seed=sum(case[:5]) + 7)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=causal, window=window)
    split = flash_attention_train_ref(q, k, v, split_tf32=True, **kw)
    plain = flash_attention_train_ref(q, k, v, **kw)
    oracle = jax_forward(*arrays, causal, window)
    for name, s, p, j in zip(("out", "lse"), split, plain, oracle):
        assert held(s, p), f"{name}: split vs fp32 plain {(s - p).abs().max().item():.3e}"
        assert held(s, j), f"{name}: split vs the JAX package {(s - j).abs().max().item():.3e}"
    assert not torch.equal(split[0], plain[0])  # the emulation changes the arithmetic


def test_split_forward_of_one_key_is_the_value():
    """A row that sees one key (causal, position 0) gets that key's value
    exactly in fp32, and its lse is its one scaled score: P is exactly 1,
    and 1's TF32 split is (1, 0)."""
    q, k, v = (torch.from_numpy(a) for a in draw((1, 3, 2, 2, 16), seed=3))
    out, lse = flash_attention_train_ref(q, k, v, split_tf32=True)
    exact, _ = flash_attention_train_ref(q.double(), k.double(), v.double())
    assert torch.allclose(out[:, 0].double(), v[:, 0].double(), rtol=0, atol=2e-7)
    assert torch.allclose(out[:, 0].double(), exact[:, 0], rtol=0, atol=2e-7)
    want = (q[:, 0].double() * k[:, 0].double()).sum(-1) / 4.0
    assert torch.allclose(lse[:, :, 0].double(), want, rtol=1e-6, atol=1e-6)
