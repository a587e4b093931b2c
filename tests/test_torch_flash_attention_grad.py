"""The gradient of the port's flash attention (``FlashAttentionFunction``:
the training forward ``flash_attention_train_ref`` and the backward
``flash_attention_bwd_ref``, the plain versions of the training entry of
``csrc/flash_attention.cu`` and of ``csrc/flash_attention_bwd.cu``)
against ``jax.vjp`` of the JAX package's oracle
(``repro/kernels/flash_attention/ref.py:12 flash_attention_ref``), on
inputs made with numpy from a seed: causal, a window shorter than the
sequence, grouped and multi-query heads, non-causal, lengths that are not
a multiple of any tile, and a key sequence longer than the query one.

Tolerances: fp32 at rtol = atol = 2e-5 against JAX (the same algebra with
sums in another order; the reference's kernel tests use 2e-5); the
explicit backward against torch autograd through the training forward at
1e-5, and lse against ``torch.logsumexp`` of the scaled, masked scores at
1e-6.
"""

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
    flash_attention_ref,
    flash_attention_train_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (b, sq, skv, nq, nkv, hd, causal, window)
CASES = [
    (2, 16, 16, 4, 4, 16, True, 0),  # causal, one kv head a query head
    (2, 33, 33, 4, 4, 16, True, 8),  # a window shorter than the sequence, ragged
    (1, 40, 40, 8, 2, 32, True, 0),  # GQA
    (2, 24, 24, 16, 1, 32, True, 5),  # MQA (RecurrentGemma-9B's 16 over 1) + window
    (1, 65, 65, 2, 1, 80, True, 0),  # StableLM-3B's head width, past a 64-key tile
    (1, 20, 20, 4, 2, 8, False, 0),  # non-causal
    (2, 17, 17, 4, 2, 8, False, 6),  # non-causal window
    (1, 1, 1, 2, 2, 16, True, 0),  # one position
    (1, 12, 30, 4, 4, 16, False, 0),  # more keys than queries
]


def draw(case, seed):
    b, sq, skv, nq, nkv, hd = case[:6]
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return rnd(b, sq, nq, hd), rnd(b, skv, nkv, hd), rnd(b, skv, nkv, hd), rnd(b, sq, nq, hd)


def jax_vjp(q, k, v, dout, causal, window):
    """Output and (dq, dk, dv) of the JAX oracle in the model layout."""
    nq, nkv = q.shape[2], k.shape[2]

    def pack(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(-1, x.shape[1], x.shape[3])

    def unpack(x, like):
        b, s, h, d = like.shape
        return np.asarray(jnp.moveaxis(x.reshape(b, h, s, d), 1, 2))

    def f(qp, kp, vp):
        return jax_flash_ref(qp, kp, vp, n_q_heads=nq, n_kv_heads=nkv, causal=causal,
                             window=window)

    out, vjp = jax.vjp(f, pack(q), pack(k), pack(v))
    grads = vjp(pack(dout))
    return unpack(out, q), [unpack(g, t) for g, t in zip(grads, (q, k, v))]


def leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_function_matches_jax_vjp(case):
    causal, window = case[6:]
    q, k, v, dout = draw(case, seed=sum(case[:6]))
    tq, tk, tv = leaves(q, k, v)
    out = ops.flash_attention_op(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(dout))
    want_out, want = jax_vjp(q, k, v, dout, causal, window)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_bwd_ref_is_autograd_of_the_train_ref(case):
    causal, window = case[6:]
    q, k, v, dout = draw(case, seed=7 + sum(case[:6]))
    tq, tk, tv = leaves(q, k, v)
    out, lse = flash_attention_train_ref(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(dout))
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                  lse.detach(), torch.from_numpy(dout), causal=causal,
                                  window=window)
    for name, g, t in zip("qkv", got, (tq, tk, tv)):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-5, msg=f"d{name}")
    # the forward is the serving plain version, and lse the rows' log-sum-exp
    plain = flash_attention_ref(tq.detach(), tk.detach(), tv.detach(), causal=causal,
                                window=window)
    torch.testing.assert_close(out.detach(), plain, rtol=1e-6, atol=1e-6)
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    s = torch.einsum("bshd,bthd->bhst", torch.from_numpy(q),
                     torch.from_numpy(k).repeat_interleave(nq // nkv, dim=2)) / math.sqrt(hd)
    qp, kp = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    want = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    assert lse.shape == (b, nq, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse.detach(), want, rtol=1e-6, atol=1e-6)


def test_only_the_inputs_that_require_grad_get_one():
    q, k, v, dout = draw(CASES[2], seed=3)
    tq = torch.from_numpy(q)
    tk, tv = leaves(k, v)
    ops.flash_attention_op(tq, tk, tv).backward(torch.from_numpy(dout))
    _, want = jax_vjp(q, k, v, dout, True, 0)
    assert tq.grad is None
    np.testing.assert_allclose(tk.grad.numpy(), want[1], **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), want[2], **TOL)


def test_no_grad_and_serving_calls_stay_the_serving_path():
    q, k, v, _ = draw(CASES[1], seed=4)
    tq, tk, tv = leaves(q, k, v)
    with torch.no_grad():
        out = ops.flash_attention_op(tq, tk, tv, window=8)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_attention_ref(tq, tk, tv, window=8), rtol=0, atol=0)
    plain = ops.flash_attention_op(*(torch.from_numpy(a) for a in (q, k, v)), window=8)
    assert plain.grad_fn is None


def test_bf16_and_cached_calls_under_grad_raise():
    q, k, v, _ = draw(CASES[0], seed=5)
    tq, tk, tv = leaves(q, k, v)
    with pytest.raises(TypeError, match="fp32 or bf16"):  # bf16 trains since its kernels
        ops.flash_attention_op(*(t.detach().half().requires_grad_(True) for t in (tq, tk, tv)))
    with pytest.raises(ValueError, match="takes no gradient"):
        ops.flash_attention_op(tq[:, :1], tk, tv, q_offset=3, kv_len=4)
    with pytest.raises(ValueError, match="takes no gradient"):
        ops.flash_attention_op(tq, tk, tv, kv_len=16)


def test_the_cpu_counts_no_launch():
    before = dict(ops.LAUNCHES)
    q, k, v, dout = draw(CASES[0], seed=6)
    tq, tk, tv = leaves(q, k, v)
    ops.flash_attention_op(tq, tk, tv).backward(torch.from_numpy(dout))
    assert ops.LAUNCHES == before and set(before) == {"flash_attention", "flash_attention_bwd"}


def test_bwd_wrapper_checks_its_arguments():
    q, k, v, dout = (torch.from_numpy(a) for a in draw(CASES[0], seed=8))
    out, lse = ops.flash_attention_train(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, out, lse[:, :, :-1], dout)
    with pytest.raises(ValueError, match="dout"):
        ops.flash_attention_bwd(q, k, v, out, lse, dout.double())
