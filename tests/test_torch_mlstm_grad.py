"""The gradient of the port's chunkwise mLSTM (``repro_torch.kernels.
mlstm_chunk``) against the JAX package's recurrence, on seeded numpy
inputs: ``mlstm_chunk_bwd_ref`` (the plain version of
``csrc/mlstm_chunk_bwd.cu``) against ``torch.autograd`` of
``mlstm_chunk_ref`` and against ``jax.vjp`` of a ``lax.scan`` over
``repro.models.xlstm._mlstm_step`` (what XLA differentiates in the
reference below 128 tokens; the chunked form above computes the same
function), from a non-zero carried state, at lengths 1, 7, 64, 65 and 130
(a step, a prompt, one chunk, a chunk and a step, two chunks and a step)
and head widths 16 and 64; then ``MLSTMFunction``, the op under grad, on
the CPU: its gradients, that it leaves its input C untouched and launches
nothing, and that without grad C is still written in place.

Tolerances: each gradient tensor within 5e-5 of its own largest element
(``assert_grads_close`` of the LM tests; sums over a chunk in another
order than the per-step scan's); the plain backward against autograd of
the plain forward at 2e-5 of the largest element (the same algebra)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JXL
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_bwd_ref, mlstm_chunk_ref,
                                                 mlstm_chunk_train_ref)

NAMES = ("q", "k", "v", "i_gate", "f_gate", "C", "n", "m")
LENGTHS = (1, 7, 64, 65, 130)
WIDTHS = (16, 64)


def draw(b, s, H, dh, seed):
    """Inputs as the JAX suite draws them (0.5-scaled normals, forget gates
    shifted by 2), a carried state (C ~ N(0, 1), n, m of ±1) and
    cotangents of h and of the returned C, n and m."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * rng.standard_normal(shape) + shift).astype(np.float32)

    inputs = (rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5),
              rnd(b, s, H, dh, scale=0.5), rnd(b, s, H), rnd(b, s, H, shift=2.0))
    state = (rnd(b, H, dh, dh), rnd(b, H, dh), rnd(b, H))
    cts = (rnd(b, s, H, dh), rnd(b, H, dh, dh), rnd(b, H, dh), rnd(b, H))
    return inputs, state, cts


def close(got, want, limit, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got).max() > 0, f"{what} has no gradient"
    err = np.abs(got - want).max()
    assert err <= limit * scale, f"{what}: max|dg| {err:.3e} > {limit} x {scale:.3e}"


def jax_grads(inputs, state, cts):
    """``jax.vjp`` of the per-step scan over the whole sequence: the
    gradients of (q, k, v, i, f, C, n, m)."""
    def f(q, k, v, i, f_, c, n, m):
        xs = tuple(jnp.moveaxis(a, 1, 0) for a in (q, k, v, i, f_))
        final, hs = jax.lax.scan(JXL._mlstm_step, JXL.MLSTMState(c, n, m), xs)
        return jnp.moveaxis(hs, 0, 1), final.c, final.n, final.m

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (*inputs, *state)))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


def torch_args(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def plain_bwd(inputs, state, cts):
    args = torch_args(inputs) + torch_args(state)
    h, _, _, _, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    return mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, *torch_args(cts))


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("s", LENGTHS)
def test_bwd_ref_matches_jax_vjp_of_the_step_scan(s, dh):
    inputs, state, cts = draw(2, s, 2, dh, seed=s + dh)
    want = jax_grads(inputs, state, cts)
    for name, g, w in zip(NAMES, plain_bwd(inputs, state, cts), want):
        close(g.numpy(), w, 5e-5, f"d{name}")


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("s", LENGTHS)
def test_bwd_ref_is_autograd_of_the_chunk_ref(s, dh):
    inputs, state, cts = draw(1, s, 2, dh, seed=100 + s + dh)
    leaves = torch_args(inputs, True) + torch_args(state, True)
    out = mlstm_chunk_ref(*leaves)
    want = torch.autograd.grad(out, leaves, torch_args(cts))
    for name, g, w in zip(NAMES, plain_bwd(inputs, state, cts), want):
        close(g.numpy(), w.numpy(), 2e-5, f"d{name}")


def test_bwd_ref_treats_none_as_zero():
    inputs, state, cts = draw(1, 70, 2, 16, seed=5)
    zero = tuple(np.zeros_like(c) for c in cts[1:])
    args = torch_args(inputs) + torch_args(state)
    h, _, _, _, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    dh = torch.from_numpy(cts[0])
    with_none = mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, dh, None, None, None)
    with_zero = mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, dh,
                                    *(torch.from_numpy(z) for z in zero))
    for a, b in zip(with_none, with_zero):
        assert torch.equal(a, b)


def test_train_ref_returns_each_chunks_input_state():
    inputs, state, _ = draw(2, 130, 2, 16, seed=6)
    args = torch_args(inputs) + torch_args(state)
    h, c, n, m, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    assert c_st.shape == (3, 2, 2, 16, 16) and n_st.shape == (3, 2, 2, 16) and m_st.shape == (3, 2, 2)
    for t, st in zip(args[5:], (c_st, n_st, m_st)):
        assert torch.equal(st[0], t)
    for ci, c0 in enumerate((64, 128)):  # chunk ci + 1 starts from the state after c0 steps
        _, *after = mlstm_chunk_ref(*(a[:, :c0] for a in args[:5]), *args[5:])
        for got, want in zip((c_st, n_st, m_st), after):
            torch.testing.assert_close(got[ci + 1], want, rtol=1e-5, atol=1e-6)
    want = mlstm_chunk_ref(*args)
    for got, w in zip((h, c, n, m), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("s", (7, 65))
def test_function_on_the_cpu_matches_jax_and_writes_nothing(s):
    inputs, state, cts = draw(2, s, 2, 16, seed=200 + s)
    leaves = torch_args(inputs, True) + torch_args(state, True)
    c_before = leaves[5].detach().clone()
    before = dict(ops.LAUNCHES)
    out = ops.mlstm_chunk_op(*leaves)
    assert "MLSTMFunction" in type(out[0].grad_fn).__name__
    assert out[1] is not leaves[5] and torch.equal(leaves[5].detach(), c_before)
    torch.autograd.backward(out, torch_args(cts))
    assert ops.LAUNCHES == before, "a CPU tensor launched a kernel"
    assert torch.equal(leaves[5].detach(), c_before), "the op under grad wrote its input C"
    for name, leaf, w in zip(NAMES, leaves, jax_grads(inputs, state, cts)):
        close(leaf.grad.numpy(), w, 5e-5, f"d{name}")


def test_only_the_inputs_that_require_grad_get_one():
    inputs, state, cts = draw(1, 9, 2, 16, seed=8)
    args = torch_args(inputs) + torch_args(state)
    args[0].requires_grad_(True)
    h, c, n, m = ops.mlstm_chunk_op(*args)
    (dq,) = torch.autograd.grad(h, [args[0]], torch.from_numpy(cts[0]))
    want = plain_bwd(inputs, (state[0], state[1], state[2]), (cts[0], *(np.zeros_like(c_)
                                                                         for c_ in cts[1:])))[0]
    torch.testing.assert_close(dq, want, rtol=0, atol=0)


def test_without_grad_c_is_still_written_in_place():
    inputs, state, _ = draw(1, 9, 2, 16, seed=9)
    args = torch_args(inputs) + torch_args(state)
    want = mlstm_chunk_ref(*args)
    c = args[5]
    with torch.no_grad():
        args[0].requires_grad_(True)
        h, c_out, n, m = ops.mlstm_chunk_op(*args)
    assert c_out is c and h.grad_fn is None
    for got, w in zip((h, c, n, m), want):
        assert torch.equal(got, w)
    args[0].requires_grad_(False)
    c2 = torch.from_numpy(state[0].copy())
    _, c2_out, _, _ = ops.mlstm_chunk_op(*args[:5], c2, *args[6:])  # grad mode, nothing requires it
    assert c2_out is c2


def test_bf16_under_grad_raises_and_the_bwd_wrapper_checks_shapes():
    inputs, state, cts = draw(1, 4, 2, 16, seed=10)
    args = torch_args(inputs) + torch_args(state)
    q = args[0].bfloat16().requires_grad_(True)
    with pytest.raises(TypeError, match="fp32 only"):
        ops.mlstm_chunk_op(q, *(a.bfloat16() for a in args[1:3]), *args[3:])
    h, _, _, _, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    with pytest.raises(ValueError, match="c_in is"):
        ops.mlstm_chunk_bwd(*args[:5], c_st[:, :, :, :8], n_st, m_st, h,
                            torch.from_numpy(cts[0]), None, None, None)
    with pytest.raises(ValueError, match="dh is"):
        ops.mlstm_chunk_bwd(*args[:5], c_st, n_st, m_st, h, torch.zeros(1, 4, 2, 8), None,
                            None, None)
