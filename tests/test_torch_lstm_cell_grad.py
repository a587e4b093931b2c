"""The gradient of the port's LSTM cell (``LSTMCellFunction``: the training
forward, the pointwise backward ``lstm_cell_bwd_ref`` and the products)
against torch autograd of the plain cell and against ``jax.vjp`` of the
JAX package's jnp twin (``repro/models/seq2seq.py:63 lstm_cell``), on
inputs made with numpy from a seed. fp32 at rtol = atol = 1e-5: the same
algebra with sums in another order. On the CPU the Function runs the
plain versions, the same algebra the CUDA kernels implement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.seq2seq import LSTMState as JaxLSTMState, lstm_cell as jax_lstm_cell
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_bwd_ref,
    lstm_cell_ref,
    lstm_cell_train_ref,
)

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x", "h", "c", "wx", "wh", "b")


def draw(B, d_in, H, seed=0):
    """x, h, c, wx, wh, b and the incoming dh', dc' as numpy fp32; weights
    scaled so that the gates spread over their range."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (rnd(B, d_in), rnd(B, H), rnd(B, H), rnd(d_in, 4 * H, scale=0.4),
            rnd(H, 4 * H, scale=0.4), rnd(4 * H, scale=0.5))
    return args, rnd(B, H), rnd(B, H)


def leaves(args):
    return [torch.from_numpy(a).requires_grad_(True) for a in args]


def grads_through(fn, args, dh, dc):
    """Gradients of <dh', h'> + <dc', c'> (a None cotangent drops its term)."""
    ts = leaves(args)
    h_new, c_new = fn(*ts)
    outs = [(h_new, dh), (c_new, dc)]
    torch.autograd.backward([o for o, d in outs if d is not None],
                            [torch.from_numpy(d) for _, d in outs if d is not None])
    return [t.grad for t in ts]


def jax_grads(args, dh, dc):
    x, h, c, wx, wh, b = (jnp.asarray(a) for a in args)

    def f(p, x, h, c):
        return jax_lstm_cell(p, x, JaxLSTMState(h, c))

    out, vjp = jax.vjp(f, {"wx": wx, "wh": wh, "b": b}, x, h, c)
    ct = JaxLSTMState(jnp.zeros_like(out.h) if dh is None else jnp.asarray(dh),
                      jnp.zeros_like(out.c) if dc is None else jnp.asarray(dc))
    p, gx, gh, gc = vjp(ct)
    return [np.asarray(g) for g in (gx, gh, gc, p["wx"], p["wh"], p["b"])]


SHAPES = [(B, d_in, H) for B in (1, 7, 64) for H, d_in in ((8, 5), (33, 24), (256, 128))]


@pytest.mark.parametrize("B,d_in,H", SHAPES)
def test_function_backward_matches_autograd_and_jax(B, d_in, H):
    args, dh, dc = draw(B, d_in, H, seed=B * 1000 + H)
    got = grads_through(ops.lstm_cell_op, args, dh, dc)
    auto = grads_through(lstm_cell_ref, args, dh, dc)
    want = jax_grads(args, dh, dc)
    for name, g, a, w in zip(NAMES, got, auto, want):
        assert g is not None and g.shape == a.shape, name
        torch.testing.assert_close(g, a, **TOL, msg=lambda m: f"{name} vs autograd: {m}")
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"{name} vs jax.vjp")


@pytest.mark.parametrize("which", ["h", "c"])
def test_one_output_gets_a_gradient(which):
    """Only h' (c' unused, e.g. the decoder's last step) or only c' gets
    a gradient; the other comes in as None and counts as zero."""
    args, dh, dc = draw(7, 24, 33, seed=5)
    dh, dc = (dh, None) if which == "h" else (None, dc)
    ts = leaves(args)
    h_new, c_new = ops.lstm_cell_op(*ts)
    out, d = (h_new, dh) if which == "h" else (c_new, dc)
    out.backward(torch.from_numpy(d))
    want = jax_grads(args, dh, dc)
    for name, t, w in zip(NAMES, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL, err_msg=name)


def test_bwd_ref_treats_none_as_zero():
    args, dh, dc = draw(7, 24, 33, seed=6)
    _, c_new, gates = lstm_cell_train_ref(*(torch.from_numpy(a) for a in args))
    c = torch.from_numpy(args[2])
    zero = torch.zeros_like(c_new)
    for a, b in ((None, torch.from_numpy(dc)), (torch.from_numpy(dh), None), (None, None)):
        got = lstm_cell_bwd_ref(a, b, gates, c, c_new)
        want = lstm_cell_bwd_ref(zero if a is None else a, zero if b is None else b,
                                 gates, c, c_new)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_training_forward_is_the_serving_cell():
    """The Function's forward gives the serving op's h' and c' bit for bit,
    and gates [σ(i) | σ(f + 1) | tanh(g) | σ(o)] of z = x wx + h wh + b."""
    args, _, _ = draw(7, 24, 33, seed=7)
    ts = [torch.from_numpy(a) for a in args]
    h_new, c_new = ops.lstm_cell_op(*leaves(args))
    with torch.no_grad():
        h_srv, c_srv = ops.lstm_cell_op(*ts)
    assert torch.equal(h_new.detach(), h_srv) and torch.equal(c_new.detach(), c_srv)
    x, h, _, wx, wh, b = ts
    i, f, g, o = (x @ wx + h @ wh + b).chunk(4, dim=-1)
    want = torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1), torch.tanh(g), torch.sigmoid(o)], -1)
    torch.testing.assert_close(lstm_cell_train_ref(*ts)[2], want, **TOL)


def test_serving_path_has_no_grad_fn():
    args, _, _ = draw(4, 16, 8, seed=8)
    ts = leaves(args)
    with torch.no_grad():
        h_new, c_new = ops.lstm_cell_op(*ts)
    assert h_new.grad_fn is None and c_new.grad_fn is None
    plain = [torch.from_numpy(a) for a in args]  # no input requires grad
    h_new, c_new = ops.lstm_cell_op(*plain)
    assert h_new.grad_fn is None and c_new.grad_fn is None
    h_new, _ = ops.lstm_cell_op(*ts)
    assert type(h_new.grad_fn).__name__ == "LSTMCellFunctionBackward"


def test_bf16_with_grad_raises():
    args, _, _ = draw(4, 16, 8, seed=9)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in args]
    with pytest.raises(TypeError, match="fp32 only.*Queue 1"):
        ops.lstm_cell_op(*ts)
    with torch.no_grad():  # serving in bf16 stays
        h_new, _ = ops.lstm_cell_op(*ts)
    assert h_new.dtype == torch.bfloat16


def test_cpu_gradient_launches_no_kernel():
    before = dict(ops.LAUNCHES)
    args, dh, dc = draw(7, 24, 33, seed=10)
    grads_through(ops.lstm_cell_op, args, dh, dc)
    assert ops.LAUNCHES == before
