"""The gradient of a whole LSTM layer in the port (``LSTMLayerFunction``:
the training forward once per step, the layer's backward through time
``lstm_layer_bwd_ref``, then four products over all T·B rows) against
``jax.vjp`` of the JAX package's scan (``repro/models/seq2seq.py:73
lstm_scan``), on inputs made with numpy from a seed, with cotangents on
the hidden states alone, on the final (h, c) alone and on both. fp32 at
``tests/test_torch_lstm_cell_grad.py``'s TOL (rtol = atol = 1e-5): the
same algebra with sums in another order. The same TOL holds the layer to
the chain of per-step ``LSTMCellFunction``s, whose weight gradients are
summed step by step rather than in one product. On the CPU the Function
runs the plain versions, the algebra of ``csrc/lstm_layer_bwd.cu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.seq2seq import LSTMState as JaxLSTMState, lstm_scan
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_train_ref, lstm_layer_bwd_ref

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("xs", "h0", "c0", "wx", "wh", "b")
KINDS = ("hs", "final", "both")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(T, B, H, d_in, seed):
    """xs (T, B, d_in) time-major, h0, c0, wx, wh, b and the cotangents of
    hs, h_T and c_T as numpy fp32; weights scaled so that the gates spread
    over their range."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (rnd(T, B, d_in), rnd(B, H), rnd(B, H), rnd(d_in, 4 * H, scale=0.4),
            rnd(H, 4 * H, scale=0.4), rnd(4 * H, scale=0.5))
    return args, (rnd(T, B, H), rnd(B, H), rnd(B, H))


def cotangents(cts, kind):
    dhs, dh, dc = cts
    return (dhs, None, None) if kind == "hs" else (None, dh, dc) if kind == "final" \
        else (dhs, dh, dc)


def jax_grads(args, cts):
    xs, h0, c0, wx, wh, b = (jnp.asarray(a) for a in args)

    def f(p, xs, h, c):
        hs, final = lstm_scan(p, jnp.moveaxis(xs, 0, 1), JaxLSTMState(h, c))
        return jnp.moveaxis(hs, 1, 0), final.h, final.c

    out, vjp = jax.vjp(f, {"wx": wx, "wh": wh, "b": b}, xs, h0, c0)
    p, gx, gh, gc = vjp(tuple(jnp.zeros_like(o) if d is None else jnp.asarray(d)
                              for o, d in zip(out, cts)))
    return [np.asarray(g) for g in (gx, gh, gc, p["wx"], p["wh"], p["b"])], out


def grads_through(fn, args, cts):
    """Gradients of the inputs for <dhs, hs> + <dh, h_T> + <dc, c_T> (a None
    cotangent drops its term)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = fn(*ts)
    pairs = [(o, torch.from_numpy(d)) for o, d in zip(outs, cts) if d is not None]
    torch.autograd.backward([o for o, _ in pairs], [d for _, d in pairs])
    return [t.grad for t in ts], outs


def cell_chain(xs, h0, c0, wx, wh, b):
    """The layer as a chain of per-step ``LSTMCellFunction``s."""
    hs, h, c = [], h0, c0
    for x_t in xs:
        h, c = ops.lstm_cell_op(x_t, h, c, wx, wh, b)
        hs.append(h)
    return torch.stack(hs), h, c


SHAPES = [(T, B, H, d_in) for T in (1, 5, 17) for B in (1, 3) for H in (8, 16)
          for d_in in (4, 12)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,B,H,d_in", SHAPES)
def test_layer_function_matches_jax_vjp(T, B, H, d_in, kind):
    args, cts = draw(T, B, H, d_in, seed=T * 1000 + B * 100 + H + d_in)
    cts = cotangents(cts, kind)
    got, outs = grads_through(ops.lstm_layer_op, args, cts)
    want, jax_out = jax_grads(args, cts)
    assert type(outs[0].grad_fn).__name__ == "LSTMLayerFunctionBackward"
    for o, w in zip(outs, jax_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), **TOL)
    for name, g, w in zip(NAMES, got, want):
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name} vs jax.vjp")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,B,H,d_in", [(1, 1, 8, 4), (5, 3, 16, 12), (17, 3, 8, 12)])
def test_layer_bwd_ref_matches_jax_vjp(T, B, H, d_in, kind):
    """The plain backward alone, from the plain training forward's gates
    and cell states, with the four products written out."""
    args, cts = draw(T, B, H, d_in, seed=7 * T + B + H)
    cts = cotangents(cts, kind)
    xs, h0, c0, wx, wh, b = (torch.from_numpy(a) for a in args)
    hs, cs, gates = [h0], [c0], []
    for t in range(T):
        h, c, g = lstm_cell_train_ref(xs[t], hs[-1], cs[-1], wx, wh, b)
        hs.append(h)
        cs.append(c)
        gates.append(g)
    dhs, dh, dc = (None if d is None else torch.from_numpy(d) for d in cts)
    dz, dh0, dc0 = lstm_layer_bwd_ref(dhs, dh, dc, torch.stack(gates), torch.stack(cs), wh)
    rows = dz.reshape(T * B, 4 * H)
    got = [(rows @ wx.t()).reshape(T, B, d_in), dh0, dc0, xs.reshape(T * B, d_in).t() @ rows,
           torch.stack(hs[:-1]).reshape(T * B, H).t() @ rows, rows.sum(0)]
    want, _ = jax_grads(args, cts)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T,B,H,d_in", [(5, 3, 16, 12), (17, 1, 8, 4)])
def test_layer_matches_the_chain_of_cells(T, B, H, d_in, kind):
    args, cts = draw(T, B, H, d_in, seed=31 * T + H)
    cts = cotangents(cts, kind)
    got, outs = grads_through(ops.lstm_layer_op, args, cts)
    want, chain_outs = grads_through(cell_chain, args, cts)
    for o, w in zip(outs, chain_outs):
        assert torch.equal(o.detach(), w.detach())  # the same cell, step by step
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"d{name}: {m}")


def test_the_cpu_counts_no_launch():
    before = dict(ops.LAUNCHES)
    args, cts = draw(5, 3, 8, 4, seed=1)
    grads_through(ops.lstm_layer_op, args, cts)
    assert ops.LAUNCHES == before
    assert set(before) == {"lstm_cell", "lstm_cell_bwd", "lstm_layer_bwd"}


def test_serving_call_has_no_grad_fn_and_steps(monkeypatch):
    """Without grad the layer is ``lstm_cell_op`` once per step, with the
    same outputs as the training forward."""
    args, cts = draw(6, 3, 8, 4, seed=2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    trained = ops.lstm_layer_op(*ts)
    steps = []

    def counting(*a):
        steps.append(1)
        return ops.lstm_cell_ref(*a)

    monkeypatch.setattr(ops, "lstm_cell_op", counting)
    with torch.no_grad():
        served = ops.lstm_layer_op(*ts)
    assert len(steps) == 6
    for s, t in zip(served, trained):
        assert s.grad_fn is None
        assert torch.equal(s, t.detach())


def test_empty_sequence_passes_the_state_through():
    args, _ = draw(1, 2, 8, 4, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    hs, h, c = ops.lstm_layer_op(ts[0][:0], *ts[1:])
    assert hs.shape == (0, 2, 8) and h is ts[1] and c is ts[2]


def test_bwd_wrapper_checks_its_arguments():
    args, (dhs, dh, dc) = draw(3, 2, 8, 4, seed=4)
    _, _, gates = lstm_cell_train_ref(*(torch.from_numpy(a[0] if i == 0 else a)
                                        for i, a in enumerate(args)))
    gates = torch.stack([gates] * 3)
    cs = torch.zeros(4, 2, 8)
    wh = torch.from_numpy(args[4])
    with pytest.raises(ValueError, match="dhs"):
        ops.lstm_layer_bwd(torch.zeros(2, 2, 8), None, None, gates, cs, wh)
    with pytest.raises(ValueError, match="wh"):
        ops.lstm_layer_bwd(None, None, None, gates, cs, wh[:, :-1])
    with pytest.raises(ValueError, match="float32"):
        ops.lstm_layer_bwd(None, None, None, gates.double(), cs, wh)
    with pytest.raises(ValueError, match="T >= 1"):
        ops.lstm_layer_bwd(None, None, None, gates[:0], cs[:1], wh)
    dz, dh0, dc0 = ops.lstm_layer_bwd(None, None, None, gates, cs, wh)
    assert dz.abs().max() == 0 and dh0.abs().max() == 0 and dc0.abs().max() == 0


def test_bf16_with_grad_raises():
    args, _ = draw(3, 2, 8, 4, seed=5)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in args]
    with pytest.raises(TypeError, match="fp32 only.*Queue 1"):
        ops.lstm_layer_op(*ts)
