"""The port's LSTM cell (``repro_torch.kernels.lstm_cell``) against the JAX
package's: the Pallas kernel in interpret mode, its jnp oracle and the
model's own cell, on the same seeded numpy inputs.

fp32 at rtol=atol=2e-5 (the JAX suite's own tolerance: both sides sum the
same products in another order). bf16 at 2e-2: the port accumulates in
fp32 like the CUDA kernel, the JAX oracle rounds the products to bf16.
On the CPU the wrapper takes the plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.ops import lstm_cell_op as jax_lstm_cell_op
from repro.kernels.lstm_cell.ref import lstm_cell_ref as jax_lstm_cell_ref
from repro.models.seq2seq import LSTMState, lstm_cell as jax_model_cell
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

# (b, d_in, hidden, blk_b, blk_h): the cases of tests/test_kernels.py
LSTM_CASES = [
    (4, 16, 32, 4, 16),
    (8, 64, 64, 8, 32),
    (5, 24, 48, 8, 48),  # non-divisible batch
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def make_inputs(b, d_in, hidden, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((b, d_in), dtype=np.float32),
        "h": rng.standard_normal((b, hidden), dtype=np.float32),
        "c": rng.standard_normal((b, hidden), dtype=np.float32),
        "wx": rng.standard_normal((d_in, 4 * hidden), dtype=np.float32) * 0.1,
        "wh": rng.standard_normal((hidden, 4 * hidden), dtype=np.float32) * 0.1,
        "b": rng.standard_normal((4 * hidden,), dtype=np.float32) * 0.1,
    }


def as_f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32))


@pytest.mark.parametrize("case", LSTM_CASES, ids=[str(c) for c in LSTM_CASES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_cell_matches_jax(case, dtype):
    b, d_in, hidden, blk_b, blk_h = case
    jdt, tdt, tol = DTYPES[dtype]
    inp = make_inputs(b, d_in, hidden)
    j = {k: jnp.asarray(v, jdt) for k, v in inp.items()}
    t = {k: torch.from_numpy(v).to(tdt) for k, v in inp.items()}

    before = ops.LAUNCHES["lstm_cell"]
    ho, co = ops.lstm_cell_op(t["x"], t["h"], t["c"], t["wx"], t["wh"], t["b"])
    assert ops.LAUNCHES["lstm_cell"] == before, "a CPU tensor launched the kernel"
    assert ho.dtype == tdt and co.dtype == tdt and ho.shape == (b, hidden)

    params = {"wx": j["wx"], "wh": j["wh"], "b": j["b"]}
    kernel = jax_lstm_cell_op(j["x"], j["h"], j["c"], params, blk_b=blk_b, blk_h=blk_h,
                              interpret=True)
    oracle = jax_lstm_cell_ref(j["x"], j["h"], j["c"], j["wx"].reshape(d_in, 4, hidden),
                               j["wh"].reshape(hidden, 4, hidden), j["b"].reshape(4, hidden))
    model = jax_model_cell(params, j["x"], LSTMState(j["h"], j["c"]))
    for want_h, want_c in (kernel, oracle, (model.h, model.c)):
        np.testing.assert_allclose(as_f32(ho), as_f32(want_h), rtol=tol, atol=tol)
        np.testing.assert_allclose(as_f32(co), as_f32(want_c), rtol=tol, atol=tol)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    inp = {k: torch.from_numpy(v) for k, v in make_inputs(4, 16, 32).items()}
    args = [inp[k] for k in ("x", "h", "c", "wx", "wh", "b")]
    with pytest.raises(ValueError, match="wh has shape"):
        ops.lstm_cell_op(*args[:4], inp["wh"][:, :-1], inp["b"])
    with pytest.raises(TypeError, match="expected torch.float32"):
        ops.lstm_cell_op(*args[:5], inp["b"].double())
    with pytest.raises(ValueError, match="x and h must be 2-D"):
        ops.lstm_cell_op(inp["x"][None], *args[1:])


def test_plain_version_is_the_wrapper_on_cpu():
    inp = {k: torch.from_numpy(v) for k, v in make_inputs(5, 24, 48, seed=3).items()}
    args = [inp[k] for k in ("x", "h", "c", "wx", "wh", "b")]
    for got, want in zip(ops.lstm_cell_op(*args), lstm_cell_ref(*args)):
        assert torch.equal(got, want)


# The CUDA kernel's tiling edges (clusters of 8 hidden units x 64 batch
# rows, the contraction split four ways in tiles of 32): the plain version
# the card is held to, against the JAX oracle and model cell at fp32 2e-5.
EDGE_B, EDGE_H, EDGE_D = (1, 5, 64, 65, 130), (8, 48, 256, 264), (1, 24, 128, 256, 2048)


@pytest.mark.parametrize("H", EDGE_H)
@pytest.mark.parametrize("b", EDGE_B)
def test_plain_version_matches_jax_at_the_tiling_edges(b, H):
    for d_in in EDGE_D:
        inp = make_inputs(b, d_in, H, seed=b * 1000 + H + d_in)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        j = {k: jnp.asarray(v) for k, v in inp.items()}
        ho, co = ops.lstm_cell_op(t["x"], t["h"], t["c"], t["wx"], t["wh"], t["b"])
        oracle = jax_lstm_cell_ref(j["x"], j["h"], j["c"], j["wx"].reshape(d_in, 4, H),
                                   j["wh"].reshape(H, 4, H), j["b"].reshape(4, H))
        model = jax_model_cell({"wx": j["wx"], "wh": j["wh"], "b": j["b"]}, j["x"],
                               LSTMState(j["h"], j["c"]))
        for want_h, want_c in (oracle, (model.h, model.c)):
            np.testing.assert_allclose(ho.numpy(), np.asarray(want_h), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(co.numpy(), np.asarray(want_c), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b, d_in, H", [(3, 7008, 256), (2, 7000, 264), (1, 1, 7263),
                                        (524_280, 32, 8)])
def test_wrapper_takes_every_shape_it_took_before(b, d_in, H):
    """The kernel before this tiling staged 8 rows of [x | h] in shared
    memory, so it took d_in + H up to 7,264 and (grid y of 65,535 tiles of 8
    rows) a batch up to 524,280. The card path's checks still accept all of
    those (on meta tensors: shapes without memory); the CPU path at the
    contraction's old limit matches the JAX oracle."""
    meta = [torch.empty(shape, device="meta") for shape in
            ((b, d_in), (b, H), (b, H), (d_in, 4 * H), (H, 4 * H), (4 * H,))]
    assert ops._check(*meta) == (b, d_in, H)
    ops._card_check(*meta)
    if b * (d_in + H) <= 30_000 and (d_in + H) * 4 * H <= 8_000_000:
        inp = make_inputs(b, d_in, H, seed=d_in)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        j = {k: jnp.asarray(v) for k, v in inp.items()}
        ho, co = ops.lstm_cell_op(t["x"], t["h"], t["c"], t["wx"], t["wh"], t["b"])
        oracle = jax_lstm_cell_ref(j["x"], j["h"], j["c"], j["wx"].reshape(d_in, 4, H),
                                   j["wh"].reshape(H, 4, H), j["b"].reshape(4, H))
        np.testing.assert_allclose(ho.numpy(), np.asarray(oracle[0]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(co.numpy(), np.asarray(oracle[1]), rtol=2e-5, atol=2e-5)
    too_many = [torch.empty((ops.MAX_BATCH + 1,) + tuple(t.shape[1:]), device="meta")
                if t.dim() == 2 and t.shape[0] == b else t for t in meta]
    with pytest.raises(ValueError, match="batch"):
        ops._card_check(*too_many)
    with pytest.raises(ValueError, match="wh must be contiguous"):
        ops._card_check(*meta[:4], torch.empty((H, 8 * H), device="meta")[:, ::2], meta[5])
