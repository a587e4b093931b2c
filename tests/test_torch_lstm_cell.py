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
