"""The tensor-core arithmetic of ``csrc/mlstm_chunk_train.cu`` on the CPU:
its four products (the scores Q Kᵀ, Q C_inᵀ, W V and C's update (w∘V)ᵀ K)
in 3xTF32 (``kernels/tf32.py``), with w∘V in fp64 rounded once and s_out·C
added to the update in fp64, emulated by ``mlstm_chunk_train_ref(...,
split_tf32=True)``. Held to the tolerances ``chip_smoke.py`` holds the
kernel to (h 2e-5 abs/rel; the state and the chunks' input states 1e-4
relative and 1e-6 absolute) against the fp32 plain version and against
the JAX package's recurrence (a ``lax.scan`` over
``repro.models.xlstm._mlstm_step`` from the carried state, as
``tests/test_torch_mlstm_grad.py`` runs it; each chunk's input state is
the scan's state after the chunks before it), at CPU-sized shapes of every
kind in ``chip_smoke.py``'s ``MLSTM_BWD_SERVED`` and ``MLSTM_BWD_EDGES``:
one step, a prompt, one chunk, a chunk and a step, two chunks and a ragged
third, batches, narrow and wider heads, from a state carried in after a
20-step prefix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JXL
from repro_torch.kernels.mlstm_chunk.ref import CHUNK, mlstm_chunk_train_ref

H_TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# (b, s, H, dh)
CASES = [
    (1, 1, 2, 64),  # a decode step
    (1, 7, 2, 64),  # a prompt
    (1, 64, 2, 64),  # one chunk
    (1, 65, 2, 64),  # a chunk and a step
    (1, 200, 2, 32),  # three chunks and a ragged fourth
    (2, 65, 2, 16),
    (1, 130, 4, 64),
    (3, 1, 2, 64),
    (2, 7, 4, 16),
    (2, 64, 2, 128),  # the training step's shape, narrower
]
jax_scan = jax.jit(lambda state, xs: jax.lax.scan(JXL._mlstm_step, state, xs))


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def draw(b, s, H, dh, seed):
    """Inputs as chip_smoke.py draws them (0.5-scaled normals, forget gates
    shifted by 2) for a 20-step prefix and for the call."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * rng.standard_normal(shape) + shift).astype(np.float32)

    def inputs(steps):
        return (rnd(b, steps, H, dh, scale=0.5), rnd(b, steps, H, dh, scale=0.5),
                rnd(b, steps, H, dh, scale=0.5), rnd(b, steps, H), rnd(b, steps, H, shift=2.0))

    return inputs(20), inputs(s)


def jax_run(arrays, state):
    """The per-step recurrence over ``arrays`` from ``state`` -> (h (b, s, H,
    dh), (C, n, m)) as numpy."""
    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in arrays)
    final, hs = jax_scan(JXL.MLSTMState(*(jnp.asarray(t) for t in state)), xs)
    return np.moveaxis(np.asarray(hs), 0, 1), tuple(np.asarray(t) for t in final)


def carried_state(prefix):
    b, _, H, dh = prefix[0].shape
    zero = (np.zeros((b, H, dh, dh), np.float32), np.zeros((b, H, dh), np.float32),
            np.full((b, H), -1e30, np.float32))
    return jax_run(prefix, zero)[1]


def close(got, want, tol, what):
    got, want = (torch.as_tensor(np.array(t)) for t in (got, want))
    err = (got.double() - want.double()).abs().max().item()
    assert torch.allclose(got, want, **tol), f"{what}: max abs err {err:.3e}"


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_forward_meets_the_kernels_tolerance(case):
    prefix, arrays = draw(*case, seed=sum(case))
    state = carried_state(prefix)
    args = [torch.from_numpy(np.array(a)) for a in (*arrays, *state)]
    split = mlstm_chunk_train_ref(*args, split_tf32=True)
    plain = mlstm_chunk_train_ref(*args)
    h_jax, final_jax = jax_run(arrays, state)
    starts = range(0, case[1], CHUNK)
    states_jax = [np.stack(t) for t in zip(*(jax_run(tuple(a[:, :c0] for a in arrays), state)[1]
                                             if c0 else state for c0 in starts))]
    names = ("h", "C", "n", "m", "C_in", "n_in", "m_in")
    for name, s, p, j in zip(names, split, plain, (h_jax, *final_jax, *states_jax)):
        tol = H_TOL if name == "h" else STATE_TOL
        close(s, p, tol, f"{name}: split vs fp32 plain")
        close(s, j, tol, f"{name}: split vs the JAX recurrence")
    assert not torch.equal(split[0], plain[0])  # the emulation changes the arithmetic


def test_split_is_fp32_only():
    _, arrays = draw(1, 3, 1, 8, seed=1)
    state = (np.zeros((1, 1, 8, 8), np.float32), np.zeros((1, 1, 8), np.float32),
             np.zeros((1, 1), np.float32))
    args = [torch.from_numpy(a) for a in (*arrays, *state)]
    with pytest.raises(ValueError, match="fp32"):
        mlstm_chunk_train_ref(*args, split_tf32=True, dtype=torch.float64)
