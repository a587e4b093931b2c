"""The tensor-core arithmetic of ``csrc/mlstm_chunk_bwd.cu`` on the CPU:
its products (the scores Q Kᵀ and dh Vᵀ over 64-column slices of dh added
in slice order, Q C_inᵀ, dq's (a∘dh) C_in and dS K, dv's K dC_outᵀ and
(W/g)ᵀ dh, dk's (w∘V) dC_out and dSᵀ Q, and dC's update (a∘dh)ᵀ Q) in
3xTF32 (``kernels/tf32.py``), emulated by ``mlstm_chunk_bwd_ref(...,
split_tf32=True)``. Held to the limit ``chip_smoke.py`` holds the kernel's
gradients to against fp64 autograd, 5e-5 of each tensor's largest element
(as ``tests/test_torch_mlstm_grad.py`` holds the plain backward), against
``jax.vjp`` of the JAX package's recurrence (a ``lax.scan`` over
``repro.models.xlstm._mlstm_step``) from a state carried in after a
20-step prefix, with cotangents of h alone (a train step's) and of h and
the returned state, at the shapes of ``tests/test_torch_mlstm_train_tf32.py``
and one head width that is not a multiple of 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JXL
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref, mlstm_chunk_train_ref

LIMIT = 5e-5
NAMES = ("q", "k", "v", "i_gate", "f_gate", "C", "n", "m")
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
    (1, 70, 3, 30),  # dh not a multiple of 4: the kernel's plain loads
]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def draw(b, s, H, dh, seed):
    """Inputs as chip_smoke.py draws them (0.5-scaled normals, forget gates
    shifted by 2) for a 20-step prefix and for the call, and cotangents of
    h and of the returned C, n and m."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * rng.standard_normal(shape) + shift).astype(np.float32)

    def inputs(steps):
        return (rnd(b, steps, H, dh, scale=0.5), rnd(b, steps, H, dh, scale=0.5),
                rnd(b, steps, H, dh, scale=0.5), rnd(b, steps, H), rnd(b, steps, H, shift=2.0))

    prefix, arrays = inputs(20), inputs(s)
    cts = (rnd(b, s, H, dh), rnd(b, H, dh, dh), rnd(b, H, dh), rnd(b, H))
    return prefix, arrays, cts


def scan(q, k, v, i, f, c, n, m):
    xs = tuple(jnp.moveaxis(a, 1, 0) for a in (q, k, v, i, f))
    final, hs = jax.lax.scan(JXL._mlstm_step, JXL.MLSTMState(c, n, m), xs)
    return jnp.moveaxis(hs, 0, 1), final.c, final.n, final.m


def carried_state(prefix):
    b, _, H, dh = prefix[0].shape
    zero = (np.zeros((b, H, dh, dh), np.float32), np.zeros((b, H, dh), np.float32),
            np.full((b, H), -1e30, np.float32))
    return tuple(np.asarray(t) for t in scan(*(jnp.asarray(a) for a in (*prefix, *zero)))[1:])


def jax_grads(arrays, state):
    """``jax.vjp`` of the per-step scan: a function of the cotangents of (h,
    C, n, m) -> the gradients of (q, k, v, i, f, C, n, m)."""
    _, vjp = jax.vjp(scan, *(jnp.asarray(a) for a in (*arrays, *state)))
    return lambda cts: [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got).max() > 0, f"{what} has no gradient"
    err = np.abs(got - want).max()
    assert err <= LIMIT * scale, f"{what}: max|dg| {err:.3e} > {LIMIT} x {scale:.3e}"


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_backward_meets_the_kernels_limit_against_jax(case):
    prefix, arrays, cts = draw(*case, seed=sum(case))
    state = carried_state(prefix)
    args = [torch.from_numpy(np.array(a)) for a in (*arrays, *state)]
    h, _, _, _, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    zero = tuple(np.zeros_like(c) for c in cts[1:])
    grads = jax_grads(arrays, state)
    for label, ct in (("dh", (cts[0], *zero)), ("dh+state", cts)):
        given = [torch.from_numpy(c) for c in ct]
        if label == "dh":
            given[1:] = [None, None, None]
        split = mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, *given, split_tf32=True)
        plain = mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, *given)
        for name, s, w in zip(NAMES, split, grads(ct)):
            close(s.numpy(), w, f"{label} d{name}: split vs the JAX recurrence")
        assert not all(torch.equal(s, p) for s, p in zip(split, plain)), \
            "the emulation changes the arithmetic"


def test_split_is_fp32_only():
    prefix, arrays, cts = draw(1, 3, 1, 8, seed=1)
    state = (np.zeros((1, 1, 8, 8), np.float32), np.zeros((1, 1, 8), np.float32),
             np.zeros((1, 1), np.float32))
    args = [torch.from_numpy(a) for a in (*arrays, *state)]
    h, _, _, _, c_st, n_st, m_st = mlstm_chunk_train_ref(*args)
    with pytest.raises(ValueError, match="fp32"):
        mlstm_chunk_bwd_ref(*args[:5], c_st, n_st, m_st, h, torch.from_numpy(cts[0]),
                            split_tf32=True, dtype=torch.float64)
