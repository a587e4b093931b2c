"""The port's chunkwise mLSTM (``repro_torch.kernels.mlstm_chunk``) and
xLSTM blocks (``repro_torch.models.xlstm``) against the JAX package's, on
the same seeded numpy inputs.

The output against the Pallas kernel in interpret mode and the sequential
oracle over the JAX suite's cases (``tests/test_kernel_mlstm_chunk.py``),
and against the oracle at lengths that are not multiples of the chunk, at
rtol=atol=2e-5, the JAX suite's tolerance. With a state carried in (a
prefill, then single steps) against the per-step recurrence
``_mlstm_step`` run over the whole sequence; the returned state against
that recurrence's at rtol 1e-4 (``tests/test_xlstm_chunked.py``): a padded
tail, as the JAX wrapper pads, would decay it. The blocks (``mlstm_scan``,
``slstm_scan``) against the JAX blocks at 2e-5 with parameters from the
JAX ``init`` at ``init_scale=1``. On the CPU the wrapper takes the plain
version and launches nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels.mlstm_chunk.ops import mlstm_chunk_op as jax_mlstm_chunk_op
from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as jax_mlstm_chunk_ref
from repro.models import xlstm as JXL
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_smoke
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref, mlstm_step_ref
from repro_torch.models import xlstm as XL

TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# (b, s, H, dh, chunk) of tests/test_kernel_mlstm_chunk.py
CASES = [
    (1, 128, 2, 32, 32),
    (2, 128, 4, 16, 64),
    (1, 96, 2, 32, 32),
    (2, 100, 2, 16, 32),
]
jax_step = jax.jit(lambda state, xs: jax.lax.scan(JXL._mlstm_step, state, xs))


def inputs(b, s, H, dh, seed=0):
    """q, k, v ``(b, s, H, dh)`` and gates ``(b, s, H)`` as the JAX suite
    draws them: 0.5-scaled normals, forget gates shifted by 2."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (scale * rng.standard_normal(shape) + shift).astype(np.float32)

    return (rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5), rnd(b, s, H, dh, scale=0.5),
            rnd(b, s, H), rnd(b, s, H, shift=2.0))


def pack(a):
    """(b, s, H, ...) -> (b·H, s, ...), the JAX kernel's layout."""
    b, s, H = a.shape[:3]
    return jnp.moveaxis(jnp.asarray(a), 2, 1).reshape(b * H, s, *a.shape[3:])


def unpack(a, b, H):
    return np.moveaxis(np.asarray(a).reshape(b, H, *a.shape[1:]), 1, 2)


def zero_state(b, H, dh):
    return (torch.zeros(b, H, dh, dh), torch.zeros(b, H, dh), torch.full((b, H), -1e30))


def port(arrays, state, **kw):
    return ops.mlstm_chunk_op(*(torch.from_numpy(a) for a in arrays), *state, **kw)


def sequential(arrays, state):
    """``_mlstm_step`` over the whole sequence: (h (b, s, H, dh), state)."""
    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in arrays)
    final, hs = jax_step(JXL.MLSTMState(*(jnp.asarray(t.numpy()) for t in state)), xs)
    return np.moveaxis(np.asarray(hs), 0, 1), final


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_port_matches_pallas_kernel_and_oracle(case):
    b, s, H, dh, chunk = case
    arrays = inputs(b, s, H, dh)
    kernel = jax_mlstm_chunk_op(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    oracle = unpack(jax_mlstm_chunk_ref(*(pack(a) for a in arrays)), b, H)
    before = ops.LAUNCHES["mlstm_chunk"]
    got, *_ = port(arrays, zero_state(b, H, dh))
    assert ops.LAUNCHES["mlstm_chunk"] == before, "a CPU tensor launched the kernel"
    assert tuple(got.shape) == (b, s, H, dh)
    for want in (np.asarray(kernel), oracle):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version at the JAX case's own chunk gives the same
    alt = mlstm_chunk_ref(*(torch.from_numpy(a) for a in arrays), *zero_state(b, H, dh),
                          chunk=chunk)[0]
    np.testing.assert_allclose(alt.numpy(), oracle, **TOL)


@pytest.mark.parametrize("s", [1, 5, 15, 63, 65, 130])
def test_lengths_that_are_not_multiples_of_the_chunk(s):
    b, H, dh = 2, 2, 16
    arrays = inputs(b, s, H, dh, seed=s)
    got, c, n, m = port(arrays, zero_state(b, H, dh))
    want, final = sequential(arrays, zero_state(b, H, dh))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for t, w in zip((c, n, m), final):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **STATE_TOL)


@pytest.mark.parametrize("prefill", [1, 7, 64, 70])
def test_state_carried_across_prefill_and_steps(prefill):
    """A block prefill of ``prefill`` tokens, then single steps, each from
    the state the last call returned, against one sequential pass over the
    whole sequence; the memory C is updated in place."""
    b, s, H, dh = 1, prefill + 5, 4, 16
    arrays = inputs(b, s, H, dh, seed=prefill)
    want, final = sequential(arrays, zero_state(b, H, dh))
    c, n, m = zero_state(b, H, dh)
    for start, end in [(0, prefill)] + [(t, t + 1) for t in range(prefill, s)]:
        h, c_out, n, m = port([a[:, start:end] for a in arrays], (c, n, m))
        assert c_out is c, "C is updated in place"
        np.testing.assert_allclose(h.numpy(), want[:, start:end], **TOL)
    for t, w in zip((c, n, m), final):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **STATE_TOL)


def test_no_padding_decays_the_returned_state():
    """What the JAX wrapper's zero padding would do: a forget gate of 0 at
    each padded step multiplies the memory by σ(0) = 1/2. The port's state
    after 5 steps equals the 5-step recurrence's; the recurrence run over
    the 64 padded steps keeps almost nothing of it (memory n·e^m)."""
    b, s, H, dh = 1, 5, 2, 16
    arrays = inputs(b, s, H, dh, seed=9)
    _, c, n, m = port(arrays, zero_state(b, H, dh))
    _, final = sequential(arrays, zero_state(b, H, dh))
    for t, w in zip((c, n, m), final):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **STATE_TOL)
    padded = [np.concatenate([a, np.zeros((b, 59) + a.shape[2:], np.float32)], 1)
              for a in arrays]
    _, pad_final = sequential(padded, zero_state(b, H, dh))

    def memory(state):
        return np.asarray(state.n, np.float64) * np.exp(np.asarray(state.m, np.float64))[..., None]

    assert np.abs(memory(pad_final)).max() < 1e-6 * np.abs(memory(final)).max()


def carried(arrays, prefix, b, H, dh):
    """The state after ``prefix`` steps of the plain chunkwise version."""
    if prefix == 0:
        return zero_state(b, H, dh)
    return mlstm_chunk_ref(*(torch.from_numpy(a[:, :prefix]) for a in arrays),
                           *zero_state(b, H, dh))[1:]


@pytest.mark.parametrize("b, H, dh", [(1, 1, 64), (1, 4, 16), (2, 4, 32), (3, 2, 8)])
def test_step_ref_is_the_chunk_ref_at_one_step(b, H, dh):
    """``mlstm_step_ref``, the plain version of the kernel's decode path,
    against ``mlstm_chunk_ref`` at L = 1 from a zero state and from states
    carried over 1, 20 and 70 steps (C grown to tens); the CPU wrapper
    still takes ``mlstm_chunk_ref`` for one step."""
    arrays = inputs(b, 71, H, dh, seed=dh + H)
    for prefix in (0, 1, 20, 70):
        state = carried(arrays, prefix, b, H, dh)
        step = [torch.from_numpy(a[:, prefix : prefix + 1]) for a in arrays]
        want = mlstm_chunk_ref(*step, *state)
        for g, w in zip(mlstm_step_ref(*step, *state), want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        c = state[0].clone()
        wrapped = ops.mlstm_chunk_op(*step, c, *state[1:])
        for g, w in zip(wrapped, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="one time step"):
        mlstm_step_ref(*(torch.from_numpy(a[:, :2]) for a in arrays), *zero_state(b, H, dh))


@pytest.fixture(scope="module")
def pallas_run():
    """The JAX kernel in interpret mode over 71 steps from a zero state."""
    b, s, H, dh = 1, 71, 2, 32
    arrays = inputs(b, s, H, dh, seed=11)
    out = jax_mlstm_chunk_op(*(jnp.asarray(a) for a in arrays), chunk=32, interpret=True)
    return arrays, np.asarray(out)


@pytest.mark.parametrize("t", [0, 1, 6, 31, 32, 63, 64, 70])
def test_step_ref_matches_pallas_kernel_from_carried_states(pallas_run, t):
    """Step t of the JAX kernel's output (chunks of 32) against one
    ``mlstm_step_ref`` from the state the plain version carried over the
    first t steps."""
    arrays, want = pallas_run
    b, _, H, dh = arrays[0].shape
    state = carried(arrays, t, b, H, dh)
    h, *_ = mlstm_step_ref(*(torch.from_numpy(a[:, t : t + 1]) for a in arrays), *state)
    np.testing.assert_allclose(h.numpy()[:, 0], want[:, t], **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    arrays = [torch.from_numpy(a) for a in inputs(1, 3, 2, 8)]
    c, n, m = zero_state(1, 2, 8)
    with pytest.raises(ValueError, match="must be 4-D"):
        ops.mlstm_chunk_op(arrays[0][0], *arrays[1:], c, n, m)
    with pytest.raises(ValueError, match="c has shape"):
        ops.mlstm_chunk_op(*arrays, c[..., :4], n, m)
    with pytest.raises(ValueError, match="f_gate has shape"):
        ops.mlstm_chunk_op(*arrays[:4], arrays[4][:, :2], c, n, m)
    with pytest.raises(TypeError, match="must be float32"):
        ops.mlstm_chunk_op(*arrays, c, n, m.double())
    with pytest.raises(ValueError, match="at least one time step"):
        ops.mlstm_chunk_op(*(a[:, :0] for a in arrays), c, n, m)
    # meta tensors (the dry run) get empty outputs of the kernel's shapes,
    # C itself returned; the checks still hold there
    meta = [a.to("meta") for a in arrays]
    c_meta = c.to("meta")
    h, c_out, n_out, m_out = ops.mlstm_chunk_op(*meta, c_meta, n.to("meta"), m.to("meta"))
    assert h.device.type == "meta" and h.shape == arrays[0].shape and c_out is c_meta
    assert (n_out.shape, m_out.shape) == (n.shape, m.shape)
    with pytest.raises(ValueError, match="c has shape"):
        ops.mlstm_chunk_op(*meta, c_meta[..., :4], n.to("meta"), m.to("meta"))


@pytest.fixture(scope="module")
def blocks():
    jcfg = dataclasses.replace(jax_get_smoke("xlstm_1_3b"), init_scale=1.0)
    cfg = dataclasses.replace(get_smoke("xlstm_1_3b"), init_scale=1.0)
    rng = np.random.default_rng(7)
    out = {"cfg": cfg}
    for kind, init in (("mlstm", JXL.init_mlstm), ("slstm", JXL.init_slstm)):
        jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(4), jcfg, jnp.float32))
        bias = "b_if" if kind == "mlstm" else "b"
        jp[bias] = (jp[bias] + 0.5 * rng.standard_normal(jp[bias].shape)).astype(np.float32)
        out[kind] = (jp, from_jax_params(jp))
    return out


def close(got, want):
    want = np.asarray(want)
    assert np.abs(want).mean() > 100 * TOL["atol"], "the compared values are too small"
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_matches_the_reference(blocks):
    cfg = blocks["cfg"]
    g = torch.Generator().manual_seed(0)
    for kind, init, jinit in (("mlstm", XL.init_mlstm, JXL.init_mlstm),
                              ("slstm", XL.init_slstm, JXL.init_slstm)):
        tp, jp = init(cfg, g), jinit(jax.random.PRNGKey(0), cfg, jnp.float32)
        assert sorted(tp) == sorted(jp)
        for name, t in tp.items():
            assert tuple(t.shape) == jp[name].shape, (kind, name)
    np.testing.assert_array_equal(XL.init_mlstm(cfg, g)["b_if"].numpy(),
                                  np.asarray(JXL.init_mlstm(jax.random.PRNGKey(0), cfg,
                                                            jnp.float32)["b_if"]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_full_sequence_prefill_and_steps(blocks, kind):
    cfg = blocks["cfg"]
    jp, tp = blocks[kind]
    jscan, scan = {"mlstm": (JXL.mlstm_scan, XL.mlstm_scan),
                   "slstm": (JXL.slstm_scan, XL.slstm_scan)}[kind]
    jinit, init = {"mlstm": (JXL.init_mlstm_state, XL.init_mlstm_state),
                   "slstm": (JXL.init_slstm_state, XL.init_slstm_state)}[kind]
    x = np.random.default_rng(8).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want, _ = jscan(jp, jnp.asarray(x), cfg)
    got, _ = scan(tp, torch.from_numpy(x), cfg)
    close(got, want)

    jstate, state = jinit(2, cfg), init(2, cfg)
    for start, end in ((0, 4), (4, 5), (5, 6), (6, 9)):
        jy, jstate = jscan(jp, jnp.asarray(x[:, start:end]), cfg, state=jstate)
        ty, state = scan(tp, torch.from_numpy(x[:, start:end]), cfg, state=state)
        close(ty, jy)
        close(ty, want[:, start:end])
    for t, w in zip(state, jstate):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **STATE_TOL)
