"""The port's RG-LRU recurrence (``repro_torch.kernels.rg_lru``) and
Griffin block (``repro_torch.models.rglru``) against the JAX package's, on
the same seeded numpy inputs.

The recurrence against the Pallas kernel in interpret mode and against the
JAX oracle (an associative scan) over the JAX suite's cases
(``tests/test_kernels.py:92-109``), with and without h0, at rtol=atol=1e-5,
the JAX suite's own tolerance (fp32, the same products in another order).
The block (``apply_rglru_mix``: a full sequence, then a block prefill from
a state and single steps) against the JAX block at 2e-5, with parameters
made by the JAX ``init`` at ``init_scale=1`` and its zero biases drawn at
random, so the recurrence and the gates move the output by O(1). On the
CPU the wrapper takes the plain version and launches nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels.rg_lru.ops import rg_lru_op as jax_rg_lru_op
from repro.kernels.rg_lru.ref import rg_lru_ref as jax_rg_lru_ref
from repro.models import rglru as JRG
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_smoke
from repro_torch.kernels.rg_lru import ops
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.models import rglru as RG

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
# (b, s, d, blk_s, blk_d) of tests/test_kernels.py:92-96
RG_CASES = [
    (1, 64, 32, 32, 32),
    (2, 128, 256, 64, 128),
    (3, 100, 48, 32, 16),  # non-divisible seq and d
]


def inputs(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    a = (0.98 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(np.float32)
    return a, (0.1 * rng.standard_normal((b, s, d))).astype(np.float32), \
        rng.standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("case", RG_CASES, ids=[str(c) for c in RG_CASES])
@pytest.mark.parametrize("with_h0", [False, True])
def test_port_matches_pallas_kernel_and_oracle(case, with_h0):
    b, s, d, blk_s, blk_d = case
    a, bb, h0 = inputs(b, s, d)
    h0 = h0 if with_h0 else None
    ja = [jnp.asarray(x) for x in (a, bb)] + [None if h0 is None else jnp.asarray(h0)]
    kernel = jax_rg_lru_op(*ja, blk_s=blk_s, blk_d=blk_d, interpret=True)
    oracle = jax_rg_lru_ref(*ja)
    before = ops.LAUNCHES["rg_lru"]
    got, last = ops.rg_lru_op(*(None if x is None else torch.from_numpy(x) for x in (a, bb, h0)))
    assert ops.LAUNCHES["rg_lru"] == before, "a CPU tensor launched the kernel"
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, d)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(last, got[:, -1])


def test_plain_version_is_the_wrapper_on_cpu_and_casts_back():
    a, bb, h0 = (torch.from_numpy(x) for x in inputs(2, 9, 12, seed=4))
    h, last = ops.rg_lru_op(a, bb, h0)
    want, want_last = rg_lru_ref(a, bb, h0)
    assert torch.equal(h, want) and torch.equal(last, want_last)
    h16, last16 = ops.rg_lru_op(a.bfloat16(), bb.bfloat16(), h0)
    assert h16.dtype == torch.bfloat16 and last16.dtype == torch.float32


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, bb, h0 = (torch.from_numpy(x) for x in inputs(1, 4, 8))
    with pytest.raises(ValueError, match="must be 3-D"):
        ops.rg_lru_op(a[0], bb[0])
    with pytest.raises(ValueError, match="b has shape"):
        ops.rg_lru_op(a, bb[:, :-1])
    with pytest.raises(ValueError, match="h0 has shape"):
        ops.rg_lru_op(a, bb, h0[:, :-1])
    with pytest.raises(ValueError, match="at least one time step"):
        ops.rg_lru_op(a[:, :0], bb[:, :0])
    # meta tensors (the dry run) get empty outputs of the kernel's shapes;
    # the checks still hold there
    h, last = ops.rg_lru_op(a.to("meta"), bb.to("meta"))
    assert h.device.type == "meta" and h.shape == a.shape and last.shape == (1, 8)
    assert last.dtype == torch.float32
    with pytest.raises(ValueError, match="b has shape"):
        ops.rg_lru_op(a.to("meta"), bb[:, :-1].to("meta"))


@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(jax_get_smoke("recurrentgemma_9b"), init_scale=1.0)
    cfg = dataclasses.replace(get_smoke("recurrentgemma_9b"), init_scale=1.0)
    jp = jax.tree_util.tree_map(np.asarray, JRG.init_rglru(jax.random.PRNGKey(3), jcfg,
                                                           jnp.float32))
    rng = np.random.default_rng(5)
    for name in ("b_r", "b_i"):
        jp[name] = (0.5 * rng.standard_normal(jp[name].shape)).astype(np.float32)
    return {"cfg": cfg, "jp": jp, "tp": from_jax_params(jp)}


def close(got, want):
    want = np.asarray(want)
    assert np.abs(want).mean() > 100 * BLOCK_TOL["atol"], "the compared values are too small"
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


def test_init_matches_the_reference(block):
    """The same shapes, dtypes and constants as ``init_rglru``: ``lam`` from
    ``RandomState(0)`` in fp32 whatever the dtype, zero biases."""
    tp = RG.init_rglru(block["cfg"], torch.Generator().manual_seed(0), torch.bfloat16)
    jp = JRG.init_rglru(jax.random.PRNGKey(0), block["cfg"], jnp.bfloat16)
    assert sorted(tp) == sorted(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == jp[name].shape, name
    assert tp["lam"].dtype == torch.float32 and tp["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["lam"].numpy(), np.asarray(jp["lam"]))
    assert not tp["b_r"].any() and not tp["b_i"].any()


def test_block_matches_full_sequence_prefill_and_steps(block):
    cfg, jp, tp = block["cfg"], block["jp"], block["tp"]
    x = np.random.default_rng(6).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want, none = JRG.apply_rglru_mix(jp, jnp.asarray(x), cfg)
    got, tnone = RG.apply_rglru_mix(tp, torch.from_numpy(x), cfg)
    assert none is None and tnone is None
    close(got, want)

    jstate = JRG.init_rglru_state(2, cfg, jnp.float32)
    state = RG.init_rglru_state(2, cfg)
    for start, end in ((0, 6), (6, 7), (7, 8), (8, 11)):
        jy, jstate = JRG.apply_rglru_mix(jp, jnp.asarray(x[:, start:end]), cfg, state=jstate)
        ty, state = RG.apply_rglru_mix(tp, torch.from_numpy(x[:, start:end]), cfg, state=state)
        close(ty, jy)
        close(ty, want[:, start:end])  # a state carried in gives the full pass's rows
        close(state.h, jstate.h)
        close(state.conv, jstate.conv)
        assert state.h.dtype == torch.float32


def test_block_runs_one_recurrence_per_call(block, monkeypatch):
    calls = []
    real = RG.rg_lru_op

    def counting(a, b, h0=None):
        calls.append((a.shape[1], h0 is not None))
        return real(a, b, h0)

    monkeypatch.setattr(RG, "rg_lru_op", counting)
    cfg, tp = block["cfg"], block["tp"]
    x = torch.zeros(1, 5, cfg.d_model)
    RG.apply_rglru_mix(tp, x, cfg)
    state = RG.init_rglru_state(1, cfg)
    _, state = RG.apply_rglru_mix(tp, x, cfg, state=state)
    RG.apply_rglru_mix(tp, x[:, :1], cfg, state=state)
    assert calls == [(5, False), (5, True), (1, True)]


@pytest.mark.parametrize("case", RG_CASES, ids=[str(c) for c in RG_CASES])
@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16_in_gives_bf16_h_and_fp32_last_like_the_pallas_kernel(case, with_h0):
    """The dtype contract the CUDA kernel keeps in one launch: a and b in
    bf16 give h in bf16 and the last h in fp32. h is the JAX op's own
    result (the Pallas kernel in interpret mode on the bf16 inputs, which
    runs in fp32 and rounds back to bf16) within one bf16 rounding; the
    last h equals, at 1e-5, the fp32 kernel's last step on the same
    (bf16-representable) inputs."""
    b, s, d, blk_s, blk_d = case
    a, bb, h0 = inputs(b, s, d, seed=7)
    h0 = h0 if with_h0 else None
    a16, b16 = (torch.from_numpy(x).bfloat16() for x in (a, bb))
    got, last = ops.rg_lru_op(a16, b16, None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.bfloat16 and last.dtype == torch.float32
    ja = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (a16, b16)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = jax_rg_lru_op(*ja, jh0, blk_s=blk_s, blk_d=blk_d, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-5)
    want32 = jax_rg_lru_op(*(x.astype(jnp.float32) for x in ja), jh0, blk_s=blk_s,
                           blk_d=blk_d, interpret=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want32)[:, -1], **TOL)


def test_wrapper_dtype_rules_on_cpu():
    """The CPU path takes any float dtypes like the JAX op; h follows a's
    dtype and the last h is fp32 whatever the inputs."""
    a, bb, h0 = (torch.from_numpy(x) for x in inputs(1, 3, 8, seed=2))
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        h, last = ops.rg_lru_op(a.to(dt), bb.to(dt), h0.to(dt))
        assert h.dtype == dt and last.dtype == torch.float32
