"""bf16 training of the port's LM path, piece by piece, against the JAX
package: flash attention's bf16 plain versions (``flash_attention_train_ref``
and ``flash_attention_bwd_ref`` with bf16 inputs, the algebra of
``csrc/flash_attention_train_bf16.cu`` and ``csrc/flash_attention_bwd_bf16.cu``)
through ``FlashAttentionFunction``, ``AdamW.update_`` with bf16 parameters,
the MoE router and its combine in bf16, the activations' bf16 roundings,
and ``ArchConfig.active_param_count``.

Attention is held to ``jax.vjp`` of the reference's bf16 attention as its
LM calls it (``repro/models/attention.py:213 dispatch_sdpa``): ``sdpa``
below ``CHUNKED_THRESHOLD`` and ``chunked_sdpa`` above it, causal,
windowed, grouped, multi-query and non-causal, on inputs drawn with numpy
from a seed and rounded to bf16. fp64 decides: the plain versions in fp64
on the same bf16 values are the truth, and each of out, dq, dk and dv
(error as a fraction of the truth's largest element) must be within 2e-2
of the reference's bf16 result, or no further from the truth than the
reference's bf16 result is, times 1.5. Where the reference is ``sdpa`` the
port rounds where it does (scores, P, dP and dS·scale in bf16, D the
softmax's own sum) and the two agree all but bit for bit (measured worst
6.8e-5 of the largest element); ``chunked_sdpa`` rounds its unnormalised
probabilities chunk by chunk and differs more (measured worst 6.8e-3,
while port and reference stand 0.9e-2 to 2.8e-2 from the truth alike).

``AdamW.update_`` against ``update`` with bf16 parameters and fp32
moments: bit for bit. The router, the MoE layer's output and the
activations against the reference's own functions in bf16: bit for bit.
``active_param_count`` exactly, for all ten configurations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get as jax_get, get_smoke as jax_get_smoke
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import moe as JMOE
from repro_torch.configs import ARCH_IDS, get, get_smoke
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_train_ref
from repro_torch.models import blocks as B
from repro_torch.models import moe as MOE
from repro_torch.optim.adamw import AdamW, warmup_cosine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_numpy(shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(ml_dtypes.bfloat16)


def to_torch(a):
    """A bf16 numpy array as a bf16 tensor (through fp32, exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def to_numpy(t):
    return t.detach().float().numpy()


# (b, sq, nq, nkv, hd, causal, window); past CHUNKED_THRESHOLD the
# reference's attention is chunked_sdpa
CASES = [
    (2, 24, 4, 4, 16, True, 0),  # causal
    (2, 33, 4, 2, 16, True, 8),  # GQA and a window, ragged
    (1, 40, 16, 1, 32, True, 5),  # MQA (RecurrentGemma-9B's 16 over 1) and a window
    (2, 20, 4, 2, 80, False, 0),  # non-causal (HuBERT), StableLM-3B's head width
    (1, 65, 8, 8, 64, True, 0),  # past a 64-key tile
    (1, JA.CHUNKED_THRESHOLD + 52, 2, 1, 16, True, 0),  # chunked_sdpa, causal
    (1, JA.CHUNKED_THRESHOLD + 52, 2, 2, 16, False, 0),  # chunked_sdpa, non-causal
]


def draw(case, seed):
    b, s, nq, nkv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    # scores of a few units, as a trained layer's
    return (bf16_numpy((b, s, nq, hd), rng, 2.0), bf16_numpy((b, s, nkv, hd), rng, 2.0),
            bf16_numpy((b, s, nkv, hd), rng), bf16_numpy((b, s, nq, hd), rng))


def jax_vjp(q, k, v, dout, causal, window):
    def attn(q, k, v):
        return JA.dispatch_sdpa(q, k, v, causal=causal, window=window)

    out, pull = jax.vjp(jax.jit(attn), *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(t, np.float32) for t in (out, *pull(jnp.asarray(dout)))]


def port(q, k, v, dout, causal, window):
    leaves = [to_torch(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_op(*leaves, causal=causal, window=window)
    out.backward(to_torch(dout))
    assert out.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in leaves)
    return [to_numpy(t) for t in (out, *(t.grad for t in leaves))]


def truth(q, k, v, dout, causal, window):
    """The plain versions in fp64 on the same bf16 values."""
    q, k, v, dout = (torch.from_numpy(np.asarray(a, np.float64)) for a in (q, k, v, dout))
    out, lse = flash_attention_train_ref(q, k, v, causal=causal, window=window)
    grads = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    return [t.numpy() for t in (out, *grads)]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_function_in_bf16_against_jax_vjp(case):
    q, k, v, dout = draw(case, seed=1)
    kw = dict(causal=case[5], window=case[6])
    got, ref, exact = port(q, k, v, dout, **kw), jax_vjp(q, k, v, dout, **kw), truth(q, k, v, dout, **kw)
    for name, g, r, x in zip(("out", "dq", "dk", "dv"), got, ref, exact):
        scale = np.abs(x).max()
        vs_ref = np.abs(g - r).max() / scale
        err, ref_err = np.abs(g - x).max() / scale, np.abs(r - x).max() / scale
        assert vs_ref <= 2e-2 or err <= 1.5 * ref_err, \
            f"{name}: {vs_ref:.2e} from the reference, {err:.2e} from fp64 (reference {ref_err:.2e})"


def test_bf16_outputs_and_saved_tensors():
    """bf16 in, bf16 out and gradients; lse in fp32; q, k and v saved in
    bf16, and out not saved (the bf16 backward does not read it)."""
    q, k, v, _ = (to_torch(a).requires_grad_(True) for a in draw(CASES[1], seed=2))
    out = ops.flash_attention_op(q, k, v, causal=True, window=8)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16] * 3 + [torch.float32]
    out_ref, lse = flash_attention_train_ref(q.detach(), k.detach(), v.detach(), window=8)
    assert out_ref.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.detach(), out_ref, rtol=0, atol=0)


def test_backward_refuses_mixed_dtypes():
    q, k, v, dout = (to_torch(a) for a in draw(CASES[0], seed=3))
    out, lse = ops.flash_attention_train(q, k, v)
    with pytest.raises(ValueError, match="dout is torch.float32"):
        ops.flash_attention_bwd(q, k, v, out, lse, dout.float())
    with pytest.raises(ValueError, match="lse is torch.bfloat16"):
        ops.flash_attention_bwd(q, k, v, out, lse.bfloat16(), dout)


def test_bf16_backward_reads_no_out():
    """The bf16 backward computes D from P and dP: it takes out=None and
    gives the bits it gives with out; fp32's needs out."""
    q, k, v, dout = (to_torch(a) for a in draw(CASES[1], seed=5))
    kw = dict(causal=True, window=8)
    out, lse = ops.flash_attention_train(q, k, v, **kw)
    for a, b in zip(ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw),
                    ops.flash_attention_bwd(q, k, v, None, lse, dout, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    _, lse32 = ops.flash_attention_train(qf, kf, vf, **kw)
    with pytest.raises(ValueError, match="needs out"):
        ops.flash_attention_bwd(qf, kf, vf, None, lse32, df, **kw)


def test_adamw_update_in_place_is_update_bit_for_bit_in_bf16():
    """bf16 parameters, fp32 moments: both compute in fp32 and round into
    the parameters' dtype; three steps under a schedule, with clipping."""
    rng = np.random.default_rng(4)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 5, 7)}
    params = {k: to_torch(bf16_numpy(s, rng)) for k, s in shapes.items()}
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 1, 5), clip_norm=0.5)
    state = opt.init(params)
    assert all(t.dtype == torch.float32 for t in (*state.m.values(), *state.v.values()))
    mine = {k: t.clone() for k, t in params.items()}
    mine_state = opt.init(mine)
    for step in range(3):
        grads = {k: to_torch(bf16_numpy(s, rng, 10.0)) for k, s in shapes.items()}
        params, state, gnorm = opt.update(dict(grads), state, params)
        gnorm_ = opt.update_(dict(grads), mine_state, mine)
        assert torch.equal(gnorm, gnorm_)
        for k in shapes:
            assert params[k].dtype == mine[k].dtype == torch.bfloat16
            assert torch.equal(params[k], mine[k]), (step, k)
            assert torch.equal(state.m[k], mine_state.m[k]) and torch.equal(state.v[k],
                                                                             mine_state.v[k])
    assert int(state.count) == int(mine_state.count) == 3


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_as_the_reference_in_bf16(act):
    x = bf16_numpy((64, 96), np.random.default_rng(5), 3.0)
    want = np.asarray(jax.jit(JB._ACTS[act])(jnp.asarray(x)), np.float32)
    got = B._ACTS[act](to_torch(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got), want)
    x32 = np.asarray(x, np.float32)  # fp32 keeps its fused form
    np.testing.assert_allclose(to_numpy(B._ACTS[act](torch.from_numpy(x32))),
                               np.asarray(jax.jit(JB._ACTS[act])(x32)), rtol=2e-6, atol=2e-6)


def moe_setup(seed):
    """DeepSeek-MoE-16B's SMOKE MoE layer in bf16 (the router fp32, as both
    inits make it) and a bf16 input, as numpy."""
    cfg = dataclasses.replace(get_smoke("deepseek_moe_16b"), init_scale=1.0)
    jcfg = dataclasses.replace(jax_get_smoke("deepseek_moe_16b"), init_scale=1.0)
    p = jax.tree_util.tree_map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(seed), jcfg,
                                                         jnp.bfloat16))
    x = bf16_numpy((4, 24, cfg.d_model), np.random.default_rng(seed))
    return cfg, jcfg, p, x


def test_bf16_router_is_promoted_to_fp32():
    """A router held in bf16 routes as JAX's ``fp32 @ bf16`` promotion does;
    the port's init keeps it in fp32, as the reference's."""
    cfg, jcfg, p, x = moe_setup(6)
    xf = x.reshape(-1, cfg.d_model)
    router = np.asarray(p["router"]).astype(ml_dtypes.bfloat16)
    ids, probs, aux = MOE._route(to_torch(xf), to_torch(router), cfg.moe)
    jids, jprobs, jaux = JMOE._route(jnp.asarray(xf), jnp.asarray(router), jcfg.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert probs.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(probs), np.asarray(jprobs, np.float32))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert MOE.init_moe(cfg, g, dtype=torch.bfloat16)["router"].dtype == torch.float32


def test_moe_layer_in_bf16_matches_the_reference():
    """``moe_local`` on the same bf16 input and weights: the same expert ids,
    the same y bit for bit (the combine adds each token's k weighted copies
    one after another in bf16, as the reference's scatter-add does), and its
    vjp within 2e-2 of each gradient's largest element (measured worst
    6.6e-3, the router's)."""
    cfg, jcfg, p, x = moe_setup(7)
    tp = {k: (to_torch(v) if v.dtype != np.float32 else torch.from_numpy(v.copy()))
          for k, v in p.items() if k != "shared"}
    jp = {k: jnp.asarray(v) for k, v in p.items() if k != "shared"}
    dy = bf16_numpy(x.shape, np.random.default_rng(8))
    jids = []
    route = JMOE._route

    def spy(xf, router, m):
        out = route(xf, router, m)
        jids.append(out[0])
        return out

    JMOE._route = spy
    try:
        (jy, jaux), pull = jax.vjp(lambda x, p: JMOE.moe_local(p, x, jcfg), jnp.asarray(x), jp)
    finally:
        JMOE._route = route
    jdx, jdp = pull((jnp.asarray(dy), jnp.zeros((), jnp.float32)))
    tx = to_torch(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = MOE.moe_local(leaves, tx, cfg)
    ids = MOE._route(to_torch(x).reshape(-1, cfg.d_model), tp["router"], cfg.moe)[0]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids[0]))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(y), np.asarray(jy, np.float32))
    y.backward(to_torch(dy))
    grads = {"x": tx.grad, **{k: t.grad for k, t in leaves.items()}}
    want = {"x": jdx, **jdp}
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        err = np.abs(to_numpy(g) - w).max() / np.abs(w).max()
        assert err <= 2e-2, f"{name}: {err:.2e}"


@pytest.mark.parametrize("smoke", [False, True])
def test_active_param_count_matches_the_reference(smoke):
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    for name in ARCH_IDS:
        mine, ref = (get_smoke(name), jax_get_smoke(name)) if smoke else (get(name), jax_get(name))
        assert mine.active_param_count() == ref.active_param_count(), name
        assert mine.active_param_count() <= mine.param_count()
        if mine.moe is None:
            assert mine.active_param_count() == mine.param_count()
