"""The port's LM and its blocks against the JAX package's, on the four
attention-only dense SMOKE configurations (StableLM-3B: LayerNorm, SiLU
GLU; Granite-20B: MQA, GELU, no GLU; Qwen2.5-32B: GQA, qkv bias, RMSNorm,
θ=1e6; Command R+: GQA, tied embeddings), with parameters made by the JAX
``init`` at ``init_scale=1`` and carried across by ``repro_torch.bridge``.
At that scale, with the norms' scales and biases and the qkv biases drawn at
random, every sub-layer moves the logits by O(1), so a wrong MLP, norm,
residual, RoPE offset or cache position shows in them; at the reference
scale (0.02) the whole layer stack moves them by about 1e-6.

Tolerances: blocks, ``attend``, ``forward`` logits and each ``decode_step``
against JAX at rtol=atol=2e-5 (fp32, the same sums in another order);
``decode_step`` against the port's own ``forward`` at 1e-4 (a block
prefill and single steps against one full pass); the bridge exactly. Every
compared tensor's mean magnitude is held above 100x the tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get, get_smoke as jax_get_smoke
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import ARCH_IDS, get, get_smoke
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.lm import LM

TOL = dict(rtol=2e-5, atol=2e-5)
jax_attend = jax.jit(JA.attend, static_argnums=2)


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    name = request.param
    jcfg = dataclasses.replace(jax_get_smoke(name), init_scale=1.0)
    cfg = dataclasses.replace(get_smoke(name), init_scale=1.0)
    jmodel = JaxLM(jcfg, remat=False, dtype=jnp.float32)
    params = randomize_constants(
        jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0))))
    model = LM(cfg, "cpu", seed=1)
    model.load_jax_params(params)
    return {"name": name, "jcfg": jcfg, "cfg": cfg, "jax": jmodel, "params": params,
            "port": model}


def randomize_constants(params, seed=0):
    """The leaves ``init`` sets to constants (norm scales of 1, biases of 0)
    drawn at random instead, so that a wrong scale or bias shows."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ("bias", "bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def layer0(params):
    """Layer 0's parameters out of the JAX tree's stacked unit."""
    return jax.tree_util.tree_map(lambda a: a[0], params["units"][0])


def close(got, want, **tol):
    tol = tol or TOL
    want = np.asarray(want)
    assert np.abs(want).mean() > 100 * tol["atol"], "the compared values are too small to see"
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_config_copies_match_the_reference(arch):
    assert dataclasses.asdict(arch["cfg"]) == dataclasses.asdict(arch["jcfg"])
    assert dataclasses.asdict(get(arch["name"])) == dataclasses.asdict(jax_get(arch["name"]))


def test_blocks_match(arch):
    cfg, jp, tp = arch["cfg"], layer0(arch["params"]), arch["port"].layers[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    tx = torch.from_numpy(x)
    close(B.apply_norm(tp["norm1"], tx, cfg.norm), JB.apply_norm(jp["norm1"], x, cfg.norm))
    # 3x: pre-activations of |z| ~ 2.6, where GELU's tanh and erf forms differ
    close(B.apply_mlp(tp["mlp"], 3 * tx, cfg), JB.apply_mlp(jp["mlp"], 3 * x, cfg))
    hd = cfg.resolved_head_dim
    h = rng.standard_normal((2, 7, cfg.n_heads, hd), dtype=np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]])
    close(B.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), cfg.rope_theta),
          JB.apply_rope(jnp.asarray(h), jnp.asarray(pos), cfg.rope_theta))
    t = torch.from_numpy(tokens(cfg, 2, 7))
    close(B.embed_tokens(arch["port"].embed, t, cfg),
          JB.embed_tokens(arch["params"]["embed"], jnp.asarray(t.numpy()), cfg))
    close(B.lm_logits(arch["port"].embed, tx, cfg), JB.lm_logits(arch["params"]["embed"], x, cfg))


def test_attend_matches_with_and_without_cache(arch):
    cfg, jp, tp = arch["cfg"], layer0(arch["params"])["attn"], arch["port"].layers[0]["attn"]
    x = np.random.default_rng(2).standard_normal((1, 9, cfg.d_model), dtype=np.float32)
    pos = np.arange(9)[None]
    want, _ = jax_attend(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos))
    got, none = A.attend(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    assert none is None
    close(got, want)

    # block prefill of 6 tokens into a 16-long cache, then 3 single steps
    jcache = JA.init_kv_cache(1, 16, cfg, jnp.float32)
    cache = A.init_kv_cache(1, 16, cfg, torch.float32)
    for start, end in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jy, jcache = jax_attend(jp, jnp.asarray(x[:, start:end]), cfg,
                               positions=jnp.asarray(pos[:, start:end]), cache=jcache,
                               cache_pos=start)
        ty, new = A.attend(tp, torch.from_numpy(x[:, start:end]), cfg,
                           positions=torch.from_numpy(pos[:, start:end]), cache=cache,
                           cache_pos=start)
        assert new.k is cache.k and new.v is cache.v, "the cache is written in place"
        close(ty, jy)
        close(cache.k, jcache.k)
        close(cache.v, jcache.v)
    close(ty, want[:, -1:])  # the last step equals the full pass's last row


def test_forward_matches(arch):
    t = tokens(arch["cfg"], 2, 12)
    want, _ = arch["jax"].forward(arch["params"], {"tokens": jnp.asarray(t)})
    got = arch["port"]({"tokens": torch.from_numpy(t)})
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_decode_steps_match(arch):
    """A 5-token block prefill, then 4 single steps, each against JAX; and
    every step's logits against the port's own full forward pass."""
    cfg, model = arch["cfg"], arch["port"]
    seq = tokens(cfg, 1, 9, seed=3)
    full = model({"tokens": torch.from_numpy(seq)})
    jstep = jax.jit(arch["jax"].decode_step)
    jstate = arch["jax"].init_decode_state(1, 16, jnp.float32)
    state = model.init_decode_state(1, 16)
    for start, end in ((0, 5), (5, 6), (6, 7), (7, 8), (8, 9)):
        jlogits, jstate = jstep(arch["params"], jnp.asarray(seq[:, start:end]), jstate,
                                jnp.int32(start))
        logits, state = model.decode_step(torch.from_numpy(seq[:, start:end]), state, start)
        assert tuple(logits.shape) == (1, 1, cfg.vocab_size)
        close(logits, jlogits)
        close(logits, full[:, end - 1 : end], rtol=1e-4, atol=1e-4)
    close(state[-1].k, jstate["units"][0].k[-1])


def test_bridge_round_trip_is_exact(arch):
    params = arch["params"]
    flat = lm_params_from_jax(params, arch["cfg"])
    assert f"layers/{arch['cfg'].n_layers - 1}/attn/wq" in flat
    back = lm_params_to_jax(arch["port"])
    la, ta = jax.tree_util.tree_flatten(back)
    lb, tb = jax.tree_util.tree_flatten(params)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_config_parameter_count_on_meta(name):
    """The published width, built on the meta device (no memory), has the
    analytic parameter count (norms aside)."""
    cfg = get(name)
    model = LM(cfg, "meta")
    assert model.device.type == "meta"
    assert model.param_count() == cfg.param_count() == jax_get(name).param_count()


def test_unported_blocks_raise():
    base = get_smoke("stablelm_3b")
    for cfg in (dataclasses.replace(base, block_pattern=("rglru", "attn")),
                dataclasses.replace(base, frontend="vision"),
                dataclasses.replace(base, moe=object()),
                dataclasses.replace(base, window=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LM(cfg, "cpu")
    p = A.init_attention(base, torch.Generator().manual_seed(0))
    x, pos = torch.zeros(1, 2, base.d_model), torch.arange(2)[None]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attend(p, x, dataclasses.replace(base, rope="mrope"), positions=pos)
    windowed = dataclasses.replace(base, window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attend(p, x, windowed, positions=pos, cache=A.init_kv_cache(1, 8, windowed))


def test_model_resolves_the_card_by_default():
    if torch.cuda.is_available():
        assert LM(get_smoke("stablelm_3b")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            LM(get_smoke("stablelm_3b"))
