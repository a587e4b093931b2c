"""The port's LM and its blocks against the JAX package's, on the SMOKE
configurations of ``ARCH_IDS``: the four attention-only dense ones
(StableLM-3B: LayerNorm, SiLU GLU; Granite-20B: MQA, GELU, no GLU;
Qwen2.5-32B: GQA, qkv bias, RMSNorm, θ=1e6; Command R+: GQA, tied
embeddings), the two recurrent ones (RecurrentGemma-9B: two RG-LRU
blocks and one local-attention block per unit, a ring KV cache of the
16-token window, two tail layers; xLSTM-1.3B: mLSTM and sLSTM blocks)
the two MoE ones (DeepSeek-MoE-16B, Kimi-K2: a dense head layer, then
attention and routed experts) and the two with a frontend (HuBERT X-Large:
frames through ``frontend/proj``, non-causal, encoder-only, so it has its
encoder cases and no decode ones; Qwen2-VL-72B: patches over the first
positions, M-RoPE), with parameters made by the JAX ``init`` at ``init_scale=1`` and carried
across by ``repro_torch.bridge``. At that scale, with the norms' scales and
biases, the qkv biases and the recurrent gates' biases drawn at random,
every sub-layer moves the logits by O(1), so a wrong MLP, norm, residual,
RoPE offset, cache position or recurrent state shows in them; at the
reference scale (0.02) the whole layer stack moves them by about 1e-6.

Tolerances: blocks, ``attend``, ``forward`` logits and each ``decode_step``
against JAX at rtol=atol=2e-5 (fp32, the same sums in another order);
``decode_step`` against the port's own ``forward`` at 1e-4 (a block
prefill and single steps against one full pass, past the window so that
the ring wraps); the final decode states against JAX's at rtol 1e-4; the
bridge exactly. Every compared tensor's mean magnitude is held above 100x
the tolerance."""

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
# static properties of the configurations, the same in every process
WITH_ATTENTION = [n for n in ARCH_IDS if "attn" in get_smoke(n).block_pattern]
ATTENTION_ONLY = [n for n in ARCH_IDS if tuple(get_smoke(n).block_pattern) == ("attn",)]
# the causal configurations, which decode (HuBERT X-Large is encoder-only)
DECODERS = [n for n in ARCH_IDS if get_smoke(n).causal]


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
        if name in ("bias", "bq", "bk", "bv", "b_r", "b_i", "b"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "b_if":  # around the reference's 0 (input) and 3 (forget)
            return (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def batch_of(cfg, b, s, seed=0):
    """A numpy batch the configuration takes: frames and labels for the
    audio frontend, tokens with patches over fewer than ``s`` positions for
    the vision one, tokens otherwise."""
    if cfg.frontend == "audio":
        rng = np.random.default_rng(seed)
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim), dtype=np.float32),
                "labels": tokens(cfg, b, s, seed + 1)}
    batch = {"tokens": tokens(cfg, b, s, seed)}
    if cfg.frontend == "vision":
        batch["patches"] = np.random.default_rng(seed + 1).standard_normal(
            (b, s // 2, cfg.frontend_dim), dtype=np.float32)
    return batch


def jax_layer(tree, cfg, i):
    """Layer ``i`` out of a JAX tree of parameters or decode state: the
    head (a MoE configuration's dense layers), position ``i % len(pattern)``
    of stacked unit ``i // len(pattern)`` after it, or the tail."""
    n_head = len(tree["head"])
    if i < n_head:
        return tree["head"][i]
    i -= n_head
    period = len(tree["units"])
    n_units = (cfg.n_layers - n_head) // period
    if i >= n_units * period:
        return tree["tail"][i - n_units * period]
    return jax.tree_util.tree_map(lambda a: a[i // period], tree["units"][i % period])


def first_layer(arch, kind):
    """(JAX parameters, port parameters) of the first layer of ``kind``."""
    i = list(arch["cfg"].block_pattern).index(kind)
    return jax_layer(arch["params"], arch["cfg"], i), arch["port"].layers[i]


def close(got, want, **tol):
    tol = tol or TOL
    want = np.asarray(want)
    assert np.abs(want).mean() > 100 * tol["atol"], "the compared values are too small to see"
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_config_copies_match_the_reference(arch):
    assert dataclasses.asdict(arch["cfg"]) == dataclasses.asdict(arch["jcfg"])
    assert dataclasses.asdict(get(arch["name"])) == dataclasses.asdict(jax_get(arch["name"]))


def test_blocks_match(arch):
    cfg = arch["cfg"]
    jp, tp = jax_layer(arch["params"], cfg, 0), arch["port"].layers[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    tx = torch.from_numpy(x)
    close(B.apply_norm(tp["norm1"], tx, cfg.norm), JB.apply_norm(jp["norm1"], x, cfg.norm))
    mlp_kinds = [k for k in cfg.block_pattern if k in ("attn", "rglru")]
    if mlp_kinds:  # xLSTM blocks have no MLP
        jp, tp = first_layer(arch, mlp_kinds[0])
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


@pytest.mark.parametrize("arch", WITH_ATTENTION, indirect=True)
def test_attend_matches_with_and_without_cache(arch):
    """The first attention layer: a full pass, then a block prefill and
    single steps into a 16-long cache (for a windowed configuration the
    ring of its 16-token window) up to position 19, so the ring wraps."""
    cfg = arch["cfg"]
    jp, tp = (p["attn"] for p in first_layer(arch, "attn"))
    x = np.random.default_rng(2).standard_normal((1, 20, cfg.d_model), dtype=np.float32)
    pos = np.arange(20)[None]
    want, _ = jax_attend(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos))
    got, none = A.attend(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    assert none is None
    close(got, want)

    max_seq = 16 if cfg.window else 20
    jcache = JA.init_kv_cache(1, max_seq, cfg, jnp.float32)
    cache = A.init_kv_cache(1, max_seq, cfg, torch.float32)
    for start, end in [(0, 6)] + [(i, i + 1) for i in range(6, 20)]:
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
        # a window narrower than the sequence differs from the full pass, and
        # so does a non-causal block, which sees no keys past the cache's end
        if cfg.causal and not cfg.window:
            close(ty, want[:, start:end])


def test_forward_matches(arch):
    batch = batch_of(arch["cfg"], 2, 12)
    want, _ = arch["jax"].forward(arch["params"], {k: jnp.asarray(a) for k, a in batch.items()})
    got = arch["port"]({k: torch.from_numpy(a) for k, a in batch.items()})
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_loss_matches(arch):
    """``LM.loss`` of a batch the configuration takes (the encoder-only one
    against its labels, unshifted) at rtol 1e-5."""
    batch = batch_of(arch["cfg"], 2, 12, seed=4)
    want = arch["jax"].loss(arch["params"], {k: jnp.asarray(a) for k, a in batch.items()})
    got = arch["port"].loss({k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", DECODERS, indirect=True)
def test_decode_steps_match(arch):
    """A 5-token block prefill, then 15 single steps (past the SMOKE window
    of 16, so a ring cache wraps), each against JAX; every step's logits
    against the port's own full forward pass; and every layer's final
    decode state against JAX's."""
    cfg, model = arch["cfg"], arch["port"]
    seq = tokens(cfg, 1, 20, seed=3)
    full = model({"tokens": torch.from_numpy(seq)})
    jstep = jax.jit(arch["jax"].decode_step)
    jstate = arch["jax"].init_decode_state(1, 24, jnp.float32)
    state = model.init_decode_state(1, 24)
    for start, end in [(0, 5)] + [(i, i + 1) for i in range(5, 20)]:
        jlogits, jstate = jstep(arch["params"], jnp.asarray(seq[:, start:end]), jstate,
                                jnp.int32(start))
        logits, state = model.decode_step(torch.from_numpy(seq[:, start:end]), state, start)
        assert tuple(logits.shape) == (1, 1, cfg.vocab_size)
        close(logits, jlogits)
        close(logits, full[:, end - 1 : end], rtol=1e-4, atol=1e-4)
    for i, (kind, got) in enumerate(zip(model.kinds, state)):
        want = jax_layer(jstate, cfg, i)
        assert type(got).__name__ == type(want).__name__, (i, kind)
        for t, w in zip(got, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_bridge_round_trip_is_exact(arch):
    params = arch["params"]
    cfg = arch["cfg"]
    flat = lm_params_from_jax(params, cfg)
    assert {k.split("/")[1] for k in flat if k.startswith("layers/")} == \
        {str(i) for i in range(cfg.n_layers)}
    for i, kind in enumerate(arch["port"].kinds):
        mixer = {"attn": "attn/wq", "rglru": "rec/lam", "mlstm": "mix/w_q", "slstm": "mix/r"}
        assert f"layers/{i}/{mixer[kind]}" in flat
    assert ("frontend/proj" in flat) == bool(cfg.frontend)
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
    JAX ``LM.init`` tree's exact parameter count, taken with
    ``jax.eval_shape`` (no memory), norms aside. For the attention-only
    configurations that is also the analytic ``param_count()``; for the
    recurrent ones the analytic count leaves out the RG-LRU gate biases
    ``b_r``/``b_i`` and counts the mLSTM gate projection as 2·d_rnn."""
    cfg = get(name)
    model = LM(cfg, "meta")
    assert model.device.type == "meta"
    shapes = jax.eval_shape(JaxLM(jax_get(name), remat=False, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    exact = sum(int(np.prod(leaf.shape)) for path, leaf in leaves
                if not any("norm" in str(getattr(k, "key", "")) for k in path))
    assert model.param_count() == exact
    if name in ATTENTION_ONLY:
        assert exact == cfg.param_count() == jax_get(name).param_count()


def test_unported_blocks_raise():
    """What the port does not take yet raises, naming its ROADMAP item: a
    block of several tokens into a ring KV cache at a position past 0."""
    base = get_smoke("stablelm_3b")
    p = A.init_attention(base, torch.Generator().manual_seed(0))
    x, pos = torch.zeros(1, 2, base.d_model), torch.arange(2)[None]
    windowed = dataclasses.replace(base, window=4)
    ring = A.init_kv_cache(1, 8, windowed)
    assert ring.k.shape[1] == 4, "a windowed configuration's cache is a ring of the window"
    A.attend(p, x, windowed, positions=pos, cache=ring)  # a block prefill at 0 is taken
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attend(p, x, windowed, positions=pos + 2, cache=ring, cache_pos=2)


def test_model_resolves_the_card_by_default():
    if torch.cuda.is_available():
        assert LM(get_smoke("stablelm_3b")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            LM(get_smoke("stablelm_3b"))
