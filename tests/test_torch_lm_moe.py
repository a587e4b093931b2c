"""The port's LM at the MoE configurations against the JAX package's: the
SMOKE DeepSeek-MoE-16B and Kimi-K2 (one dense head layer with an MLP of
``d_ff_dense``, then attention and routed plus shared experts), with both
expert impls, parameters from the JAX ``init`` at ``init_scale=1`` (the
constant leaves drawn at random, ``test_torch_lm.py``) carried across by
``repro_torch.bridge``, and tokens drawn by numpy from a seed: ``forward``
logits and its load-balance term, ``loss`` (the cross entropy plus
``router_aux_weight`` times the summed term) and its gradient against
``jax.value_and_grad(LM.loss)``, with and without ``remat``; the bridge's
round trip; ``param_count()`` against the JAX tree; ``decode_step``
against the JAX one; and ``serve_requests`` token lists against the JAX
serving loop's (6 requests of 8 new tokens, 2 slots, a 32-long cache).

Tolerances: logits at rtol=atol=2e-5; the term and the loss at rtol 1e-5;
each gradient tensor within 5e-5 of its own largest element; served
tokens exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.lm import LM as JaxLM
from repro.runtime.serve_loop import Request as JaxRequest, serve_requests as jax_serve_requests
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import lm_requests
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import serve_requests
from repro_torch.runtime.train_loop import functional_loss, value_and_grad
from test_torch_lm import randomize_constants
from test_torch_lm_train import assert_grads_close

ARCHS = ("deepseek_moe_16b", "kimi_k2_1t_a32b")
IMPLS = ("ragged", "batched")
SERVE = dict(slots=2, max_seq=32)


def configs(name, impl):
    out = []
    for c in (jax_get_smoke(name), get_smoke(name)):
        c = dataclasses.replace(c, init_scale=1.0)
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, expert_impl=impl)))
    return out


@pytest.fixture(scope="module", params=[(a, i) for a in ARCHS for i in IMPLS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def arch(request):
    name, impl = request.param
    jcfg, cfg = configs(name, impl)
    jmodel = JaxLM(jcfg, remat=False, dtype=jnp.float32)
    tree = randomize_constants(
        jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0))))
    model = LM(cfg, "cpu", seed=1)
    model.load_jax_params(tree)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    return {"name": name, "jcfg": jcfg, "cfg": cfg, "jax": jmodel, "tree": tree,
            "port": model, "tokens": tokens}


def test_forward_and_its_load_balance_term_match(arch):
    t = arch["tokens"]
    want, want_aux = arch["jax"].forward(arch["tree"], {"tokens": jnp.asarray(t)})
    got, aux = arch["port"]({"tokens": torch.from_numpy(t)}, with_aux=True)
    assert np.abs(np.asarray(want)).mean() > 100 * 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0 and torch.equal(arch["port"]({"tokens": torch.from_numpy(t)}), got)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(arch, remat):
    model = LM(arch["cfg"], "cpu", seed=1, remat=remat)
    params = lm_params_from_jax(arch["tree"], model.cfg)
    batch = {"tokens": torch.from_numpy(arch["tokens"])}
    loss, grads = value_and_grad(functional_loss(model))(params, batch)
    want_loss, want = jax.value_and_grad(arch["jax"].loss)(arch["tree"],
                                                            {"tokens": jnp.asarray(arch["tokens"])})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_grads_close(grads, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, want),
                                                 model.cfg))
    assert any("/moe/router" in k for k in grads) and any("/moe/shared/" in k for k in grads)


def test_loss_adds_the_weighted_term_to_the_cross_entropy(arch):
    model, t = arch["port"], torch.from_numpy(arch["tokens"])
    logits, aux = model({"tokens": t}, with_aux=True)
    ce = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                           t[:, 1:].reshape(-1).long())
    with torch.no_grad():
        loss = model.loss({"tokens": t})
    torch.testing.assert_close(loss, ce + arch["cfg"].moe.router_aux_weight * aux,
                               rtol=1e-6, atol=1e-6)


def test_bridge_round_trip_is_exact_and_keeps_the_head(arch):
    cfg, tree = arch["cfg"], arch["tree"]
    assert len(tree["head"]) == cfg.moe.first_k_dense
    flat = lm_params_from_jax(tree, cfg)
    assert "layers/0/mlp/up" in flat and "layers/0/moe/router" not in flat
    assert flat["layers/0/mlp/up"].shape[1] == cfg.moe.d_ff_dense
    for i in range(cfg.moe.first_k_dense, cfg.n_layers):
        assert flat[f"layers/{i}/moe/w_gate"].shape == (cfg.moe.n_experts, cfg.d_model,
                                                        cfg.moe.d_expert)
        assert f"layers/{i}/moe/shared/down" in flat
    back = lm_params_to_jax(arch["port"])
    la, ta = jax.tree_util.tree_flatten(back)
    lb, tb = jax.tree_util.tree_flatten(tree)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_param_count_is_the_jax_trees_and_the_analytic_count(arch):
    leaves = jax.tree_util.tree_flatten_with_path(arch["tree"])[0]
    exact = sum(int(np.prod(leaf.shape)) for path, leaf in leaves
                if not any("norm" in str(getattr(k, "key", "")) for k in path))
    assert arch["port"].param_count() == exact == arch["cfg"].param_count()
    assert exact == {"deepseek_moe_16b": 439_296, "kimi_k2_1t_a32b": 495_616}[arch["name"]]


def test_served_tokens_equal_the_jax_loop(arch):
    cfg = arch["cfg"]
    requests = lm_requests(cfg, 6, max_new=8, seed=0)
    want = jax_serve_requests(
        arch["jax"], arch["tree"],
        [JaxRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new) for r in requests], **SERVE)
    got = serve_requests(arch["port"], requests, **SERVE)
    assert got == {uid: list(map(int, toks)) for uid, toks in want.items()}


def test_decode_steps_match_jax_and_forward(arch):
    """A 5-token block prefill, then single steps, each against the JAX
    ``decode_step`` (the load-balance term plays no part). Under ragged
    experts each step also equals the full forward pass; the batched form's
    capacity depends on the tokens of the call, so its drops differ."""
    model = arch["port"]
    seq = arch["tokens"][:1, :14]
    full = model({"tokens": torch.from_numpy(seq)})
    jstep = jax.jit(arch["jax"].decode_step)
    jstate = arch["jax"].init_decode_state(1, 16, jnp.float32)
    state = model.init_decode_state(1, 16)
    for start, end in [(0, 5)] + [(i, i + 1) for i in range(5, 14)]:
        jlogits, jstate = jstep(arch["tree"], jnp.asarray(seq[:, start:end]), jstate,
                                jnp.int32(start))
        logits, state = model.decode_step(torch.from_numpy(seq[:, start:end]), state, start)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
        if arch["cfg"].moe.expert_impl == "ragged":
            torch.testing.assert_close(logits, full[:, end - 1 : end], rtol=1e-4, atol=1e-4)
