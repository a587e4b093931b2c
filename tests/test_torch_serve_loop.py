"""The port's continuous-batching loop against the JAX package's, at the
StableLM-3B SMOKE configuration with the JAX ``init``'s parameters at
``init_scale=1`` carried across by the bridge: 6 requests of 8 new tokens,
prompts of 4-15 tokens from ``np.random.default_rng(0)`` (as
``repro/launch/serve.py`` makes them), 2 slots, a 32-long cache. At that
scale the layers steer the greedy tokens; at the reference scale (0.02)
only the embedding, the final norm and the head would.

The token lists must be identical: at seed 0 the JAX run ends one request
at EOS, and its smallest top-1/top-2 logit gap is 5.7e-3, far above fp32
rounding. The port's run is deterministic, and it runs one attention per
layer for every generated token (one block prefill per request, then one
step per further token)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.lm import LM as JaxLM
from repro.runtime.serve_loop import Request as JaxRequest, serve_requests as jax_serve_requests
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import lm_requests
from repro_torch.models import attention
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import make_serve_step, serve_requests

ARCH = "stablelm_3b"
SERVE = dict(slots=2, max_seq=32)
EOS = 2


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke(ARCH), init_scale=1.0)
    jmodel = JaxLM(dataclasses.replace(jax_get_smoke(ARCH), init_scale=1.0), remat=False,
                   dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    requests = lm_requests(cfg, 6, max_new=8, seed=0)
    want = jax_serve_requests(
        jmodel, params,
        [JaxRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new) for r in requests], **SERVE)
    model = LM(cfg, "cpu")
    model.load_jax_params(params)
    return {"cfg": cfg, "model": model, "requests": requests, "want": want}


def test_tokens_identical_to_jax(setup):
    got = serve_requests(setup["model"], setup["requests"], **SERVE)
    assert got == setup["want"]
    ended = [t for t in got.values() if len(t) < 8]
    assert ended and all(t[-1] == EOS for t in ended), "the EOS path was not exercised"


def test_serving_is_deterministic(setup):
    runs = [serve_requests(setup["model"], setup["requests"], **SERVE) for _ in range(2)]
    assert runs[0] == runs[1]


def test_one_attention_per_layer_per_generated_token(setup, monkeypatch):
    calls = []
    real = attention.flash_attention_op

    def counting(*args, **kw):
        calls.append(args[0].shape[1])  # query rows: the prompt, or 1
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention_op", counting)
    got = serve_requests(setup["model"], setup["requests"], **SERVE)
    n_layers = setup["cfg"].n_layers
    assert len(calls) == n_layers * sum(len(t) for t in got.values())
    prompts = sorted(len(r.prompt) for r in setup["requests"])
    assert sorted(n for n in calls if n > 1) == sorted(p for p in prompts for _ in range(n_layers))


def test_serve_step_returns_greedy_int32_tokens(setup):
    model = setup["model"]
    state = model.init_decode_state(1, 8)
    logits, state = model.decode_step(torch.tensor([[5, 6, 7]]), state, 0)
    nxt, step_logits, state = make_serve_step(model)(torch.tensor([[9]]), state, 3)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1, 1)
    assert int(nxt) == int(torch.argmax(step_logits[0, -1]))
