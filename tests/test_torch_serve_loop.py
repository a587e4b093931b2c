"""The port's continuous-batching loop against the JAX package's, at the
SMOKE configurations of StableLM-3B (attention only), RecurrentGemma-9B
(RG-LRU blocks and local attention over a ring KV cache of the 16-token
window) and xLSTM-1.3B (mLSTM and sLSTM blocks), with the JAX ``init``'s
parameters at ``init_scale=1`` carried across by the bridge: 6 requests of
8 new tokens, prompts of 4-15 tokens from ``np.random.default_rng(0)`` (as
``repro/launch/serve.py`` makes them), 2 slots, a 32-long cache, so a
request reaches position 22 and the ring wraps. At that scale the layers
steer the greedy tokens; at the reference scale (0.02) only the
embedding, the final norm and the head would.

The token lists must be identical: at seed 0 the StableLM-3B run ends one
request at EOS, and its smallest top-1/top-2 logit gap is 5.7e-3, far
above fp32 rounding. The port's run is deterministic, and every layer runs
its temporal mixer (attention, the RG-LRU recurrence or the mLSTM
recurrence) once for every generated token: one block prefill per request,
then one step per further token."""

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
from repro_torch.models import attention, rglru, xlstm
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import make_serve_step, serve_requests

ARCHS = ["stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b"]
SERVE = dict(slots=2, max_seq=32)
EOS = 2
# the wrapper each block kind calls once per model pass, by (module, name)
MIXERS = {"attn": (attention, "flash_attention_op"), "rglru": (rglru, "rg_lru_op"),
          "mlstm": (xlstm, "mlstm_chunk_op")}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = dataclasses.replace(get_smoke(arch), init_scale=1.0)
    jmodel = JaxLM(dataclasses.replace(jax_get_smoke(arch), init_scale=1.0), remat=False,
                   dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    requests = lm_requests(cfg, 6, max_new=8, seed=0)
    want = jax_serve_requests(
        jmodel, params,
        [JaxRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new) for r in requests], **SERVE)
    model = LM(cfg, "cpu")
    model.load_jax_params(params)
    return {"arch": arch, "cfg": cfg, "model": model, "requests": requests, "want": want}


def test_tokens_identical_to_jax(setup):
    got = serve_requests(setup["model"], setup["requests"], **SERVE)
    assert got == setup["want"]
    ended = [t for t in got.values() if len(t) < 8]
    assert all(t[-1] == EOS for t in ended)
    if setup["arch"] == "stablelm_3b":
        assert ended, "the EOS path was not exercised"


def test_serving_is_deterministic(setup):
    runs = [serve_requests(setup["model"], setup["requests"], **SERVE) for _ in range(2)]
    assert runs[0] == runs[1]


def test_one_attention_per_layer_per_generated_token(setup, monkeypatch):
    """Every layer calls its kind's wrapper (on the CPU, its plain version)
    once per generated token: the prompt's block prefill for the first
    token, one step for each further one."""
    calls = {}
    for kind in set(setup["model"].kinds) & set(MIXERS):
        module, name = MIXERS[kind]
        calls[kind] = []

        def counting(*args, _real=getattr(module, name), _log=calls[kind], **kw):
            _log.append(args[0].shape[1])  # time steps: the prompt, or 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, counting)
    assert calls, "no block of a kind with a kernel"
    got = serve_requests(setup["model"], setup["requests"], **SERVE)
    n_tokens = sum(len(t) for t in got.values())
    prompts = sorted(len(r.prompt) for r in setup["requests"])
    for kind, log in calls.items():
        n_layers = setup["model"].kinds.count(kind)
        assert len(log) == n_layers * n_tokens, kind
        assert sorted(n for n in log if n > 1) == sorted(p for p in prompts
                                                         for _ in range(n_layers)), kind


def test_serve_step_returns_greedy_int32_tokens(setup):
    model = setup["model"]
    state = model.init_decode_state(1, 8)
    logits, state = model.decode_step(torch.tensor([[5, 6, 7]]), state, 0)
    nxt, step_logits, state = make_serve_step(model)(torch.tensor([[9]]), state, 3)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (1, 1)
    assert int(nxt) == int(torch.argmax(step_logits[0, -1]))
