"""The port's Seq2Seq against the JAX package's, on parameters made by the
JAX ``init`` and shared through ``repro_torch.bridge`` (the two random
streams differ, so initialisation itself is not compared).

Tolerances: ``encode`` at 2e-5 (fp32, sums in another order); ``forward``
logits at 1e-4 (24 recurrent steps and a 24-wide attention sum in another
order); the ``loss`` scalar at 1e-5 relative; greedy ``generate`` tokens
exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.p3sapp_summarizer import CONFIG as JAX_CONFIG, SMOKE as JAX_SMOKE
from repro.models.seq2seq import Seq2Seq as JaxSeq2Seq
from repro_torch.bridge import from_jax_params, to_jax_params
from repro_torch.configs.p3sapp_summarizer import CONFIG, SMOKE
from repro_torch.data.tokenizer import END, PAD, START
from repro_torch.kernels.lstm_cell import ops
from repro_torch.models.seq2seq import Seq2Seq


def jax_params(cfg, seed=0):
    params = JaxSeq2Seq(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(cfg, params):
    model = Seq2Seq(cfg, "cpu", seed=1)
    model.load_jax_params(params)
    return model


def token_batch(cfg, b, seed=0):
    """Encoder tokens with PAD tails of several lengths and one all-PAD row
    (an abstract that cleans to nothing); decoder tokens START..END+PAD."""
    rng = np.random.default_rng(seed)
    s, t = cfg.max_abstract_len, cfg.max_title_len
    enc = rng.integers(4, cfg.vocab_size, size=(b, s)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, s + 1, size=b)):
        enc[i, n:] = PAD
    enc[-1] = PAD
    dec = rng.integers(4, cfg.vocab_size, size=(b, t)).astype(np.int32)
    dec[:, 0] = START
    for i, n in enumerate(rng.integers(2, t + 1, size=b)):
        dec[i, n - 1] = END
        dec[i, n:] = PAD
    return enc, dec


@pytest.fixture(scope="module")
def smoke():
    params = jax_params(JAX_SMOKE)
    enc, dec = token_batch(SMOKE, 6)
    return {
        "params": params,
        "jax": JaxSeq2Seq(JAX_SMOKE),
        "port": port_model(SMOKE, params),
        "enc": enc,
        "dec": dec,
        "jbatch": {"encoder_tokens": jnp.asarray(enc), "decoder_tokens": jnp.asarray(dec)},
        "tbatch": {"encoder_tokens": torch.from_numpy(enc),
                   "decoder_tokens": torch.from_numpy(dec)},
    }


def assert_tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_bridge_round_trip(smoke):
    p = smoke["params"]
    flat = from_jax_params(p)
    assert {"encoder/0/wx", "encoder/1/b", "decoder/wh", "attn_v", "out_w"} <= set(flat)
    assert_tree_equal(to_jax_params(flat), p)
    assert_tree_equal(to_jax_params(smoke["port"]), p)


def test_encode_matches(smoke):
    hs, st, mask = smoke["jax"].encode(smoke["params"], jnp.asarray(smoke["enc"]))
    with torch.no_grad():
        ths, tst, tmask = smoke["port"].encode(torch.from_numpy(smoke["enc"]))
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(st.h), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tst.c.numpy(), np.asarray(st.c), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))


def test_forward_and_loss_match(smoke):
    logits = smoke["jax"].forward(smoke["params"], smoke["jbatch"])
    loss = smoke["jax"].loss(smoke["params"], smoke["jbatch"])
    with torch.no_grad():
        tlogits = smoke["port"].forward(smoke["tbatch"])
        tloss = smoke["port"].loss(smoke["tbatch"])
    assert tuple(tlogits.shape) == logits.shape
    assert np.isfinite(tlogits.numpy()).all()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)


def test_generate_tokens_equal(smoke):
    want = np.asarray(smoke["jax"].generate(smoke["params"], jnp.asarray(smoke["enc"])))
    before = ops.LAUNCHES["lstm_cell"]
    got = smoke["port"].generate(torch.from_numpy(smoke["enc"]))
    assert ops.LAUNCHES["lstm_cell"] == before, "CPU tensors launched the kernel"
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_tokens_equal_at_config_width():
    """One batch at the published width (vocab 8000, 3 x 256 encoder,
    abstract 128, title 24)."""
    params = jax_params(JAX_CONFIG, seed=2)
    enc, _ = token_batch(CONFIG, 4, seed=2)
    want = np.asarray(JaxSeq2Seq(JAX_CONFIG).generate(params, jnp.asarray(enc)))
    got = port_model(CONFIG, params).generate(torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)


def test_model_resolves_the_card_by_default():
    """With no device named the model goes to the card, and on a machine
    without one it raises instead of picking the CPU."""
    if torch.cuda.is_available():
        assert Seq2Seq(SMOKE).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Seq2Seq(SMOKE)
