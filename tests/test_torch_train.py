"""The port's training path against the JAX package's, on parameters made by
the JAX ``init`` and shared through ``repro_torch.bridge`` and batches made
with numpy from a seed: ``value_and_grad`` of ``Seq2Seq.loss``, one
``AdamW.update``, ``warmup_cosine`` and ``make_train_step`` with
microbatches.

Tolerances. The loss at rtol 1e-5 (fp32, sums in another order). Each
gradient tensor within 5e-5 of its own largest element at ``init_scale=1``
(measured worst 9.1e-6, ``attn_ws`` at SMOKE). At the reference init
(0.08) ``attn_ws``'s gradient is ~1e-17, rounding noise on which the two
packages disagree entirely, so there the gradients are held to 1e-6 of
the global norm instead. AdamW at rtol 1e-6 (the same fp32 operations in
the same order), and an atol of 1e-6 of the tensor's largest element: the
global norm is summed in another order, so a clipped step scales the
gradients by a factor that differs by ~1e-7, and where b1·m + (1−b1)·g
cancels that difference exceeds 1e-6 of the element.
"""

import dataclasses
import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.p3sapp_summarizer import CONFIG as JAX_CONFIG, SMOKE as JAX_SMOKE
from repro.data.batching import derive_buckets as jax_derive_buckets
from repro.data.batching import seq2seq_arrays as jax_seq2seq_arrays
from repro.data.batching import split_indices as jax_split_indices
from repro.data.tokenizer import WordTokenizer as JaxWordTokenizer
from repro.models.seq2seq import Seq2Seq as JaxSeq2Seq
from repro.optim.adamw import AdamW as JaxAdamW, AdamWState as JaxAdamWState
from repro.optim.adamw import warmup_cosine as jax_warmup_cosine
from repro.runtime.train_loop import TrainStepConfig as JaxTrainStepConfig
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.bridge import (
    adamw_state_from_jax,
    adamw_state_to_jax,
    from_jax_params,
    to_jax_params,
)
from repro_torch.configs.p3sapp_summarizer import CONFIG, SMOKE
from repro_torch.data.batching import (
    derive_buckets,
    payload_width,
    seq2seq_arrays,
    shuffled_batches,
    split_indices,
)
from repro_torch.data.synthetic import abstracts_and_titles
from repro_torch.data.tokenizer import WordTokenizer
from repro_torch.data.tokenizer import END, PAD, START
from repro_torch.models.seq2seq import Seq2Seq
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm, warmup_cosine
from repro_torch.runtime.train_loop import (
    TrainStepConfig,
    functional_loss,
    make_train_step,
    params_of,
    split_microbatches,
    value_and_grad,
)

ROOT = Path(__file__).resolve().parents[1]


def n_params(cfg) -> int:
    """2 embeddings, (encoder layers + decoder) x (wx, wh, b), attention 3,
    output 2: 19 at CONFIG."""
    return 2 + 3 * (cfg.n_encoder_layers + 1) + 3 + 2


def token_batch(cfg, b, seed=0, title_len=None):
    """Encoder tokens with PAD tails and one all-PAD row; decoder tokens
    START..END+PAD, every row ``title_len`` long when it is given."""
    rng = np.random.default_rng(seed)
    s, t = cfg.max_abstract_len, cfg.max_title_len
    enc = rng.integers(4, cfg.vocab_size, size=(b, s)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, s + 1, size=b)):
        enc[i, n:] = PAD
    enc[-1] = PAD
    dec = rng.integers(4, cfg.vocab_size, size=(b, t)).astype(np.int32)
    dec[:, 0] = START
    lens = rng.integers(2, t + 1, size=b) if title_len is None else [title_len] * b
    for i, n in enumerate(lens):
        dec[i, n - 1] = END
        dec[i, n:] = PAD
    return {"encoder_tokens": enc, "decoder_tokens": dec}


def setup(jax_cfg, cfg, b, init_scale, seed=0):
    jax_cfg = dataclasses.replace(jax_cfg, init_scale=init_scale)
    jmodel = JaxSeq2Seq(jax_cfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = Seq2Seq(dataclasses.replace(cfg, init_scale=init_scale), "cpu", seed=1)
    batch = token_batch(cfg, b, seed=seed)
    return jmodel, tree, model, batch


def port_value_and_grad(model, tree, batch):
    fn = value_and_grad(functional_loss(model))
    return fn(from_jax_params(tree), {k: torch.from_numpy(v) for k, v in batch.items()})


def jax_value_and_grad(jmodel, tree, batch):
    loss, grads = jax.value_and_grad(jmodel.loss)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), from_jax_params(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_value_and_grad_matches_jax(which):
    jcfg, cfg, b = (JAX_SMOKE, SMOKE, 6) if which == "smoke" else (JAX_CONFIG, CONFIG, 4)
    jmodel, tree, model, batch = setup(jcfg, cfg, b, init_scale=1.0)
    loss, grads = port_value_and_grad(model, tree, batch)
    want_loss, want = jax_value_and_grad(jmodel, tree, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert set(grads) == set(want) and len(grads) == n_params(cfg)
    for path, g in grads.items():
        w = want[path]
        scale = w.abs().max().item()
        assert scale > 0 and g.abs().max().item() > 0, f"{path} has no gradient"
        err = (g - w).abs().max().item()
        assert err <= 5e-5 * scale, f"{path}: max|dg| {err:.3e} > 5e-5 x {scale:.3e}"


def test_value_and_grad_at_the_reference_init():
    """init_scale 0.08: gradients held to 1e-6 of the global norm."""
    jmodel, tree, model, batch = setup(JAX_SMOKE, SMOKE, 6, init_scale=JAX_SMOKE.init_scale)
    loss, grads = port_value_and_grad(model, tree, batch)
    want_loss, want = jax_value_and_grad(jmodel, tree, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    norm = global_norm(want).item()
    for path, g in grads.items():
        err = (g - want[path]).abs().max().item()
        assert err <= 1e-6 * norm, f"{path}: max|dg| {err:.3e} > 1e-6 x {norm:.3e}"


def test_loss_fn_leaves_the_model_alone():
    _, tree, model, batch = setup(JAX_SMOKE, SMOKE, 3, init_scale=1.0)
    before = {k: v.clone() for k, v in params_of(model).items()}
    port_value_and_grad(model, tree, batch)
    for k, v in params_of(model).items():
        assert torch.equal(v, before[k]) and v.grad is None


# -- AdamW --------------------------------------------------------------------


def random_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((11,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((3, 2, 4)) * scale).astype(np.float32)}}


ADAMW_CASES = {
    # gradient scale (clipping is active above a global norm of 1), moments, start state
    "first_step": (0.05, torch.float32, None),
    "clipped": (3.0, torch.float32, None),
    "clipped_later_step": (3.0, torch.float32, 6),
    "bf16_moments": (0.05, torch.bfloat16, 4),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_jax(case):
    g_scale, moment_dtype, count = ADAMW_CASES[case]
    jdtype = jnp.bfloat16 if moment_dtype == torch.bfloat16 else jnp.float32
    params, grads = random_tree(0), random_tree(1, g_scale)
    sched = dict(learning_rate=warmup_cosine(3e-3, 3, 10), weight_decay=1e-4)
    opt = AdamW(**sched, moment_dtype=moment_dtype)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(3e-3, 3, 10), weight_decay=1e-4,
                    moment_dtype=jdtype)
    if count is None:
        jstate = jopt.init(params)
    else:
        jstate = JaxAdamWState(jnp.asarray(count, jnp.int32),
                               jax.tree.map(lambda x: jnp.asarray(x, jdtype), random_tree(2, 0.1)),
                               jax.tree.map(lambda x: jnp.asarray(x * x, jdtype),
                                            random_tree(3, 0.1)))
    state = adamw_state_from_jax(jstate)
    jp, js, jn = jopt.update(grads, jstate, params)
    p, s, n = opt.update(from_jax_params(grads), state, from_jax_params(params))
    assert isinstance(s, AdamWState) and s.count.dtype == torch.int32
    assert int(s.count) == int(js.count) == (count or 0) + 1
    if g_scale > 1:
        assert float(jn) > 1.0, "the clipping case must clip"
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    want = {"params": from_jax_params(jp), "m": from_jax_params(js.m),
            "v": from_jax_params(js.v)}
    for name, got in (("params", p), ("m", s.m), ("v", s.v)):
        for path, t in got.items():
            w = want[name][path]
            assert t.dtype == w.dtype, f"{name}/{path}"
            np.testing.assert_allclose(t.float().numpy(), w.float().numpy(), rtol=1e-6,
                                       atol=1e-6 * w.float().abs().max().item(),
                                       err_msg=f"{name}/{path}")
    back = adamw_state_to_jax(s)
    assert back.count.dtype == np.int32 and back.count.shape == ()


def test_adamw_leaves_its_arguments_alone():
    params, grads = from_jax_params(random_tree(0)), from_jax_params(random_tree(1, 3.0))
    keep = {k: v.clone() for k, v in params.items()}
    opt = AdamW()
    state = opt.init(params)
    opt.update(grads, state, params)
    assert all(torch.equal(params[k], keep[k]) for k in params)
    assert int(state.count) == 0 and all(not m.any() for m in state.m.values())


def test_warmup_cosine_matches_jax():
    for peak, warm, total in ((3e-3, 20, 300), (1e-2, 0, 100), (5e-4, 50, 40)):
        counts = np.arange(0, 301, dtype=np.int32)
        got = warmup_cosine(peak, warm, total)(torch.from_numpy(counts)).numpy()
        want = np.asarray(jax_warmup_cosine(peak, warm, total)(jnp.asarray(counts)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# -- the train step -------------------------------------------------------------


def test_split_microbatches():
    batch = {"x": torch.arange(12).reshape(6, 2), "y": torch.arange(6)}
    mb = split_microbatches(batch, 3)
    assert len(mb) == 3 and mb[1]["x"].tolist() == [[4, 5], [6, 7]] and mb[2]["y"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(batch, 4)


@pytest.fixture(scope="module")
def micro():
    """SMOKE at init_scale 1 and a batch of 8 whose titles all have the
    same length: the masked mean over tokens is then the mean of the
    microbatches' means, as the accumulation assumes."""
    jcfg = dataclasses.replace(JAX_SMOKE, init_scale=1.0)
    jmodel = JaxSeq2Seq(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    model = Seq2Seq(dataclasses.replace(SMOKE, init_scale=1.0), "cpu", seed=1)
    batch = token_batch(SMOKE, 8, seed=3, title_len=6)
    sched = (3e-3, 2, 10)
    opt = AdamW(learning_rate=warmup_cosine(*sched), weight_decay=1e-4)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(*sched), weight_decay=1e-4)
    jstep = jax_make_train_step(jmodel.loss, jopt, JaxTrainStepConfig(n_microbatches=1))
    jp, js, jm = jstep(tree, jopt.init(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"model": model, "tree": tree, "batch": batch, "opt": opt, "jopt": jopt,
            "jmodel": jmodel, "want": (from_jax_params(jp), js, jm)}


def run_port_step(micro, n):
    step = make_train_step(functional_loss(micro["model"]), micro["opt"], TrainStepConfig(n))
    params = from_jax_params(micro["tree"])
    batch = {k: torch.from_numpy(v) for k, v in micro["batch"].items()}
    return step(params, micro["opt"].init(params), batch)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_train_step_microbatches_match_each_other_and_jax(micro, n):
    p, s, metrics = run_port_step(micro, n)
    p1, _, m1 = run_port_step(micro, 1)
    jp, js, jm = micro["want"]
    assert set(metrics) == {"loss", "grad_norm"}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in metrics.values())
    np.testing.assert_allclose(float(metrics["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(s.count) == 1
    for path, t in p.items():
        torch.testing.assert_close(t, p1[path], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(t, jp[path], rtol=1e-5, atol=1e-5)
    # JAX's own accumulation over the same n
    if n > 1:
        jstep = jax_make_train_step(micro["jmodel"].loss, micro["jopt"],
                                    JaxTrainStepConfig(n_microbatches=n))
        jpn, _, jmn = jstep(micro["tree"], micro["jopt"].init(micro["tree"]),
                            {k: jnp.asarray(v) for k, v in micro["batch"].items()})
        np.testing.assert_allclose(float(metrics["loss"]), float(jmn["loss"]), rtol=1e-5)
        for path, t in from_jax_params(jax.tree_util.tree_map(np.asarray, jpn)).items():
            torch.testing.assert_close(p[path], t, rtol=1e-5, atol=1e-5)


def test_trained_params_go_back_to_jax():
    """A port step's params return to the JAX tree's structure."""
    _, tree, model, batch = setup(JAX_SMOKE, SMOKE, 3, init_scale=1.0)
    opt = AdamW()
    params = from_jax_params(tree)
    step = make_train_step(functional_loss(model), opt)
    new, _, _ = step(params, opt.init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    back = to_jax_params(new)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


# -- the data and the example ---------------------------------------------------------


def test_encoding_and_split_match_jax():
    abstracts, titles = abstracts_and_titles(50, seed=4)
    titles[3] = ""
    tok = WordTokenizer.fit(abstracts + titles, vocab_size=300)
    jtok = JaxWordTokenizer.fit(abstracts + titles, vocab_size=300)
    assert tok.itos == jtok.itos
    got = seq2seq_arrays(abstracts, titles, tok, 40, 9)
    records = [{"abstract": a, "title": t} for a, t in zip(abstracts, titles)]
    want = jax_seq2seq_arrays(records, jtok, 40, 9)
    assert set(got) == set(want) == {"encoder_tokens", "decoder_tokens"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    for max_len in (1, 5, 24, 128):
        assert derive_buckets(max_len) == jax_derive_buckets(max_len)
    for n in (0, 1, 9, 641):
        for a, b in zip(split_indices(n, 0.1, 0), jax_split_indices(n, 0.1, 0)):
            np.testing.assert_array_equal(a, b)


def test_shuffled_batches_trim_to_the_payload():
    arrays = token_batch(SMOKE, 10, seed=5)
    batches = list(itertools.islice(shuffled_batches(arrays, 4, seed=1), 6))
    assert [len(b["encoder_tokens"]) for b in batches] == [4, 4, 2] * 2
    for b in batches:
        for v in b.values():
            assert v.shape[1] == payload_width(v) and ((v[:, -1] != PAD).any() or v.shape[1] == 1)
    first_epoch = np.concatenate([b["decoder_tokens"][:, 0] for b in batches[:3]])
    assert len(first_epoch) == 10


def test_example_trains_on_the_cpu(tmp_path):
    """``examples/train_summarizer_torch.py --smoke --device cpu --steps 20
    --corpus-mb 1``: the loss falls, and a second run resumes from its
    checkpoint."""
    spec = importlib.util.spec_from_file_location(
        "train_summarizer_torch", ROOT / "examples" / "train_summarizer_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--smoke", "--device", "cpu", "--steps", "20", "--corpus-mb", "1",
            "--ckpt-dir", str(tmp_path)]
    out = example.main(argv)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert np.isfinite(out["val_loss"]) and out["tokens"] > 0
    again = example.main([a if a != "20" else "25" for a in argv])
    assert [h["step"] for h in again["history"]] == [21, 22, 23, 24, 25]
