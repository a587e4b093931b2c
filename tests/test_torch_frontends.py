"""The port's two frontends and M-RoPE against the JAX package's: HuBERT
X-Large (``frames @ frontend/proj`` in place of the token embedding,
non-causal, the loss against per-frame ``labels``) and Qwen2-VL-72B
(``patches @ frontend/proj`` over the first positions of the token
embedding, M-RoPE over the t, h and w position streams).

``apply_mrope``, ``mrope_positions`` and the ``mrope`` branch of ``_rope``
are held at head dims 8 (SMOKE) and 128 (the published width), at positions
on both sides of ``n_frontend_tokens`` and far past it. At both SMOKE
configurations, with the JAX ``init``'s parameters at ``init_scale=1``
(constant leaves drawn at random, ``test_torch_lm.py``) carried across by
``repro_torch.bridge``: ``LM.forward`` with frames, or with patches over
fewer positions than the tokens; ``LM.loss`` and its gradients, with and
without ``remat``, ``frontend/proj`` among them, against
``jax.value_and_grad`` of the reference's ``LM.loss``; Qwen2-VL's
``decode_step`` (a block prefill, then single steps past the image grid)
and its served tokens against the reference's; the bridge both ways.
Inputs are numpy draws from a seed.

Tolerances: M-RoPE and the logits at rtol=atol=2e-5 (fp32, the same
operations; sums in another order); positions exactly; the loss at rtol
1e-5 and every gradient element at 2e-5 abs and rel; served tokens and the
bridge exactly.
"""

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
from repro.runtime.serve_loop import Request as JaxRequest, serve_requests as jax_serve_requests
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import get, get_smoke
from repro_torch.launch.serve import lm_requests
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.lm import LM
from repro_torch.runtime.serve_loop import serve_requests
from repro_torch.runtime.train_loop import (functional_loss, make_train_step, params_of,
                                            value_and_grad)
from test_torch_lm import randomize_constants

FRONTENDS = ("hubert_xlarge", "qwen2_vl_72b")
TOL = dict(rtol=2e-5, atol=2e-5)
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE widths gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(name: str, remat: bool = False):
    """The JAX model, its randomized tree and a port ``LM`` carrying it."""
    jcfg = dataclasses.replace(jax_get_smoke(name), init_scale=1.0)
    cfg = dataclasses.replace(get_smoke(name), init_scale=1.0)
    jmodel = JaxLM(jcfg, remat=remat, dtype=jnp.float32)
    tree = randomize_constants(
        jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0))))
    model = LM(cfg, "cpu", seed=1, remat=remat)
    model.load_jax_params(tree)
    return jmodel, tree, model


@pytest.fixture(scope="module", params=FRONTENDS)
def built(request):
    return (request.param, *build(request.param))


def batch_of(cfg, n_patches: int | None = None, seed: int = 0) -> dict[str, np.ndarray]:
    """Frames and labels (audio), or tokens with ``n_patches`` patches
    (vision), ``(BATCH, SEQ)`` positions, numpy draws from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((BATCH, SEQ, cfg.frontend_dim), dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if n_patches:
        batch["patches"] = rng.standard_normal((BATCH, n_patches, cfg.frontend_dim),
                                               dtype=np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(a) for k, a in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


# -- M-RoPE ---------------------------------------------------------------------

# (config, positions): SMOKE's 16-token grid of 4 and the published 256-token
# grid of 16, each straddled and passed
MROPE_CASES = [
    (get_smoke("qwen2_vl_72b"), np.array([[0, 3, 4, 15, 16, 17, 40], [5, 9, 14, 15, 16, 30, 99]])),
    (get("qwen2_vl_72b"), np.array([[0, 17, 200, 255, 256, 257, 1000],
                                    [15, 16, 31, 240, 255, 300, 70000]])),
]


@pytest.mark.parametrize("cfg,pos", MROPE_CASES, ids=["hd8", "hd128"])
def test_mrope_positions_match(cfg, pos):
    got = A.mrope_positions(torch.from_numpy(pos), cfg)
    want = np.asarray(JA.mrope_positions(jnp.asarray(pos), cfg))
    assert got.shape == (3, *pos.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    img = pos < cfg.n_frontend_tokens
    assert img.any() and (~img).any(), "the positions must straddle the image grid"
    assert (got[0].numpy()[img] == 0).all() and (got.numpy()[:, ~img] == pos[~img]).all()


@pytest.mark.parametrize("cfg,pos", MROPE_CASES, ids=["hd8", "hd128"])
def test_apply_mrope_and_rope_branch_match(cfg, pos):
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(1)
    q = rng.standard_normal((*pos.shape, cfg.n_heads, hd), dtype=np.float32)
    k = rng.standard_normal((*pos.shape, cfg.n_kv_heads, hd), dtype=np.float32)
    half = hd // 2
    sections = (half - 2 * (half // 4), half // 4, half // 4)
    assert sections == {8: (2, 1, 1), 128: (32, 16, 16)}[hd]
    pos3 = np.array(JA.mrope_positions(jnp.asarray(pos), cfg))
    got = B.apply_mrope(torch.from_numpy(q), torch.from_numpy(pos3), sections, cfg.rope_theta)
    want = JB.apply_mrope(jnp.asarray(q), jnp.asarray(pos3), sections, cfg.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tq, tk = A._rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), cfg)
    jq, jk = JA._rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), cfg)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    # equal streams reduce it to RoPE
    text = np.array(np.broadcast_to(pos, (3, *pos.shape)))
    np.testing.assert_allclose(
        B.apply_mrope(torch.from_numpy(q), torch.from_numpy(text), sections,
                      cfg.rope_theta).numpy(),
        B.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), cfg.rope_theta).numpy(),
        rtol=0, atol=0)


# -- the LM with a frontend ----------------------------------------------------------


@pytest.mark.parametrize("built,n_patches", [("hubert_xlarge", None), ("qwen2_vl_72b", None),
                                             ("qwen2_vl_72b", 5), ("qwen2_vl_72b", SEQ)],
                         indirect=["built"])
def test_forward_matches(built, n_patches):
    """Logits of frames (HuBERT), or of tokens with no patches, 5 patches
    (fewer than the positions) or one a position (Qwen2-VL)."""
    _, jmodel, tree, model = built
    batch = batch_of(model.cfg, n_patches)
    want, _ = jmodel.forward(tree, to_jax(batch))
    got = model(to_torch(batch))
    assert tuple(got.shape) == (BATCH, SEQ, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if n_patches:  # the patches reach the logits of every later position
        other = dict(batch, patches=batch["patches"] + 1)
        assert not np.allclose(model(to_torch(other))[:, -1].numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", FRONTENDS)
def test_loss_and_gradients_match_jax(name, remat):
    """``LM.loss`` and every gradient, ``frontend/proj``'s among them,
    against ``jax.value_and_grad`` of the reference's (with ``remat``,
    which changes no value)."""
    jmodel, tree, model = build(name, remat)
    batch = batch_of(model.cfg, 7, seed=2)
    want_loss, want = jax.value_and_grad(jmodel.loss)(tree, to_jax(batch))
    loss, grads = value_and_grad(functional_loss(model))(lm_params_from_jax(tree, model.cfg),
                                                         to_torch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, want), model.cfg)
    assert set(grads) == set(want) and "frontend/proj" in grads
    if name == "hubert_xlarge":  # frames replace the token embedding
        assert not grads["embed/embedding"].any()
    for path, w in want.items():
        assert grads[path].abs().max() > 0 or not w.abs().max(), f"{path} has no gradient"
        np.testing.assert_allclose(grads[path].numpy(), w.numpy(), **TOL, err_msg=path)


def test_key_bias_gradient_is_a_cancelling_sum(monkeypatch):
    """Why the card-vs-CPU check holds Qwen2-VL's key bias to its weight's
    scale: with M-RoPE at theta 1e6 over short positions every key's
    rotation is nearly the identity, so the softmax's shift invariance
    makes the key bias's gradient a sum of cotangents that nearly cancel.
    At a narrow Qwen2-VL (2 layers, 8 heads of 128 over 2 kv heads), fp32
    misses fp64 there by more than 1e-3 of the gradient's own largest
    element, while within 1e-5 of the key weight's; the query and value
    biases meet 1e-5 of their own."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = dataclasses.replace(get_smoke("qwen2_vl_72b"), rope_theta=1e6, n_frontend_tokens=256,
                              n_layers=2, init_scale=1.0, d_model=256, head_dim=128, n_heads=8,
                              n_kv_heads=2, d_ff=512, vocab_size=512)
    m32 = LM(cfg, "cpu", seed=0)
    batch = {k: torch.from_numpy(a) for k, a in batch_of(cfg, 16).items()}
    _, g32 = value_and_grad(functional_loss(m32))(params_of(m32), batch)
    m64 = LM(cfg, "cpu", seed=0, dtype=torch.float64)
    m64.load_state_dict({k: v.double() for k, v in m32.state_dict().items()})
    monkeypatch.setattr(A, "flash_attention_op", flash_attention_ref)  # fp64 through autograd
    _, g64 = value_and_grad(functional_loss(m64))(params_of(m64), batch)
    for i in range(cfg.n_layers):
        def miss(name, scale_of=None):
            want = g64[f"layers/{i}/attn/{name}"]
            scale = g64[f"layers/{i}/attn/{scale_of or name}"].abs().max()
            return ((g32[f"layers/{i}/attn/{name}"].double() - want).abs().max() / scale).item()

        assert miss("bk") > 1e-3 and miss("bk", "wk") < 1e-5
        assert miss("bq") < 1e-5 and miss("bv") < 1e-5


def test_encoder_loss_is_the_cross_entropy_of_labels():
    """The encoder-only loss: every position against its label, unshifted."""
    _, _, model = build("hubert_xlarge")
    batch = to_torch(batch_of(model.cfg, seed=3))
    logits = model(batch)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             batch["labels"].reshape(-1).long())
    torch.testing.assert_close(model.loss(batch), want, rtol=1e-6, atol=1e-6)


def test_qwen2_vl_decode_steps_match_jax():
    """A 9-token block prefill, then single steps from position 9 to 27
    (over the SMOKE image grid's end at 16) for 2 rows, each step's logits
    against the reference's ``decode_step``, and against the port's own
    ``forward`` at 1e-4."""
    jmodel, tree, model = build("qwen2_vl_72b")
    seq = batch_of(model.cfg, seed=4)["tokens"][:, :SEQ]
    seq = np.concatenate([seq, seq[:, :4]], axis=1)  # 28 positions
    full = model({"tokens": torch.from_numpy(seq)})
    jstep = jax.jit(jmodel.decode_step)
    jstate = jmodel.init_decode_state(BATCH, 32, jnp.float32)
    state = model.init_decode_state(BATCH, 32)
    for start, end in [(0, 9)] + [(i, i + 1) for i in range(9, 28)]:
        jlogits, jstate = jstep(tree, jnp.asarray(seq[:, start:end]), jstate, jnp.int32(start))
        logits, state = model.decode_step(torch.from_numpy(seq[:, start:end]), state, start)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        np.testing.assert_allclose(logits.numpy(), full[:, end - 1:end].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_qwen2_vl_served_tokens_equal_the_reference():
    """6 requests of the launcher's prompts, 10 new tokens, 2 slots, a
    32-long cache: prompts start on the image grid and decoding runs past
    it."""
    jmodel, tree, model = build("qwen2_vl_72b")
    requests = lm_requests(model.cfg, 6, max_new=10, seed=0)
    want = jax_serve_requests(
        jmodel, tree, [JaxRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
                       for r in requests], slots=2, max_seq=32)
    got = serve_requests(model, requests, slots=2, max_seq=32)
    assert got == want
    assert max(len(r.prompt) + len(got[r.uid]) for r in requests) > model.cfg.n_frontend_tokens


def test_bridge_round_trip_is_exact(built):
    name, _, tree, model = built
    flat = lm_params_from_jax(tree, model.cfg)
    assert flat["frontend/proj"].shape == (model.cfg.frontend_dim, model.cfg.d_model)
    back = lm_params_to_jax(model)
    la, ta = jax.tree_util.tree_flatten(back)
    lb, tb = jax.tree_util.tree_flatten(tree)
    assert ta == tb
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_init_matches_the_reference(name):
    """``init`` builds ``frontend/proj`` as the reference does, a normal
    truncated to ±2σ of scale ``init_scale / sqrt(frontend_dim)``, and
    keeps the token embedding and its untied head; at the published width
    (the meta device, ``jax.eval_shape``) their shapes are the reference's."""
    cfg = get_smoke(name)
    proj = LM(cfg, "cpu").frontend["proj"]
    scale = cfg.init_scale / np.sqrt(cfg.frontend_dim)
    assert proj.abs().max() <= 2 * scale and abs(proj.std().item() - 0.88 * scale) < 0.1 * scale
    shapes = jax.eval_shape(JaxLM(jax_get(name), remat=False, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    model = LM(get(name), "meta")
    assert tuple(model.frontend["proj"].shape) == shapes["frontend"]["proj"].shape
    for key in ("embedding", "lm_head"):
        assert tuple(model.embed[key].shape) == shapes["embed"][key].shape


# -- the launchers --------------------------------------------------------------------

PLANNER_ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
               "REPRO_WORKERS")


def test_serve_launcher_refuses_the_encoder_only_config():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="hubert-xlarge-smoke is encoder-only: no decode serving"):
        serve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])


def test_train_launcher_refuses_the_encoder_only_config():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="encoder-only: its loss needs frames and labels"):
        train.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])


def test_train_launcher_trains_qwen2_vl_on_token_rows(tmp_path, monkeypatch):
    """``--arch qwen2_vl_72b`` trains on ``build_dataset``'s token rows (no
    patches) through the launcher's donating step; the loss falls."""
    from repro_torch.launch import train

    for name in PLANNER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    made = []

    def recording(*args, **kwargs):
        made.append(kwargs)
        return make_train_step(*args, **kwargs)

    monkeypatch.setattr(train, "make_train_step", recording)
    history = train.main(["--arch", "qwen2_vl_72b", "--smoke", "--device", "cpu", "--steps", "8",
                          "--corpus-mb", "0.3", "--batch", "4", "--seq-len", "32",
                          "--ckpt", str(tmp_path / "ckpt")])
    assert made == [{"donate": True}]
    losses = [h["loss"] for h in history]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
