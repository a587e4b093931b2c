"""``AdamW.update_`` and the donating train step: the in-place form of the
port's AdamW and of ``make_train_step`` (the counterpart of the reference
launcher's ``jax.jit(step, donate_argnums=(0, 1))``).

``update_`` writes params, m, v and count into the tensors it was given
(the same ``data_ptr`` after as before) and gives ``update``'s values bit
for bit over 5 steps of ``warmup_cosine``, with the clipping active and
not, with bf16 moments and with bf16 params; the 5 steps also track the
JAX package's ``AdamW.update`` at rtol 1e-6 (as ``test_torch_train.py``
holds ``update``). The donating step of a SMOKE StableLM-3B gives the
functional step's params, moments, losses and norms bit for bit, with and
without microbatches, and returns the tensors it was given. Under the
donating step a ``TrainController`` run to step 10 and resumed to step 20
restores the saved state bit for bit and ends where an uninterrupted run
ends; ``Checkpointer.save`` and ``save_async`` write the state of the step
they were called at, whatever the later steps write in place.
Inputs are numpy draws from a seed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import warmup_cosine as jax_warmup_cosine
from repro_torch.bridge import from_jax_params
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.tree import flatten_with_paths, map_with_paths
from repro_torch.configs import get_smoke
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamW, AdamWState, warmup_cosine
from repro_torch.runtime.fault_tolerance import TrainController
from repro_torch.runtime.train_loop import (TrainStepConfig, functional_loss, make_train_step,
                                            params_of)

STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal((11,)) * scale).astype(np.float32),
                  "d": (rng.standard_normal((3, 2, 4)) * scale).astype(np.float32)}}


def clone(tree):
    return map_with_paths(lambda _, t: t.clone(), tree)


def assert_bit_equal(got, want):
    for (path, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# gradient scale (clipping is active above a global norm of 1), clip norm,
# moments' dtype, params' dtype
INPLACE_CASES = {
    "clipped": (3.0, 1.0, torch.float32, torch.float32),
    "unclipped": (0.05, 1.0, torch.float32, torch.float32),
    "no_clip_norm": (3.0, 0.0, torch.float32, torch.float32),
    "bf16_moments": (3.0, 1.0, torch.bfloat16, torch.float32),
    "bf16_params": (0.05, 1.0, torch.float32, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(INPLACE_CASES))
def test_update_in_place_is_update_bit_for_bit(case):
    g_scale, clip, moment_dtype, param_dtype = INPLACE_CASES[case]
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 3, 10), weight_decay=1e-4, clip_norm=clip,
                moment_dtype=moment_dtype)
    params = {k: t.to(param_dtype) for k, t in from_jax_params(random_tree(0)).items()}
    state = opt.init(params)
    fparams, fstate = clone(params), clone(state)
    ptrs = [t.data_ptr() for _, t in flatten_with_paths((params, state))]
    for step in range(STEPS):
        grads = from_jax_params(random_tree(10 + step, g_scale))
        fparams, fstate, fnorm = opt.update({k: g.clone() for k, g in grads.items()}, fstate,
                                            fparams)
        norm = opt.update_(grads, state, params)
        assert grads == {}, "update_ drops every gradient it used"
        assert torch.equal(norm, fnorm)
        if clip and g_scale > 1:
            assert float(norm) > clip, "the clipping case must clip"
        assert_bit_equal((params, state), (fparams, fstate))
    assert int(state.count) == STEPS and state.count.dtype == torch.int32
    assert [t.data_ptr() for _, t in flatten_with_paths((params, state))] == ptrs
    assert isinstance(state, AdamWState) and state.m["a"].dtype == moment_dtype


def test_update_in_place_tracks_jax():
    """5 clipped steps of ``warmup_cosine`` against the reference's AdamW."""
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 3, 10), weight_decay=1e-4)
    jopt = JaxAdamW(learning_rate=jax_warmup_cosine(3e-3, 3, 10), weight_decay=1e-4)
    jparams = random_tree(0)
    jstate = jopt.init(jparams)
    params = from_jax_params(jparams)
    state = opt.init(params)
    for step in range(STEPS):
        grads = random_tree(10 + step, 3.0)
        jparams, jstate, jnorm = jopt.update(grads, jstate, jparams)
        norm = opt.update_(from_jax_params(grads), state, params)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for name, got, want in (("params", params, jparams), ("m", state.m, jstate.m),
                            ("v", state.v, jstate.v)):
        for path, w in from_jax_params(jax.tree.map(np.asarray, want)).items():
            np.testing.assert_allclose(got[path].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6 * w.abs().max().item(),
                                       err_msg=f"{name}/{path}")
    assert int(state.count) == int(jstate.count) == STEPS


# -- the donating train step ------------------------------------------------------

BATCH, SEQ = 4, 16


def smoke_lm(remat=True):
    cfg = dataclasses.replace(get_smoke("stablelm_3b"), init_scale=1.0)
    return LM(cfg, "cpu", seed=0, remat=remat)


def batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32))} for _ in range(n)]


def optimizer():
    return AdamW(learning_rate=warmup_cosine(3e-3, 2, 20), weight_decay=1e-4, clip_norm=0.5)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_donating_step_is_the_functional_step_bit_for_bit(microbatches):
    model = smoke_lm()
    opt = optimizer()
    cfg = TrainStepConfig(microbatches)
    functional = make_train_step(functional_loss(model), opt, cfg)
    donating = make_train_step(functional_loss(model), opt, cfg, donate=True)
    params = clone(params_of(model))
    state = opt.init(params)
    fparams, fstate = clone(params), clone(state)
    for batch in batches(model.cfg, 4):
        fparams, fstate, fmetrics = functional(fparams, fstate, batch)
        new_params, new_state, metrics = donating(params, state, batch)
        assert new_params is params and new_state is state
        for key in ("loss", "grad_norm"):
            assert torch.equal(metrics[key], fmetrics[key]), key
        assert_bit_equal((params, state), (fparams, fstate))
    assert int(state.count) == 4


def test_functional_step_stays_the_default():
    model = smoke_lm()
    opt = optimizer()
    params = clone(params_of(model))
    state = opt.init(params)
    keep = clone((params, state))
    new_params, new_state, _ = make_train_step(functional_loss(model), opt)(
        params, state, batches(model.cfg, 1)[0])
    assert new_params is not params
    assert_bit_equal((params, state), keep)


def controller(ckpt, step_fn, model, opt, **kw):
    return TrainController(ckpt, step_fn, lambda: (clone(params_of(model)),
                                                   opt.init(params_of(model))), **kw)


def test_controller_resumes_under_the_donating_step(tmp_path):
    """To step 10, then a new controller resumes to 20 from the state saved
    at 10 (bit for bit) and ends where one run to 20 ends."""
    model = smoke_lm()
    opt = optimizer()
    step = make_train_step(functional_loss(model), opt, donate=True)
    data = batches(model.cfg, 20, seed=1)
    first = controller(tmp_path / "a", step, model, opt, save_every=5)
    first.run(iter(data[:10]), n_steps=10)
    saved = clone((first.params, first.opt_state))
    second = controller(tmp_path / "a", step, model, opt, save_every=5)
    assert second.resumed and second.step == 10
    assert_bit_equal((second.params, second.opt_state), saved)
    resumed = second.run(iter(data[10:]), n_steps=20)
    whole = controller(tmp_path / "b", step, model, opt, save_every=5)
    history = whole.run(iter(data), n_steps=20)
    assert [h["loss"] for h in history[10:]] == [h["loss"] for h in resumed]
    assert_bit_equal((second.params, second.opt_state), (whole.params, whole.opt_state))
    assert int(second.opt_state.count) == 20


@pytest.mark.parametrize("mode", ["save", "save_async"])
def test_a_save_sees_no_later_step(tmp_path, mode):
    """The donating step writes params and state in place; a checkpoint
    taken at step 3 holds step 3's values after 3 more steps have run
    (``save`` copies to the host before it returns, ``save_async``
    snapshots before its thread starts)."""
    model = smoke_lm()
    opt = optimizer()
    step = make_train_step(functional_loss(model), opt, donate=True)
    params = clone(params_of(model))
    state = opt.init(params)
    data = batches(model.cfg, 6, seed=2)
    for batch in data[:3]:
        step(params, state, batch)
    at_3 = clone((params, state))
    ckpt = Checkpointer(tmp_path)
    getattr(ckpt, mode)(3, (params, state))
    for batch in data[3:]:
        step(params, state, batch)
    ckpt.wait()
    assert not torch.equal(params["embed/embedding"], at_3[0]["embed/embedding"])
    restored, _ = ckpt.restore((params, state), 3, device="cpu")
    assert_bit_equal(restored, at_3)
