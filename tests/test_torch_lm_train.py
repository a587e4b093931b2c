"""The port's LM training path against the JAX package's: ``LM.loss``
(``repro/models/lm.py:302``) and its gradient through the train step,
at the SMOKE StableLM-3B (attention), RecurrentGemma-9B (RG-LRU and
local attention), xLSTM-1.3B (mLSTM and sLSTM) and DeepSeek-MoE-16B (a
dense head layer, then attention and routed experts, the loss with its
load-balance term), with the port's ``remat`` on and off (against the JAX
model with ``remat``: ``jax.checkpoint`` changes no value) and 1 or 2
microbatches. Parameters are made by the JAX ``init`` at ``init_scale=1``
with the constant leaves drawn at random (``test_torch_lm.py``) and
carried across by ``repro_torch.bridge``; tokens are numpy draws from a
seed. On the CPU the attention, RG-LRU and mLSTM Functions run their plain
versions, the algebra the CUDA kernels implement.

Tolerances: the loss at rtol 1e-5 (fp32, sums in another order); each
gradient tensor within 5e-5 of its own largest element (measured worst
3.4e-6, RecurrentGemma-9B); ``cross_entropy_loss`` at 1e-6; the
gradients with ``remat`` against those without, at parameters that differ
from the module's own, at 1e-6 of the tensor's largest element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.blocks import cross_entropy_loss as jax_cross_entropy_loss
from repro.models.lm import LM as JaxLM
from repro.runtime.train_loop import TrainStepConfig as JaxTrainStepConfig
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.models.blocks import cross_entropy_loss
from repro_torch.models.lm import LM
from repro_torch.runtime.train_loop import (
    TrainStepConfig,
    functional_loss,
    make_train_step,
    params_of,
    value_and_grad,
)
from test_torch_lm import randomize_constants

TRAINED = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b")
BATCH, SEQ = 4, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE widths gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def setup(name: str, remat: bool):
    jcfg = dataclasses.replace(jax_get_smoke(name), init_scale=1.0)
    cfg = dataclasses.replace(get_smoke(name), init_scale=1.0)
    jmodel = JaxLM(jcfg, remat=remat, dtype=jnp.float32)
    tree = randomize_constants(
        jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0))))
    model = LM(cfg, "cpu", seed=1, remat=remat)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jmodel, tree, model, tokens


@pytest.fixture(scope="module")
def reference():
    """The JAX model (with remat, as its launcher builds it), its tree, the
    tokens and its train step's loss and gradients for n microbatches,
    each made once: ``reference(name, n)``."""
    made: dict = {}

    def get(name, n):
        if name not in made:
            made[name] = setup(name, True)
        if (name, n) not in made:
            jmodel, tree, _, tokens = made[name]
            made[name, n] = jax_step_grads(jmodel, tree, tokens, n)
        return made[name], made[name, n]

    return get


class GradsAsParams:
    """An optimizer whose update returns the gradients it was given as the
    new parameters, so a train step hands its accumulated gradients out."""

    def __init__(self, zero):
        self.zero = zero

    def update(self, grads, state, params):
        return grads, state, self.zero


def jax_step_grads(jmodel, tree, tokens, n):
    step = jax.jit(jax_make_train_step(jmodel.loss, GradsAsParams(jnp.zeros(())),
                                       JaxTrainStepConfig(n_microbatches=n)))
    grads, _, metrics = step(tree, None, {"tokens": jnp.asarray(tokens)})
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, grads)


def port_step_grads(model, params, tokens, n):
    step = make_train_step(functional_loss(model), GradsAsParams(torch.zeros(())),
                           TrainStepConfig(n))
    grads, _, metrics = step(params, None, {"tokens": torch.from_numpy(tokens)})
    return metrics["loss"], grads


def assert_grads_close(grads, want, limit=5e-5):
    assert set(grads) == set(want)
    for path, w in want.items():
        g = grads[path]
        scale = w.abs().max().item()
        assert scale > 0 and g.abs().max().item() > 0, f"{path} has no gradient"
        err = (g - w).abs().max().item()
        assert err <= limit * scale, f"{path}: max|dg| {err:.3e} > {limit} x {scale:.3e}"


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", TRAINED)
def test_train_step_gradients_match_jax(reference, name, remat, n):
    (_, tree, model, tokens), (want_loss, want) = reference(name, n)
    model = LM(model.cfg, "cpu", seed=1, remat=remat)
    loss, grads = port_step_grads(model, lm_params_from_jax(tree, model.cfg), tokens, n)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert_grads_close(grads, lm_params_from_jax(want, model.cfg))


def test_xlstm_gradients_match_jax_with_remat():
    jmodel, tree, model, tokens = setup("xlstm_1_3b", True)
    loss, grads = value_and_grad(functional_loss(model))(lm_params_from_jax(tree, model.cfg),
                                                         {"tokens": torch.from_numpy(tokens)})
    want_loss, want = jax.value_and_grad(jmodel.loss)(tree, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_grads_close(grads, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, want),
                                                 model.cfg))


@pytest.mark.parametrize("name", TRAINED)
def test_remat_recomputes_with_the_given_params(name):
    """The recompute in the backward must read the tensors the forward
    was given, not the module's own: at other parameters, the gradients
    with and without ``remat`` agree."""
    cfg = dataclasses.replace(get_smoke(name), init_scale=1.0)
    tokens = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32))}
    out = {}
    for remat in (True, False):
        model = LM(cfg, "cpu", seed=1, remat=remat)
        rng = np.random.default_rng(3)
        params = {k: v + torch.from_numpy(0.3 * rng.standard_normal(v.shape).astype(np.float32))
                  for k, v in params_of(model).items()}
        out[remat] = value_and_grad(functional_loss(model))(params, tokens)
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]), rtol=1e-6)
    assert_grads_close(out[True][1], out[False][1], limit=1e-6)


def test_loss_is_the_next_token_cross_entropy_of_forward(reference):
    (_, tree, model, tokens), _ = reference("stablelm_3b", 1)
    model.load_jax_params(tree)
    t = torch.from_numpy(tokens)
    logits = model({"tokens": t})
    assert logits.grad_fn is None and model.hidden({"tokens": t}).grad_fn is None
    loss = model.loss({"tokens": t})
    want = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                             t[:, 1:].reshape(-1).long())
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    for mask in (rng.integers(0, 2, (3, 7)).astype(np.int32), np.zeros((3, 7), np.int32)):
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                 torch.from_numpy(mask))
        want = jax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                      jnp.asarray(mask))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ("recurrentgemma_9b", "xlstm_1_3b"))
def test_the_cpu_path_counts_no_launch(reference, name):
    before = {**flash_ops.LAUNCHES, **rg_ops.LAUNCHES, **mlstm_ops.LAUNCHES}
    (_, tree, model, tokens), _ = reference(name, 1)
    value_and_grad(functional_loss(model))(lm_params_from_jax(tree, model.cfg),
                                           {"tokens": torch.from_numpy(tokens)})
    assert {**flash_ops.LAUNCHES, **rg_ops.LAUNCHES, **mlstm_ops.LAUNCHES} == before
