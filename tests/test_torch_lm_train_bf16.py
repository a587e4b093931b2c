"""The port's bf16 train step against the JAX package's, as the dry run
builds its train cells (``repro/launch/dryrun.py:189 build_cell``:
``LM(cfg, remat=True, dtype=bf16)`` through ``make_train_step``): the
loss and the gradients of one step of 1 or 2 microbatches, with the port's
``remat`` on and off, for StableLM-3B, RecurrentGemma-9B, xLSTM-1.3B,
DeepSeek-MoE-16B, HuBERT X-Large (bf16 frames and labels) and Qwen2-VL-72B
(tokens and bf16 patches), at SMOKE.

Parameters: the JAX ``init``'s tree in bf16 at ``init_scale=1``, each leaf
in the dtype ``LM(dtype=bf16).init`` gives it (the MoE router and the
RG-LRU's recurrent leaves stay fp32), the constant leaves drawn at random
(``test_torch_lm.py``), carried across by ``lm_params_from_jax``; inputs
are numpy draws from a seed. On the CPU the attention Function runs its
bf16 plain versions, the algebra of the bf16 kernels; the RG-LRU and mLSTM
recurrences run in fp32, as in the reference.

fp64 does not decide here; the reference's fp32 step on the same rounded
parameters stands in for the truth. The loss within 2e-3 relative (measured
worst 5.7e-4, HuBERT X-Large). Each gradient, as a fraction of the largest
element of the reference's bf16 gradient: within 2e-2 of that gradient, or
no further from the reference's fp32 gradient than the reference's bf16
gradient is, plus 5e-3. Measured worst distance from the reference's bf16
gradient per architecture, at 1 microbatch: StableLM-3B 1.4e-2, RecurrentGemma-9B
3.6e-2 (its conv_w, whose own bf16 noise against fp32 is 3.2e-2),
xLSTM-1.3B 3.2e-2 (b_if, 4.1e-2), DeepSeek-MoE-16B 1.2e-2, HuBERT X-Large
1.4e-2, Qwen2-VL-72B 11.3e-2 (a k bias, whose true gradient is 0 by the
softmax's shift invariance, so both are noise: 10.0e-2 the reference's).
Each gradient comes out in the dtype of the reference's (the parameter's
at 1 microbatch, fp32 summed over 2).

Routing: DeepSeek-MoE-16B's two MoE layers send every token to the
reference's experts. Before the port rounded the attention scores to bf16
(the reference's einsum returns them so) and wrote silu out op by op in
bf16 (as XLA runs ``jax.nn.silu``), 2 of the 96 tokens of the second MoE
layer took other experts, and the router's gradient stood 17% off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
from repro.configs import get_smoke as jax_get_smoke
from repro.models.lm import LM as JaxLM
from repro.runtime.train_loop import TrainStepConfig as JaxTrainStepConfig
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.models import moe as MOE
from repro_torch.models.lm import LM
from repro_torch.runtime.train_loop import TrainStepConfig, functional_loss, make_train_step
from test_torch_lm import batch_of, randomize_constants

TRAINED = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b",
           "hubert_xlarge", "qwen2_vl_72b")
BATCH, SEQ = 4, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE widths gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class GradsAsParams:
    """An optimizer whose update returns the gradients it was given as the
    new parameters, so a train step hands its accumulated gradients out."""

    def __init__(self, zero):
        self.zero = zero

    def update(self, grads, state, params):
        return grads, state, self.zero


def as_bf16(batch: dict) -> dict:
    """Float leaves (frames, patches) in bf16, as the dry run feeds them."""
    return {k: v.astype(ml_dtypes.bfloat16) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def jax_step_grads(jmodel, tree, batch, n):
    step = jax.jit(jax_make_train_step(jmodel.loss, GradsAsParams(jnp.zeros(())),
                                       JaxTrainStepConfig(n_microbatches=n)))
    grads, _, metrics = step(tree, None, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def reference():
    """``reference(name, n)`` -> (cfg, the bf16 tree, the batch, the bf16
    step's loss and gradients, the fp32 step's gradients on the same rounded
    parameters), each made once."""
    made: dict = {}

    def get(name, n):
        if name not in made:
            jcfg = dataclasses.replace(jax_get_smoke(name), init_scale=1.0)
            cfg = dataclasses.replace(get_smoke(name), init_scale=1.0)
            jmodel = JaxLM(jcfg, remat=True, dtype=jnp.bfloat16)
            tree = randomize_constants(
                jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0))))
            made[name] = (jcfg, cfg, tree, as_bf16(batch_of(cfg, BATCH, SEQ)))
        jcfg, cfg, tree, batch = made[name]
        if (name, n) not in made:
            loss, grads = jax_step_grads(JaxLM(jcfg, remat=True, dtype=jnp.bfloat16), tree,
                                         batch, n)
            tree32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
            _, grads32 = jax_step_grads(JaxLM(jcfg, remat=True, dtype=jnp.float32), tree32,
                                        batch, n)
            made[name, n] = (loss, grads, grads32)
        return (cfg, tree, batch, *made[name, n])

    return get


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype (bf16 through fp32, exact)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def port_step_grads(cfg, tree, batch, n, remat):
    model = LM(cfg, "cpu", dtype=torch.bfloat16, seed=1, remat=remat)
    params = lm_params_from_jax(tree, cfg)
    step = make_train_step(functional_loss(model), GradsAsParams(torch.zeros(())),
                           TrainStepConfig(n))
    grads, _, metrics = step(params, None, {k: to_torch(v) for k, v in batch.items()})
    return metrics["loss"], grads, params


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", TRAINED)
def test_bf16_train_step_matches_jax(reference, name, remat, n):
    cfg, tree, batch, want_loss, want, want32 = reference(name, n)
    loss, grads, params = port_step_grads(cfg, tree, batch, n, remat)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-3)
    assert torch.bfloat16 in {p.dtype for p in params.values()}
    want, want32 = lm_params_from_jax(want, cfg), lm_params_from_jax(want32, cfg)
    assert set(grads) == set(want)
    for path, w in want.items():
        g = grads[path]
        assert g.dtype == w.dtype, f"{path}: {g.dtype}, the reference's {w.dtype}"
        g, w, f = g.float(), w.float(), want32[path].float()
        scale = w.abs().max().item()
        if scale == 0:  # HuBERT's token embedding, which frames bypass
            assert g.abs().max().item() == 0, path
            continue
        err = (g - w).abs().max().item() / scale
        err32 = (g - f).abs().max().item() / scale
        ref32 = (w - f).abs().max().item() / scale
        assert err <= 2e-2 or err32 <= ref32 + 5e-3, \
            f"{path}: {err:.3e} from the reference's bf16 gradient; {err32:.3e} from its fp32 " \
            f"one, where the bf16 one stands {ref32:.3e}"


def test_deepseek_routes_every_token_as_the_reference_in_bf16(reference):
    """The expert ids of both MoE layers in the port's bf16 training forward
    equal the reference's in its jitted bf16 loss."""
    cfg, tree, batch, *_ = reference("deepseek_moe_16b", 1)
    jcfg = dataclasses.replace(jax_get_smoke("deepseek_moe_16b"), init_scale=1.0)
    jids, ids = [], []
    jroute, route = JMOE._route, MOE._route

    def jspy(xf, router, m):
        out = jroute(xf, router, m)
        jax.debug.callback(lambda a: jids.append(np.asarray(a)), out[0])
        return out

    def spy(xf, router, m):
        out = route(xf, router, m)
        ids.append(out[0].numpy())
        return out

    JMOE._route, MOE._route = jspy, spy
    try:
        jmodel = JaxLM(jcfg, remat=True, dtype=jnp.bfloat16)
        jax.jit(jmodel.loss)(tree, {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
        port_step_grads(cfg, tree, batch, 1, remat=False)
    finally:
        JMOE._route, MOE._route = jroute, route
    assert len(jids) == len(ids) == cfg.n_layers - cfg.moe.first_k_dense
    for i, (a, b) in enumerate(zip(jids, ids)):
        np.testing.assert_array_equal(np.sort(b, -1), np.sort(a, -1), err_msg=f"MoE layer {i}")
