"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro/models/moe.py``), at the SMOKE DeepSeek-MoE-16B (8
routed experts top-2, 1 shared) and Kimi-K2 (16 routed top-4, 1 shared),
with parameters from the JAX ``init_moe`` at ``init_scale=1`` carried
across by the bridge and inputs drawn by numpy from a seed: ``_route``
(expert ids exactly, probabilities and the load-balance term in fp32),
``_expert_ffn`` under both ``impl``s, including a capacity that drops
token copies and padding rows, ``moe_local`` and ``apply_moe``, and their
gradients against ``jax.vjp``. The batched form's drops depend on the
stable sort the reference's ``jnp.argsort`` does.

Tolerances: values at rtol=atol=2e-5 (fp32, sums in another order); each
gradient tensor within 5e-5 of its own largest element (the LM tests'
``assert_grads_close``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import moe as JM
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_smoke
from repro_torch.models import moe as M

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("deepseek_moe_16b", "kimi_k2_1t_a32b")
IMPLS = ("ragged", "batched")


def configs(name, impl="ragged"):
    jcfg, cfg = (dataclasses.replace(c, init_scale=1.0) for c in (jax_get_smoke(name),
                                                                   get_smoke(name)))
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe, expert_impl=impl))
                 for c in (jcfg, cfg))


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    jcfg, cfg = configs(request.param)
    jp = jax.tree_util.tree_map(np.asarray, JM.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    flat = from_jax_params(jp)
    tp = {k: v for k, v in flat.items() if "/" not in k}
    if cfg.moe.n_shared:
        tp["shared"] = {k.split("/")[1]: v for k, v in flat.items() if k.startswith("shared/")}
    x = np.random.default_rng(1).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    return {"name": request.param, "jcfg": jcfg, "cfg": cfg, "jp": jp, "tp": tp, "x": x}


def flat_tree(tp):
    out = {}
    for k, v in tp.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def nest(flat):
    out = {}
    for k, v in flat.items():
        if "/" in k:
            a, b = k.split("/")
            out.setdefault(a, {})[b] = v
        else:
            out[k] = v
    return out


def close_grads(got, want, limit=5e-5):
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].detach().numpy()
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g).max() > 0, f"{path} has no gradient"
        err = np.abs(g - w).max()
        assert err <= limit * scale, f"{path}: max|dg| {err:.3e} > {limit} x {scale:.3e}"


def test_init_has_the_reference_shapes_and_scales(layer):
    cfg = layer["cfg"]
    p = M.init_moe(cfg, torch.Generator().manual_seed(0))
    assert set(flat_tree(p)) == set(flat_tree(layer["tp"]))
    for path, t in flat_tree(p).items():
        want = flat_tree(layer["tp"])[path]
        assert t.shape == want.shape and t.dtype == want.dtype, path
        assert 0.5 < t.std().item() / want.std().item() < 2.0, path


def test_route_matches(layer):
    cfg, x = layer["cfg"], layer["x"].reshape(-1, layer["cfg"].d_model)
    ids, probs, aux = M._route(torch.from_numpy(x), layer["tp"]["router"], cfg.moe)
    jids, jprobs, jaux = JM._route(jnp.asarray(x), jnp.asarray(layer["jp"]["router"]),
                                   layer["jcfg"].moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert probs.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("factor", (0.5, 1.5))
def test_expert_ffn_matches(layer, impl, factor):
    """Copies routed as ``moe_local`` routes them plus padding rows; at
    factor 0.5 the batched form drops copies past each expert's capacity."""
    cfg, E = layer["cfg"], layer["cfg"].moe.n_experts
    rng = np.random.default_rng(2)
    tokens = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    eids = rng.integers(0, E + 1, size=40).astype(np.int32)
    eids[:6] = 0  # one expert over any capacity here
    got = M._expert_ffn(torch.from_numpy(tokens), torch.from_numpy(eids).long(), layer["tp"], E,
                        impl=impl, capacity_factor=factor)
    want = JM._expert_ffn(jnp.asarray(tokens), jnp.asarray(eids), layer["jp"], E, impl=impl,
                          capacity_factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if impl == "batched" and factor == 0.5:
        dropped = (np.abs(np.asarray(want)).sum(-1) == 0) & (eids < E)
        assert dropped.sum() > 0, "the capacity drops no copy"
        assert (got.numpy()[dropped] == 0).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_local_and_apply_moe_match(layer, impl):
    jcfg, cfg = configs(layer["name"], impl)
    x = layer["x"]
    y, aux = M.moe_local(layer["tp"], torch.from_numpy(x), cfg)
    jy, jaux = JM.moe_local(layer["jp"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    y, aux = M.apply_moe(layer["tp"], torch.from_numpy(x), cfg)
    jy, jaux = JM.apply_moe(layer["jp"], jnp.asarray(x), jcfg)
    assert np.abs(np.asarray(jy)).mean() > 100 * TOL["atol"]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_apply_moe_gradients_match_jax_vjp(layer, impl):
    """d(sum(y · w) + 3 aux) with respect to x and every parameter."""
    jcfg, cfg = configs(layer["name"], impl)
    x = layer["x"]
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jf(p, x_):
        y, aux = JM.apply_moe(p, x_, jcfg)
        return jnp.sum(y * w) + 3.0 * aux

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, layer["jp"]),
                                             jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat_tree(layer["tp"]).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.apply_moe(nest(leaves), tx, cfg)
    (torch.sum(y * torch.from_numpy(w)) + 3.0 * aux).backward()
    close_grads({k: v.grad for k, v in leaves.items()},
                {k: v.numpy() for k, v in from_jax_params(jax.tree_util.tree_map(
                    np.asarray, jgp)).items()})
    close_grads({"x": tx.grad}, {"x": np.asarray(jgx)})


def test_apply_moe_refuses_a_mesh(layer):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        M.apply_moe(layer["tp"], torch.from_numpy(layer["x"]), layer["cfg"], model_axis="model")
