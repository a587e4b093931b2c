"""The gradient of the port's RG-LRU recurrence (``RGLRUFunction``: the
forward and the reverse scan ``rg_lru_bwd_ref``, the plain versions of
``csrc/rg_lru.cu`` and ``csrc/rg_lru_bwd.cu``) against ``jax.vjp`` of
the JAX package's oracle (``repro/kernels/rg_lru/ref.py:8 rg_lru_ref``,
an associative scan), on inputs made with numpy from a seed: with and
without h0, with a gradient on every h_t, on the last h only (d(last)),
or both.

Tolerances: fp32 at rtol = atol = 1e-5 (the reference's kernel tests use
1e-5; the scan sums in another order); the explicit reverse scan against
torch autograd through the plain forward at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rg_lru.ref import rg_lru_ref as jax_rg_lru_ref
from repro_torch.kernels.rg_lru import ops
from repro_torch.kernels.rg_lru.ref import rg_lru_bwd_ref, rg_lru_ref

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(1, 1, 4), (2, 7, 33), (3, 16, 64), (2, 65, 8)]
COTANGENTS = ("h", "last", "both")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(b, s, d, seed):
    """Decays in (0, 0.98) as the model's gates give them, inputs, a state
    and the incoming gradients of every h and of the last h."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    a = (0.98 / (1 + np.exp(-rnd(b, s, d)))).astype(np.float32)
    return a, 0.5 * rnd(b, s, d), rnd(b, d), rnd(b, s, d), rnd(b, d)


def jax_grads(a, b, h0, dh, dlast):
    """(da, db, dh0) of <dh, h> + <dlast, h_T> through the JAX oracle."""
    def f(a, b, h0):
        h = jax_rg_lru_ref(a, b, h0)
        return h, h[:, -1]

    args = (jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    if h0 is None:
        (h, last), vjp = jax.vjp(lambda a, b: f(a, b, None), *args[:2])
    else:
        (h, last), vjp = jax.vjp(f, *args)
    ct = (jnp.zeros_like(h) if dh is None else jnp.asarray(dh),
          jnp.zeros_like(last) if dlast is None else jnp.asarray(dlast))
    grads = [np.asarray(g) for g in vjp(ct)]
    return grads + [None] * (3 - len(grads)), np.asarray(h)


def port_grads(a, b, h0, dh, dlast):
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(True)
    h, last = ops.rg_lru_op(ta, tb, th0)
    assert h.grad_fn is not None and "RGLRUFunction" in type(h.grad_fn).__name__
    outs = [(h, dh), (last, dlast)]
    torch.autograd.backward([o for o, d in outs if d is not None],
                            [torch.from_numpy(d) for _, d in outs if d is not None])
    return [ta.grad, tb.grad, None if th0 is None else th0.grad], h.detach()


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_function_matches_jax_vjp(shape, cotangent, with_h0):
    a, b, h0, dh, dlast = draw(*shape, seed=sum(shape))
    h0 = h0 if with_h0 else None
    dh = None if cotangent == "last" else dh
    dlast = None if cotangent == "h" else dlast
    got, h = port_grads(a, b, h0, dh, dlast)
    want, want_h = jax_grads(a, b, h0, dh, dlast)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    for name, g, w in zip(("a", "b", "h0"), got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("with_h0", [False, True])
def test_bwd_ref_is_autograd_of_the_forward(with_h0):
    a, b, h0, dh, dlast = (torch.from_numpy(x) for x in draw(2, 19, 12, seed=11))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    init = leaves[2] if with_h0 else None
    h, last = rg_lru_ref(leaves[0], leaves[1], init)
    torch.autograd.backward([h, last], [dh, dlast])
    da, db, dh0 = rg_lru_bwd_ref(a, h.detach(), h0 if with_h0 else None, dh, dlast)
    torch.testing.assert_close(da, leaves[0].grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(db, leaves[1].grad, rtol=1e-6, atol=1e-6)
    if with_h0:
        torch.testing.assert_close(dh0, leaves[2].grad, rtol=1e-6, atol=1e-6)
    else:
        assert dh0 is None


def test_no_grad_stays_the_plain_forward_and_bf16_grad_raises():
    a, b, h0, _, _ = (torch.from_numpy(x) for x in draw(2, 5, 8, seed=2))
    with torch.no_grad():
        h, last = ops.rg_lru_op(a.requires_grad_(True), b, h0)
    assert h.grad_fn is None
    want = rg_lru_ref(a, b, h0)
    torch.testing.assert_close(h, want[0], rtol=0, atol=0)
    torch.testing.assert_close(last, want[1], rtol=0, atol=0)
    with pytest.raises(TypeError, match="fp32 only.*ROADMAP"):
        ops.rg_lru_op(a.detach().bfloat16().requires_grad_(True), b.bfloat16())
    assert set(ops.LAUNCHES) == {"rg_lru", "rg_lru_bwd"}
