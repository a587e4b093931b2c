"""Griffin/RecurrentGemma recurrent block: causal conv + RG-LRU.

Counterpart of ``repro/models/rglru.py``. The gates are PyTorch operators,
as the reference computes them outside its Pallas kernel; the recurrence
h_t = a_t·h_{t−1} + b_t is ``rg_lru_op`` in every use of the block (a full
sequence, a block prefill from a state, a one-token decode step): the
hand-written CUDA kernel on the card, its plain version on the CPU. The
reference runs ``jax.lax.associative_scan`` there and one elementwise step
at decode. Under grad the recurrence is differentiable through its
backward kernel (``rg_lru_bwd.cu``), with or without a state.

On a mesh the channels (``rnn``) lie over the model axis: the causal conv
and the recurrence run on each rank's own channels
(``launch.mesh.kernel_call``), the gates' products as DTensor operators.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.rg_lru.ops import rg_lru_op
from ..launch.mesh import is_dtensor, kernel_call
from .blocks import truncated_normal

_C = 8.0
_CONV_WIDTH = 4


class RGLRUState(NamedTuple):
    """Counterpart of ``repro/models/rglru.py:29 RGLRUState``."""

    h: torch.Tensor  # (b, d_rnn) fp32 recurrent state
    conv: torch.Tensor  # (b, CONV_WIDTH-1, d_rnn) trailing conv inputs


def init_rglru(cfg, generator: torch.Generator, dtype=torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/rglru.py:34 init_rglru``. ``lam`` is
    the reference's own, from ``np.random.RandomState(0)``, and stays fp32
    whatever ``dtype``."""
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    s = cfg.init_scale / math.sqrt(d)
    sr = cfg.init_scale / math.sqrt(dr)
    # Lambda so that a spans ~[0.9, 0.999] (Griffin appendix)
    lam = np.log(np.expm1(-np.log(np.random.RandomState(0).uniform(0.9, 0.999, dr)) / _C))

    def w(shape, scale):
        return truncated_normal(shape, scale, generator, dtype, device)

    return {
        "w_in": w((d, dr), s),
        "w_gate": w((d, dr), s),
        "w_out": w((dr, d), sr),
        "conv_w": w((_CONV_WIDTH, dr), 0.5),
        "w_r": w((dr, dr), sr),
        "w_i": w((dr, dr), sr),
        "b_r": torch.zeros(dr, dtype=dtype, device=device),
        "b_i": torch.zeros(dr, dtype=dtype, device=device),
        "lam": torch.tensor(lam, dtype=torch.float32, device=device),
    }


def rglru_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/rglru.py:57 rglru_axes``."""
    return {
        "w_in": ("embed", "rnn"),
        "w_gate": ("embed", "rnn"),
        "w_out": ("rnn", "embed"),
        "conv_w": (None, "rnn"),
        "w_r": ("rnn", "rnn_in"),
        "w_i": ("rnn", "rnn_in"),
        "b_r": ("rnn",),
        "b_i": ("rnn",),
        "lam": ("rnn",),
    }


def channel_placements(x, channels: int, channel_dim: int) -> list:
    """Placements of a DTensor whose dimension ``channel_dim`` holds
    ``channels`` recurrent channels: rows as ``x`` has them over the data
    axes, the channels over a model axis of several ranks where they
    divide it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    out = []
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if name == "model":
            n = mesh.size(i)
            out.append(Shard(channel_dim) if n > 1 and channels % n == 0 else Replicate())
        else:
            out.append(Shard(0) if pl.is_shard(0) else Replicate())
    return out


def weight_placements(acts: list, dim: int, grad: bool = False) -> list:
    """A weight's placements beside activations placed ``acts``: its
    dimension ``dim`` over the model axis where the activations' channels
    are, replicated over the data axes; ``grad`` gives its gradient's,
    a partial sum over the data axes where the rows are sharded."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for pl in acts:
        if pl.is_shard(0):
            out.append(Partial() if grad else Replicate())
        else:
            out.append(Shard(dim) if pl.is_shard() else Replicate())
    return out


def _gates(p, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The decay a and the gated input b of the recurrence, fp32.
    Counterpart of ``repro/models/rglru.py:71 _gates``."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_r"].float() + p["b_r"].float())
    i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"].float())
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def rglru_scan(p, u: torch.Tensor, h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over ``u`` ``(b, s, dr)`` from ``h0`` (zero when None) ->
    (outputs in u's dtype, the last h in fp32). Counterpart of
    ``repro/models/rglru.py:82 rglru_scan`` and, at s = 1, of
    ``rglru_step`` (:98)."""
    a, b = _gates(p, u)
    if is_dtensor(a):
        if h0 is not None:
            raise NotImplementedError("rglru_scan: a recurrent state on a mesh; decode on one "
                                      "device (ROADMAP.md Queue 1 item 6.4)")
        pl = channel_placements(a, a.shape[-1], 2)
        last_pl = channel_placements(a, a.shape[-1], 1)
        h, last = kernel_call(rg_lru_op, (a, b, None), (pl, pl, None), (pl, last_pl))
    else:
        h, last = rg_lru_op(a, b, h0)
    return h.to(u.dtype), last


def _causal_conv(p, u: torch.Tensor, tail: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4 over ``u`` ``(b, s, dr)``, after
    ``tail`` (zeros when None) -> (out, the new tail). Counterpart of
    ``repro/models/rglru.py:105 _causal_conv``."""
    w = p["conv_w"]
    if tail is None:
        pad = torch.zeros((u.shape[0], _CONV_WIDTH - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = tail.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)  # (b, s+3, dr)
    s = u.shape[1]
    out = sum(ext[:, i : i + s] * w[_CONV_WIDTH - 1 - i] for i in range(_CONV_WIDTH))
    return out, ext[:, -(_CONV_WIDTH - 1):]


def apply_rglru_mix(p, x: torch.Tensor, cfg, state: RGLRUState | None = None
                    ) -> tuple[torch.Tensor, RGLRUState | None]:
    """The temporal-mixing sub-layer, in place of attention: ``x``
    ``(b, s, d)`` -> (y, the new state, or None without one). Counterpart
    of ``repro/models/rglru.py:119 apply_rglru_mix``."""
    u = x @ p["w_in"]
    g = x @ p["w_gate"]
    if is_dtensor(u):
        if state is not None:
            raise NotImplementedError("apply_rglru_mix: a recurrent state on a mesh; decode "
                                      "on one device (ROADMAP.md Queue 1 item 6.4)")
        pl = channel_placements(u, u.shape[-1], 2)
        w_pl = weight_placements(pl, 1)
        conv = kernel_call(lambda uu, w: _causal_conv({"conv_w": w}, uu)[0],
                           (u, p["conv_w"]), (pl, w_pl), pl,
                           in_grad=(pl, weight_placements(pl, 1, grad=True)))
        h, _ = rglru_scan(p, conv)
        new_state = None
    elif state is None:
        u, _ = _causal_conv(p, u)
        h, _ = rglru_scan(p, u)
        new_state = None
    else:
        u, new_tail = _causal_conv(p, u, tail=state.conv)
        h, h_state = rglru_scan(p, u, h0=state.h)
        new_state = RGLRUState(h_state, new_tail)
    y = (h * F.gelu(g.float(), approximate="tanh").to(h.dtype)) @ p["w_out"]
    return y, new_state


def init_rglru_state(batch: int, cfg, dtype=torch.float32, device=None) -> RGLRUState:
    """Counterpart of ``repro/models/rglru.py:144 init_rglru_state``."""
    dr = cfg.resolved_d_rnn
    return RGLRUState(
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, _CONV_WIDTH - 1, dr), dtype=dtype, device=device),
    )
