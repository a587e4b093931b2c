"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

Counterpart of ``repro/models/xlstm.py``. The mLSTM recurrence is
``mlstm_chunk_op`` in every use of the block (a full sequence, a block
prefill from a state, a one-token decode step, a training step): the
hand-written CUDA kernels on the card (under grad the training entry and
the backward kernel), their plain versions on the CPU, all computing the
chunkwise form that the reference takes from 128 tokens on (its per-step
``lax.scan`` below that computes the same function, and XLA differentiates
either). The sLSTM has no
kernel in the reference either: its step is PyTorch operators in a Python
loop over time.

On a mesh the mLSTM's heads lie over the model axis and its recurrence
runs on each rank's own heads (``launch.mesh.kernel_call``); the sLSTM's
gate split and step are DTensor operators.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.mlstm_chunk.ops import mlstm_chunk_op
from ..launch.mesh import is_dtensor, kernel_call
from .blocks import truncated_normal

NEG_INF = -1e30


class MLSTMState(NamedTuple):
    """Counterpart of ``repro/models/xlstm.py:31 MLSTMState``."""

    c: torch.Tensor  # (b, H, dh, dh), C[v][k]; mlstm_scan writes it in place without grad
    n: torch.Tensor  # (b, H, dh)
    m: torch.Tensor  # (b, H)


class SLSTMState(NamedTuple):
    """Counterpart of ``repro/models/xlstm.py:37 SLSTMState``."""

    c: torch.Tensor  # (b, dr)
    n: torch.Tensor  # (b, dr)
    m: torch.Tensor  # (b, dr)
    h: torch.Tensor  # (b, dr) previous output (recurrent gates)


# -- mLSTM --------------------------------------------------------------------


def init_mlstm(cfg, generator: torch.Generator, dtype=torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/xlstm.py:49 init_mlstm``: ``b_if`` is
    zeros for the input gates, then 3.0 for the forget gates."""
    d, dr, h = cfg.d_model, cfg.resolved_d_rnn, cfg.n_heads
    s = cfg.init_scale / math.sqrt(d)
    sr = cfg.init_scale / math.sqrt(dr)

    def w(shape, scale):
        return truncated_normal(shape, scale, generator, dtype, device)

    return {
        "w_up": w((d, 2 * dr), s),
        "w_q": w((dr, dr), sr),
        "w_k": w((dr, dr), sr),
        "w_v": w((dr, dr), sr),
        "w_if": w((dr, 2 * h), sr),
        "b_if": torch.cat([torch.zeros(h, device=device),
                           torch.full((h,), 3.0, device=device)]).to(dtype),
        "w_down": w((dr, d), sr),
    }


def mlstm_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/xlstm.py:65 mlstm_axes``."""
    return {
        "w_up": ("embed", "rnn"),
        "w_q": ("rnn_in", "rnn"),
        "w_k": ("rnn_in", "rnn"),
        "w_v": ("rnn_in", "rnn"),
        "w_if": ("rnn_in", None),
        "b_if": (None,),
        "w_down": ("rnn", "embed"),
    }


def _mlstm_inputs(p, x: torch.Tensor, cfg):
    """q, k (divided by √dh), v ``(b, s, H, dh)``, the gate pre-activations
    i and f ``(b, s, H)`` in fp32, and the output gate's input z.
    Counterpart of ``repro/models/xlstm.py:77 _mlstm_inputs``."""
    dr, H = cfg.resolved_d_rnn, cfg.n_heads
    dh = dr // H
    u, z = torch.chunk(x @ p["w_up"], 2, dim=-1)  # (b, s, dr) each
    lead = u.shape[:-1]
    q = (u @ p["w_q"]).reshape(*lead, H, dh)
    k = (u @ p["w_k"]).reshape(*lead, H, dh) / math.sqrt(dh)
    v = (u @ p["w_v"]).reshape(*lead, H, dh)
    gates = (u @ p["w_if"] + p["b_if"]).float()  # (b, s, 2H)
    i_t, f_t = torch.chunk(gates, 2, dim=-1)
    return q, k, v, i_t, f_t, z


def mlstm_scan(p, x: torch.Tensor, cfg, state: MLSTMState | None = None
               ) -> tuple[torch.Tensor, MLSTMState]:
    """The mLSTM sub-layer over ``x`` ``(b, s, d)`` from ``state`` (a fresh
    one when None) -> (y, the new state). Without a gradient the state's C
    is updated IN PLACE, as the KV cache is; when one is taken (a training
    step) the new C is a fresh tensor and nothing is written, so autograd
    keeps the C it saved. Counterpart of
    ``repro/models/xlstm.py:115 mlstm_scan``."""
    b, s = x.shape[0], x.shape[1]
    if state is None:
        state = init_mlstm_state(b, cfg, x.device)
    q, k, v, i_t, f_t, z = _mlstm_inputs(p, x, cfg)
    # the recurrence in fp32, as the reference casts q, k and v
    # (repro/models/xlstm.py:92, :154)
    q, k, v = q.float(), k.float(), v.float()
    if is_dtensor(q):
        from .attention import head_placements

        qp = head_placements(q, cfg.n_heads, cfg.n_heads)  # (b, s, H, dh): heads dim 2
        gp = qp  # (b, s, H)
        sp = head_placements(q, cfg.n_heads, cfg.n_heads, head_dim=1)  # (b, H, ...)
        hs, c, n, m = kernel_call(mlstm_chunk_op, (q, k, v, i_t, f_t, *state),
                                  (qp, qp, qp, gp, gp, sp, sp, sp), (qp, sp, sp, sp))
    else:
        hs, c, n, m = mlstm_chunk_op(q, k, v, i_t, f_t, state.c, state.n, state.m)
    hs = hs.reshape(b, s, -1).to(x.dtype)
    y = (hs * F.silu(z.float()).to(x.dtype)) @ p["w_down"]
    return y, MLSTMState(c, n, m)


def init_mlstm_state(batch: int, cfg, device=None) -> MLSTMState:
    """Counterpart of ``repro/models/xlstm.py:196 init_mlstm_state``."""
    dr, H = cfg.resolved_d_rnn, cfg.n_heads
    dh = dr // H
    return MLSTMState(
        c=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, H), NEG_INF, dtype=torch.float32, device=device),
    )


# -- sLSTM --------------------------------------------------------------------


def init_slstm(cfg, generator: torch.Generator, dtype=torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/xlstm.py:211 init_slstm``."""
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    s = cfg.init_scale / math.sqrt(d)
    sr = cfg.init_scale / math.sqrt(dr)

    def w(shape, scale):
        return truncated_normal(shape, scale, generator, dtype, device)

    return {
        "w": w((d, 4 * dr), s),  # i, f, z, o from the input
        "r": w((dr, 4 * dr), sr),  # recurrent
        "b": torch.zeros(4 * dr, dtype=dtype, device=device),
        "w_down": w((dr, d), sr),
    }


def slstm_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/xlstm.py:224 slstm_axes``."""
    return {
        "w": ("embed", "rnn"),
        "r": ("rnn_in", "rnn"),
        "b": ("rnn",),
        "w_down": ("rnn", "embed"),
    }


def _slstm_step(r: torch.Tensor, state: SLSTMState, wx_t: torch.Tensor) -> SLSTMState:
    """Counterpart of the step of ``repro/models/xlstm.py:236
    _slstm_step_factory``."""
    pre = wx_t.float() + state.h @ r
    i_t, f_t, z_t, o_t = torch.chunk(pre, 4, dim=-1)
    # log σ(f) = −softplus(−f): DTensor has no rule for logsigmoid's
    # backward, softplus's it has
    f_log = -F.softplus(-f_t) if is_dtensor(f_t) else F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + state.m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + state.m - m_new)
    c = f_p * state.c + i_p * torch.tanh(z_t)
    n = f_p * state.n + i_p
    h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, m_new, h)


def slstm_scan(p, x: torch.Tensor, cfg, state: SLSTMState | None = None
               ) -> tuple[torch.Tensor, SLSTMState]:
    """The sLSTM sub-layer over ``x`` ``(b, s, d)`` -> (y, the new state).
    Counterpart of ``repro/models/xlstm.py:254 slstm_scan``."""
    if state is None:
        state = init_slstm_state(x.shape[0], cfg, x.device)
    wx = x @ p["w"] + p["b"]  # (b, s, 4dr)
    r = p["r"].float()
    hs = []
    # unbind, not wx[:, t]: the backward of s selections would build s
    # full-size zero gradients and add them (O(s²) bytes); unbind's stacks once
    for wx_t in wx.unbind(1):
        state = _slstm_step(r, state, wx_t)
        hs.append(state.h)
    return torch.stack(hs, dim=1).to(x.dtype) @ p["w_down"], state


def init_slstm_state(batch: int, cfg, device=None) -> SLSTMState:
    """Counterpart of ``repro/models/xlstm.py:262 init_slstm_state``."""
    dr = cfg.resolved_d_rnn
    z = torch.zeros((batch, dr), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, m=torch.full((batch, dr), NEG_INF, dtype=torch.float32,
                                             device=device), h=z)
