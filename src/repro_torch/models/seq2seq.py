"""The paper's case study: LSTM seq2seq title generation with Bahdanau
attention (paper §4.2.3, Figs. 4-6, Algorithm 3), in PyTorch.

Counterpart of ``repro/models/seq2seq.py``, with its parameter names and
layouts: LSTM weights ``(d_in, 4H)`` with columns ``[i|f|g|o]``, token
arrays ``(b, S)`` int. Every LSTM step is the ``lstm_cell`` kernel on the
card and its plain version on the CPU: a whole layer (the encoder's, and
the decoder's under teacher forcing) goes through ``lstm_layer_op``, whose
gradient is one ``lstm_layer_bwd`` launch a layer; a single decoding step
through ``lstm_cell_op``. Conventions kept from the reference:

* the forget gate has a +1 bias inside the sigmoid; gate math is fp32;
* the encoder runs through PAD steps, and the decoder starts from the
  state after the last one; the PAD mask only covers the attention;
* masked scores are ``-1e30``, so an all-PAD row gives a uniform softmax;
* ``generate`` always runs ``max_len`` steps, writes PAD after END, and
  ``done`` is sticky;
* ``loss`` is a masked mean over ``max(mask.sum(), 1)`` tokens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from ..bridge import from_jax_params
from ..data.tokenizer import END, PAD, START
from ..device import resolve
from ..kernels.lstm_cell.ops import lstm_cell_op, lstm_layer_op
from .blocks import truncated_normal


@dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int
    d_embed: int = 128
    d_hidden: int = 256
    n_encoder_layers: int = 3
    max_abstract_len: int = 128
    max_title_len: int = 24
    init_scale: float = 0.08


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


class LSTMLayer(nn.Module):
    """One LSTM layer: ``wx (d_in, 4H)``, ``wh (H, 4H)``, ``b (4H,)``."""

    def __init__(self, d_in: int, d_hidden: int, scale: float,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.wx = nn.Parameter(truncated_normal(
            (d_in, 4 * d_hidden), scale / math.sqrt(d_in), generator, dtype))
        self.wh = nn.Parameter(truncated_normal(
            (d_hidden, 4 * d_hidden), scale / math.sqrt(d_hidden), generator, dtype))
        self.b = nn.Parameter(torch.zeros(4 * d_hidden, dtype=dtype))

    def forward(self, x_t: torch.Tensor, state: LSTMState) -> LSTMState:
        return LSTMState(*lstm_cell_op(x_t, state.h, state.c, self.wx, self.wh, self.b))

    def scan(self, xs: torch.Tensor, state: LSTMState) -> tuple[torch.Tensor, LSTMState]:
        """xs ``(b, s, d)`` -> (hs ``(b, s, H)``, final state)."""
        hs, h, c = lstm_layer_op(xs.transpose(0, 1).contiguous(), state.h, state.c, self.wx,
                                 self.wh, self.b)
        return hs.transpose(0, 1), LSTMState(h, c)


class Seq2Seq(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, device=None, *, dtype=torch.float32,
                 seed: int = 0):
        """Random weights from a CPU ``torch.Generator`` seeded with
        ``seed`` (the same weights on every device), moved to ``device``:
        the card unless the caller names another."""
        super().__init__()
        self.cfg = cfg
        device = resolve(device)
        g = torch.Generator(device="cpu").manual_seed(seed)
        H, E, V, s = cfg.d_hidden, cfg.d_embed, cfg.vocab_size, cfg.init_scale

        def param(shape, scale):
            return nn.Parameter(truncated_normal(shape, scale, g, dtype))

        self.embed_enc = param((V, E), 1.0)
        self.embed_dec = param((V, E), 1.0)
        layers, d_in = [], E
        for _ in range(cfg.n_encoder_layers):
            layers.append(LSTMLayer(d_in, H, s, g, dtype))
            d_in = H
        self.encoder = nn.ModuleList(layers)
        self.decoder = LSTMLayer(E, H, s, g, dtype)
        # Bahdanau attention (paper eqs. 1-2)
        self.attn_ws = param((H, H), s / math.sqrt(H))
        self.attn_wh = param((H, H), s / math.sqrt(H))
        self.attn_v = param((H,), s / math.sqrt(H))
        # output dense over [s_i; C_i] (paper eqs. 4-5)
        self.out_w = param((2 * H, V), s / math.sqrt(2 * H))
        self.out_b = nn.Parameter(torch.zeros(V, dtype=dtype))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.out_b.device

    def load_jax_params(self, tree) -> None:
        """Copy a JAX ``Seq2Seq.init`` parameter tree (numpy leaves) in."""
        self.load_state_dict(
            {path.replace("/", "."): t for path, t in from_jax_params(tree).items()}
        )

    # -- encoder -----------------------------------------------------------
    def encode(self, enc_tokens: torch.Tensor):
        """Returns (enc_hs ``(b, s, H)``, final_state, enc_mask ``(b, s)``)."""
        hs = self.embed_enc[enc_tokens.long()]
        zeros = hs.new_zeros(hs.shape[0], self.cfg.d_hidden)
        state = LSTMState(zeros, zeros)
        for layer in self.encoder:
            hs, state = layer.scan(hs, LSTMState(zeros, zeros))
        return hs, state, enc_tokens != PAD

    # -- Bahdanau attention --------------------------------------------------
    def _attend(self, s_i: torch.Tensor, enc_hs: torch.Tensor, enc_mask: torch.Tensor):
        """s_i ``(b, H)``; enc_hs ``(b, s, H)`` -> context ``(b, H)``."""
        proj = (s_i @ self.attn_ws)[:, None, :] + enc_hs @ self.attn_wh
        e = torch.tanh(proj.float()) @ self.attn_v.float()  # (b, s)
        e = torch.where(enc_mask, e, -1e30)
        a = torch.softmax(e, dim=-1).to(enc_hs.dtype)
        return torch.einsum("bs,bsh->bh", a, enc_hs)

    def _logits(self, h: torch.Tensor, enc_hs, enc_mask) -> torch.Tensor:
        ctx = self._attend(h, enc_hs, enc_mask)
        return torch.cat([h, ctx], dim=-1) @ self.out_w + self.out_b

    # -- training forward (teacher forcing) ----------------------------------
    def forward(self, batch: dict) -> torch.Tensor:
        """batch: encoder_tokens ``(b, S)``, decoder_tokens ``(b, T)``.
        Returns logits ``(b, T-1, V)`` predicting decoder_tokens[:, 1:]."""
        enc_hs, state, enc_mask = self.encode(batch["encoder_tokens"])
        x = self.embed_dec[batch["decoder_tokens"][:, :-1].long()]
        # teacher forcing: the recurrence never reads the logits
        hs, _ = self.decoder.scan(x, state)
        logits = [self._logits(h_t, enc_hs, enc_mask) for h_t in hs.unbind(1)]
        return torch.stack(logits, dim=1)

    def loss(self, batch: dict) -> torch.Tensor:
        logits = self.forward(batch).float()
        targets = batch["decoder_tokens"][:, 1:].long()
        mask = (targets != PAD).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)

    # -- inference (paper Algorithm 3: greedy decode) -------------------------
    @torch.no_grad()
    def generate(self, enc_tokens: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
        """Greedy titles ``(b, max_len)`` int32 for encoder tokens ``(b, S)``."""
        max_len = max_len or self.cfg.max_title_len
        enc_hs, state, enc_mask = self.encode(enc_tokens)
        b = enc_tokens.shape[0]
        tok = torch.full((b,), START, dtype=torch.long, device=enc_tokens.device)
        done = torch.zeros(b, dtype=torch.bool, device=enc_tokens.device)
        out = []
        for _ in range(max_len):
            state = self.decoder(self.embed_dec[tok], state)
            nxt = torch.argmax(self._logits(state.h, enc_hs, enc_mask), dim=-1)
            nxt = torch.where(done, PAD, nxt)
            done = done | (nxt == END)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1).to(torch.int32)
