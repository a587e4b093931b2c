"""The transformer LM of the port, for attention-only dense configurations.

Counterpart of ``repro/models/lm.py:180 LM`` for
``block_pattern == ("attn",)`` without MoE or a frontend (StableLM-3B,
Granite-20B, Qwen2.5-32B, Command R+). A Python loop over the layers takes
the place of ``lax.scan`` over stacked units, so each layer keeps its own
parameters (``repro_torch.bridge.lm_params_from_jax`` splits the JAX
package's stacked tree). Every other block kind, MoE and the frontends
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch
from torch import nn

from ..bridge import lm_params_from_jax
from ..device import resolve
from .attention import KVCache, attend, init_attention, init_kv_cache
from .blocks import (apply_mlp, apply_norm, embed_tokens, init_embed, init_mlp, init_norm,
                     lm_logits)


def _supported(cfg) -> None:
    todo = "ROADMAP.md Queue 1: the rest of the LM family"
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks wait for models/moe.py ({todo})")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend waits for {todo}")
    if cfg.window > 0 and cfg.ring_kv:
        raise NotImplementedError(
            f"{cfg.name}: the sliding-window ring KV cache waits for the windowed configs "
            f"({todo})")
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} needs the RG-LRU or xLSTM "
            f"blocks ({todo})")


def _params(tensors: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class LM(nn.Module):
    """Parameters, with the JAX package's names per layer:
    ``embed.{embedding,lm_head}``, ``layers.<i>.{norm1,attn,norm2,mlp}.*``,
    ``final_norm.*``. Forward-only: parameters do not require grad."""

    def __init__(self, cfg, device=None, *, dtype=torch.float32, seed: int = 0):
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` itself: the card unless the caller names
        another (``"meta"`` makes the shapes only). The same seed gives
        other weights on another kind of device; copy a state dict to
        compare devices."""
        super().__init__()
        _supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        device = resolve(device)
        g = torch.Generator(device="cpu" if device.type == "meta" else device)
        g.manual_seed(seed)
        kw = dict(dtype=dtype, device=device)
        self.embed = _params(init_embed(cfg, g, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "norm1": _params(init_norm(cfg, **kw)),
                "attn": _params(init_attention(cfg, g, **kw)),
                "norm2": _params(init_norm(cfg, **kw)),
                "mlp": _params(init_mlp(cfg, g, **kw)),
            })
            for _ in range(cfg.n_layers)
        )
        self.final_norm = _params(init_norm(cfg, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def param_count(self) -> int:
        """Parameters outside the norms, which is what the analytic
        ``ArchConfig.param_count()`` counts."""
        return sum(p.numel() for name, p in self.named_parameters() if "norm" not in name)

    def load_jax_params(self, tree) -> None:
        """Copy a JAX ``LM.init`` parameter tree (numpy leaves) in."""
        self.load_state_dict(
            {path.replace("/", "."): t for path, t in lm_params_from_jax(tree, self.cfg).items()}
        )

    def _block(self, layer, x, positions, cache=None, cache_pos=0):
        """``repro/models/lm.py:118 _apply_block`` for ``attn`` without MoE."""
        cfg = self.cfg
        h, new_cache = attend(layer["attn"], apply_norm(layer["norm1"], x, cfg.norm), cfg,
                              positions=positions, cache=cache, cache_pos=cache_pos)
        x = x + h
        return x + apply_mlp(layer["mlp"], apply_norm(layer["norm2"], x, cfg.norm), cfg), new_cache

    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """The residual stream after the last layer, before the final norm:
        ``(b, s, d_model)`` for ``tokens`` ``(b, s)``."""
        tokens = tokens.to(self.device)
        x = embed_tokens(self.embed, tokens, self.cfg)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        for layer in self.layers:
            x, _ = self._block(layer, x, positions)
        return x

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Logits ``(b, s, vocab)`` for ``batch["tokens"]`` ``(b, s)``.
        Counterpart of ``repro/models/lm.py:270 LM.forward`` without its
        MoE auxiliary loss, which is 0 for these configurations."""
        x = apply_norm(self.final_norm, self.hidden(batch["tokens"]), self.cfg.norm)
        return lm_logits(self.embed, x, self.cfg)

    def init_decode_state(self, batch: int, max_seq: int) -> list[KVCache]:
        """One zeroed KV cache per layer, in the model's dtype. Counterpart
        of ``repro/models/lm.py:317 LM.init_decode_state``, whose default
        cache dtype is bf16: the attention kernel reads the cache in place
        and takes one dtype for q, k and v."""
        return [init_kv_cache(batch, max_seq, self.cfg, self.dtype, self.device)
                for _ in range(self.cfg.n_layers)]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, state: list[KVCache], pos: int
                    ) -> tuple[torch.Tensor, list[KVCache]]:
        """One decode step, or a block prefill when ``tokens`` is ``(b, n)``
        with n > 1. ``pos`` is the number of tokens already in the cache.
        Returns the logits of the last position ``(b, 1, vocab)`` and the
        state, whose caches were written in place. Counterpart of
        ``repro/models/lm.py:373 LM.decode_step``."""
        tokens = tokens.to(self.device)
        x = embed_tokens(self.embed, tokens, self.cfg)
        b, s = tokens.shape
        positions = pos + torch.arange(s, device=self.device).expand(b, s)
        new_state = []
        for layer, cache in zip(self.layers, state):
            x, cache = self._block(layer, x, positions, cache, pos)
            new_state.append(cache)
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return lm_logits(self.embed, x[:, -1:], self.cfg), new_state
