"""The LM of the port: attention, MoE, RG-LRU and xLSTM blocks, and the
audio and vision frontends.

Counterpart of ``repro/models/lm.py:180 LM``: the attention-only dense
configurations (StableLM-3B, Granite-20B, Qwen2.5-32B, Command R+), the
MoE ones (DeepSeek-MoE-16B, Kimi-K2: the first ``first_k_dense`` layers
dense attention blocks with an MLP of ``d_ff_dense``, the rest attention
and MoE), Griffin (RecurrentGemma-9B: ``rglru, rglru, attn`` with local
attention), xLSTM (xLSTM-1.3B: 7 mLSTM + 1 sLSTM), and the two with a
frontend: HuBERT X-Large (``frames @ frontend/proj`` in place of the token
embedding, non-causal, trained on per-frame ``labels``) and Qwen2-VL-72B
(``patches @ frontend/proj`` over the first positions of the token
embedding, M-RoPE). Layer ``i`` has kind
``block_pattern[i % len(block_pattern)]``, the order of the reference's
unrolled ``head``, its stacked ``units`` and its unrolled ``tail``. A
Python loop over the layers takes the place of ``lax.scan`` over the
units, so each layer keeps its own parameters
(``repro_torch.bridge.lm_params_from_jax`` splits the JAX package's
stacked tree).

``loss`` is ``repro/models/lm.py:302 LM.loss``: the causal next-token
cross entropy, or for the encoder-only configuration the per-position
cross entropy against ``batch["labels"]``, plus ``router_aux_weight``
times the MoE layers' summed load-balance terms, differentiable through
the attention, RG-LRU and mLSTM kernels' backward kernels on the card.
With ``remat`` each layer runs under ``torch.utils.checkpoint`` and is
recomputed in the backward, as ``jax.checkpoint`` wraps each unit of the
reference (``:291``); a layer's kernel forward then launches twice a step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..bridge import lm_params_from_jax
from ..device import resolve
from . import moe as MOE
from . import rglru as RG
from . import xlstm as XL
from .attention import KVCache, attend, attention_axes, init_attention, init_kv_cache
from .blocks import (apply_mlp, apply_norm, cross_entropy_loss, embed_axes, embed_tokens,
                     init_embed, init_mlp, init_norm, lm_logits, mlp_axes, norm_axes,
                     truncated_normal)

BLOCK_KINDS = ("attn", "rglru", "mlstm", "slstm")


def _supported(cfg) -> None:
    unknown = set(cfg.block_pattern) - set(BLOCK_KINDS)
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


def layer_kinds(cfg) -> list[str]:
    """The block kind of every layer, in order."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def moe_layers(cfg) -> list[bool]:
    """Whether each layer's feed-forward is MoE: every layer after the
    first ``first_k_dense`` of a MoE configuration."""
    first = cfg.moe.first_k_dense if cfg.moe is not None else cfg.n_layers
    return [i >= first for i in range(cfg.n_layers)]


class MeshContext(NamedTuple):
    """The distribution context threaded through the model. Counterpart of
    ``repro/models/lm.py:43 MeshContext``."""

    mesh: Any = None
    data_axes: tuple[str, ...] = ()
    model_axis: str = ""
    seq_axis: str = ""  # set by the sequence-parallel plan

    def constrain_batch(self, x):
        """Anchor an activation DTensor: batch over the data axes (and, for
        the SP plan, the sequence over the model axis), the rest replicated.
        Where the batch does not divide the data axes (a decode batch of
        one) its rows are replicated over them: the reference leaves such a
        value to GSPMD, and DTensor's propagation left alone may put a
        partial sum's rows over the data axes by their sequence."""
        if self.mesh is None or not self.data_axes:
            return x
        from torch.distributed.tensor import Replicate, Shard

        size = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        rows = x.shape[0] % math.prod(size[a] for a in self.data_axes) == 0
        seq = bool(self.seq_axis) and x.ndim >= 2 and x.shape[1] % size[self.seq_axis] == 0
        placements = [Replicate() if size[a] == 1  # one rank holds it all either way
                      else Shard(0) if a in self.data_axes and rows
                      else Shard(1) if seq and a == self.seq_axis else Replicate()
                      for a in self.mesh.mesh_dim_names]
        return x.redistribute(self.mesh, placements)

    def scope(self):
        """DTensor operators may take plain tensors (positions, constants)
        as replicated values inside this scope, on a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from ..launch.mesh import replicate_plain

        return replicate_plain()


def _block_axes(cfg, kind: str, moe_layer: bool) -> dict:
    """Copy of ``repro/models/lm.py:100 _block_axes``."""
    if kind == "attn":
        p = {"norm1": norm_axes(cfg), "attn": attention_axes(cfg), "norm2": norm_axes(cfg)}
        if moe_layer:
            p["moe"] = MOE.moe_axes(cfg)
        else:
            p["mlp"] = mlp_axes(cfg)
        return p
    if kind == "rglru":
        return {"norm1": norm_axes(cfg), "rec": RG.rglru_axes(cfg),
                "norm2": norm_axes(cfg), "mlp": mlp_axes(cfg)}
    mix = XL.mlstm_axes(cfg) if kind == "mlstm" else XL.slstm_axes(cfg)
    return {"norm1": norm_axes(cfg), "mix": mix}


def _flat(tree: dict, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _init_block(cfg, kind: str, moe_layer: bool, g: torch.Generator, **kw) -> dict[str, dict]:
    """Counterpart of ``repro/models/lm.py:77 _init_block``."""
    if kind == "attn":
        p = {"norm1": init_norm(cfg, **kw), "attn": init_attention(cfg, g, **kw),
             "norm2": init_norm(cfg, **kw)}
        if moe_layer:
            p["moe"] = MOE.init_moe(cfg, g, **kw)
        else:
            d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else None
            p["mlp"] = init_mlp(cfg, g, d_ff=d_ff, **kw)
        return p
    if kind == "rglru":
        return {"norm1": init_norm(cfg, **kw), "rec": RG.init_rglru(cfg, g, **kw),
                "norm2": init_norm(cfg, **kw), "mlp": init_mlp(cfg, g, **kw)}
    init_mix = XL.init_mlstm if kind == "mlstm" else XL.init_slstm
    return {"norm1": init_norm(cfg, **kw), "mix": init_mix(cfg, g, **kw)}


def _params(tensors: dict) -> nn.ParameterDict:
    """Frozen parameters; a nested dict (MoE's ``shared``) nests."""
    return nn.ParameterDict({k: _params(t) if isinstance(t, dict)
                             else nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def _plain(sub: nn.ParameterDict) -> dict:
    """A layer's tensors as plain (nested) dicts, as they are now."""
    return {k: _plain(t) if isinstance(t, nn.ParameterDict) else t for k, t in sub.items()}


class LM(nn.Module):
    """Parameters, with the JAX package's names per layer:
    ``embed.{embedding,lm_head}``, ``frontend.proj`` ``(frontend_dim,
    d_model)`` for a configuration with a frontend (the audio one keeps its
    unused token embedding, as the reference does), ``layers.<i>.*``
    (``{norm1,attn,norm2,mlp}``
    for ``attn``, ``{norm1,attn,norm2,moe}`` for an MoE layer,
    ``{norm1,rec,norm2,mlp}`` for ``rglru``, ``{norm1,mix}`` for ``mlstm``
    and ``slstm``), ``final_norm.*``. Parameters do not
    require grad: a train step differentiates ``loss`` with respect to a
    ``{path: tensor}`` tree through ``runtime.train_loop.functional_loss``."""

    def __init__(self, cfg, device=None, *, mctx: MeshContext | None = None,
                 dtype=torch.float32, seed: int = 0, remat: bool = True):
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` itself: the card unless the caller names
        another (``"meta"`` makes the shapes only). The same seed gives
        other weights on another kind of device; copy a state dict to
        compare devices. ``remat`` recomputes each layer in ``loss``'s
        backward instead of keeping its activations. ``mctx`` runs the
        model on its mesh: give it DTensor parameters
        (``distribute_params``) through ``functional_call``."""
        super().__init__()
        _supported(cfg)
        self.cfg = cfg
        self.mctx = mctx or MeshContext()
        self.dtype = dtype
        self.remat = remat
        self.kinds = layer_kinds(cfg)
        self.moe = moe_layers(cfg)
        device = resolve(device)
        g = torch.Generator(device="cpu" if device.type == "meta" else device)
        g.manual_seed(seed)
        kw = dict(dtype=dtype, device=device)
        self.embed = _params(init_embed(cfg, g, **kw))
        if cfg.frontend:  # repro/models/lm.py:210-215
            self.frontend = _params({"proj": truncated_normal(
                (cfg.frontend_dim, cfg.d_model), cfg.init_scale / math.sqrt(cfg.frontend_dim),
                g, **kw)})
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: _params(t)
                           for name, t in _init_block(cfg, kind, moe, g, **kw).items()})
            for kind, moe in zip(self.kinds, self.moe)
        )
        self.final_norm = _params(init_norm(cfg, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def param_count(self) -> int:
        """Parameters outside the norms, which is what the analytic
        ``ArchConfig.param_count()`` counts (exactly so for attention-only
        configurations; for the recurrent blocks it differs by a few vectors)."""
        return sum(p.numel() for name, p in self.named_parameters() if "norm" not in name)

    def param_axes(self) -> dict[str, tuple]:
        """The logical axes of every parameter, ``{path: axes}`` with the
        paths of ``runtime.train_loop.params_of``. Counterpart of
        ``repro/models/lm.py:241 LM.param_axes``: the reference's stacked
        ``units`` carry a leading ``None`` for the stacked layer axis, which
        a per-layer tensor here does not have (``bridge.lm_params_from_jax``
        splits the stack)."""
        cfg = self.cfg
        axes = {"embed": embed_axes(cfg)}
        if cfg.frontend:
            axes["frontend"] = {"proj": ("frontend", "embed")}
        axes["layers"] = {str(i): _block_axes(cfg, kind, moe)
                          for i, (kind, moe) in enumerate(zip(self.kinds, self.moe))}
        axes["final_norm"] = norm_axes(cfg)
        return _flat(axes)

    def param_shardings(self) -> dict:
        """``{path: NamedSharding}`` of every parameter on the model's mesh
        under ``DEFAULT_RULES``, as the reference's launcher places them."""
        from ..distributed.sharding import DEFAULT_RULES, tree_shardings

        shapes = {name.replace(".", "/"): p for name, p in self.named_parameters()}
        return tree_shardings(shapes, self.param_axes(), self.mctx.mesh, DEFAULT_RULES)

    def distribute_params(self, params: dict) -> dict:
        """``params`` (``{path: tensor}``, the whole tree, the same on every
        rank: the model's seeded weights) as DTensors placed by
        ``param_shardings``; each rank keeps its own blocks, with no
        collective."""
        from ..distributed.sharding import distribute

        shardings = self.param_shardings()
        return {k: distribute(t, shardings[k]) for k, t in params.items()}

    def decode_state_axes(self) -> list:
        """The logical axes of ``init_decode_state``'s states, one per
        layer. Counterpart of ``repro/models/lm.py:336
        LM.decode_state_axes`` without the stacked axis."""
        kv = ("batch", "seq", "kv_heads", "head_dim")

        def one(kind):
            if kind == "attn":
                return KVCache(kv, kv)
            if kind == "rglru":
                return RG.RGLRUState(h=("batch", "rnn"), conv=("batch", None, "rnn"))
            if kind == "mlstm":
                return XL.MLSTMState(c=("batch", "heads", None, "rnn"),
                                     n=("batch", "heads", "rnn"), m=("batch", "heads"))
            return XL.SLSTMState(c=("batch", "rnn"), n=("batch", "rnn"),
                                 m=("batch", "rnn"), h=("batch", "rnn"))

        return [one(kind) for kind in self.kinds]

    def load_jax_params(self, tree) -> None:
        """Copy a JAX ``LM.init`` parameter tree (numpy leaves) in."""
        self.load_state_dict(
            {path.replace("/", "."): t for path, t in lm_params_from_jax(tree, self.cfg).items()}
        )

    def _block(self, layer, kind, moe, x, positions, cache=None, cache_pos=0):
        """``repro/models/lm.py:118 _apply_block`` -> (x, the new cache or
        state, the MoE layer's load-balance term or None). On a mesh the
        residual leaves each block anchored as the embedding's is
        (``MeshContext.constrain_batch``): DTensor's propagation may leave a
        row-parallel product's sum split over the model axis as well, and a
        vocabulary-sharded head would then gather its whole weight onto
        every rank."""
        with self.mctx.scope():
            x, new_cache, aux = self._block_ops(layer, kind, moe, x, positions, cache,
                                                cache_pos)
            return self.mctx.constrain_batch(x), new_cache, aux

    def _block_ops(self, layer, kind, moe, x, positions, cache, cache_pos):
        cfg, mctx = self.cfg, self.mctx
        h_in = apply_norm(layer["norm1"], x, cfg.norm)
        if kind == "attn":
            h, new_cache = attend(layer["attn"], h_in, cfg, positions=positions, cache=cache,
                                  cache_pos=cache_pos)
        elif kind == "rglru":
            h, new_cache = RG.apply_rglru_mix(layer["rec"], h_in, cfg, state=cache)
        else:
            scan = XL.mlstm_scan if kind == "mlstm" else XL.slstm_scan
            h, new_cache = scan(layer["mix"], h_in, cfg, state=cache)
            return x + h, new_cache, None  # an xLSTM block has no MLP
        x = x + h
        h2 = apply_norm(layer["norm2"], x, cfg.norm)
        if moe:
            ff, aux = MOE.apply_moe(layer["moe"], h2, cfg, mesh=mctx.mesh,
                                    data_axes=mctx.data_axes, model_axis=mctx.model_axis)
            return x + ff, new_cache, aux
        return x + apply_mlp(layer["mlp"], h2, cfg), new_cache, None

    def _embed(self, batch: dict) -> torch.Tensor:
        """The first residual ``(b, s, d_model)``, as
        ``repro/models/lm.py:258 _embed`` makes it: ``frames @ proj`` for the
        audio frontend (no token embedding); the token embedding otherwise,
        its first ``patches.shape[1]`` positions replaced by ``patches @
        proj`` where the vision frontend's batch gives patches. On a mesh
        the result is anchored by ``MeshContext.constrain_batch``."""
        with self.mctx.scope():
            return self.mctx.constrain_batch(self._embed_ops(batch))

    def _embed_ops(self, batch: dict) -> torch.Tensor:
        cfg, dev = self.cfg, self.device
        if cfg.frontend == "audio":
            return batch["frames"].to(dev, self.dtype) @ self.frontend["proj"]
        x = embed_tokens(self.embed, self._on_mesh(batch["tokens"].to(dev)), cfg)
        if cfg.frontend == "vision" and "patches" in batch:
            pe = batch["patches"].to(dev, x.dtype) @ self.frontend["proj"]
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _on_mesh(self, t: torch.Tensor):
        """A plain tensor (the whole batch, the same on every rank) as a
        replicated DTensor on the mesh; a DTensor or, off a mesh, any tensor
        as it is."""
        if self.mctx.mesh is None:
            return t
        from ..launch.mesh import is_dtensor

        if is_dtensor(t):
            return t
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(t, self.mctx.mesh, [Replicate()] * self.mctx.mesh.ndim,
                                  run_check=False)

    def _trunk(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``hidden`` without ``no_grad``, and the MoE layers' summed
        load-balance term (None without MoE): under grad with ``remat``
        each layer is a checkpoint. The checkpointed function gets the
        layer's tensors as plain dicts made here, so that its recompute in
        the backward reads the tensors this call saw (``functional_call``'s,
        which are gone from the module by then)."""
        x = self._embed(batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        remat = self.remat and torch.is_grad_enabled()
        aux_total = None
        for layer, kind, moe in zip(self.layers, self.kinds, self.moe):
            if remat:
                x, aux = checkpoint(self._layer, _plain(layer), kind, moe, x, positions,
                                    use_reentrant=False)
            else:
                x, _, aux = self._block(layer, kind, moe, x, positions)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def _layer(self, layer, kind, moe, x, positions):
        x, _, aux = self._block(layer, kind, moe, x, positions)
        return x, aux

    @torch.no_grad()
    def hidden(self, batch: dict) -> torch.Tensor:
        """The residual stream after the last layer, before the final norm:
        ``(b, s, d_model)`` for a batch of ``forward``'s."""
        return self._trunk(batch)[0]

    def _logits(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
        x, aux = self._trunk(batch)
        with self.mctx.scope():
            x = apply_norm(self.final_norm, x, self.cfg.norm)
            return lm_logits(self.embed, x, self.cfg), aux

    @torch.no_grad()
    def forward(self, batch: dict, *, with_aux: bool = False):
        """Logits ``(b, s, vocab)`` for a batch of ``tokens`` ``(b, s)``
        (with the vision frontend, optionally ``patches`` ``(b, n <= s,
        frontend_dim)`` too) or, with the audio frontend, of ``frames`` ``(b,
        s, frontend_dim)``; with ``with_aux`` also the MoE layers' summed
        load-balance term (fp32 0-d, 0 without MoE), as
        ``repro/models/lm.py:270 LM.forward`` returns (logits, moe_aux)."""
        logits, aux = self._logits(batch)
        if not with_aux:
            return logits
        return logits, torch.zeros((), device=logits.device) if aux is None else aux

    def loss(self, batch: dict) -> torch.Tensor:
        """The mean cross entropy, plus ``router_aux_weight`` times the MoE
        layers' summed load-balance term, fp32 0-d. Counterpart of
        ``repro/models/lm.py:302 LM.loss``: a causal configuration predicts
        ``batch["tokens"]`` shifted by one; the encoder-only one classifies
        every position against ``batch["labels"]`` ``(b, s)``, unshifted."""
        logits, aux = self._logits(batch)
        with self.mctx.scope():
            if self.cfg.causal:
                targets = self._on_mesh(batch["tokens"].to(self.device))[:, 1:]
                logits = logits[:, :-1]
            else:
                targets = self._on_mesh(batch["labels"].to(self.device))
            ce = cross_entropy_loss(logits, targets, torch.ones_like(targets))
            if aux is None:
                return ce
            return ce + self.cfg.moe.router_aux_weight * aux

    def init_decode_state(self, batch: int, max_seq: int, rules=None) -> list:
        """One state per layer, of its kind: a zeroed KV cache (a ring of
        ``min(max_seq, window)`` slots for a windowed configuration), an
        ``RGLRUState``, an ``MLSTMState`` or an ``SLSTMState``. Counterpart
        of ``repro/models/lm.py:317 LM.init_decode_state``, whose default
        cache dtype is bf16: here the KV cache and the conv tail take the
        model's dtype (the attention kernel reads the cache in place and
        takes one dtype for q, k and v); the recurrent states are fp32, as
        in the reference.

        On a mesh every leaf is a DTensor placed by ``decode_state_axes()``
        under ``rules`` (``DEFAULT_RULES`` unless given; the reference's dry
        run passes its plan's, ``repro/launch/dryrun.py:207``, ``:238-243``,
        ``:270-277``), and each rank allocates only its own block of it."""
        cfg, mesh = self.cfg, self.mctx.mesh
        dev = self.device if mesh is None else torch.device("meta")  # on a mesh: shapes

        def one(kind):
            if kind == "attn":
                return init_kv_cache(batch, max_seq, cfg, self.dtype, dev)
            if kind == "rglru":
                return RG.init_rglru_state(batch, cfg, self.dtype, dev)
            if kind == "mlstm":
                return XL.init_mlstm_state(batch, cfg, dev)
            return XL.init_slstm_state(batch, cfg, dev)

        state = [one(kind) for kind in self.kinds]
        if mesh is None:
            return state
        from ..distributed.sharding import DEFAULT_RULES, tree_shardings

        shardings = tree_shardings(state, self.decode_state_axes(), mesh, rules or DEFAULT_RULES)
        # every leaf starts constant, as the init_*_state functions fill it:
        # the stabilisers m at NEG_INF, every other leaf at 0
        return [type(s)(*(_local_block(t, sh, XL.NEG_INF if f == "m" else 0.0, self.device)
                          for f, t, sh in zip(s._fields, s, shs)))
                for s, shs in zip(state, shardings)]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, state: list, pos: int
                    ) -> tuple[torch.Tensor, list]:
        """One decode step, or a block prefill when ``tokens`` is ``(b, n)``
        with n > 1. ``pos`` is the number of tokens already seen. Returns
        the logits of the last position ``(b, 1, vocab)`` and the new state;
        the KV caches and the mLSTM memories C were written in place.
        Counterpart of ``repro/models/lm.py:373 LM.decode_step``.

        On a mesh (DTensor parameters, the state of ``init_decode_state``)
        each layer's state stays where the rules put it, the kernels run on
        each rank's block, and the logits come out placed by the batch's
        spec (``batch_spec``), as the reference's dry run places them. The
        first residual is anchored by ``constrain_batch``, as the reference
        anchors a block prefill's (``repro/models/lm.py:380-381``); a
        one-token step's too, as every block's residual is here."""
        tokens = self._on_mesh(tokens.to(self.device))
        b, s = tokens.shape
        positions = pos + torch.arange(s, device=self.device).expand(b, s)
        with self.mctx.scope():
            x = self.mctx.constrain_batch(embed_tokens(self.embed, tokens, self.cfg))
        new_state = []
        for layer, kind, moe, cache in zip(self.layers, self.kinds, self.moe, state):
            x, cache, _ = self._block(layer, kind, moe, x, positions, cache, pos)  # aux unused
            new_state.append(cache)
        with self.mctx.scope():
            x = apply_norm(self.final_norm, x, self.cfg.norm)
            logits = lm_logits(self.embed, x[:, -1:], self.cfg)
        if self.mctx.mesh is not None:
            from ..distributed.sharding import NamedSharding, batch_spec

            logits = logits.redistribute(
                self.mctx.mesh, NamedSharding(self.mctx.mesh, batch_spec(self.mctx.mesh, b))
                .placements)
        return logits, new_state


def _local_block(t: torch.Tensor, sharding, fill: float, device):
    """A DTensor of ``t``'s shape and dtype (``t`` on the meta device),
    placed by ``sharding`` and filled with ``fill``: each rank allocates
    only its own block."""
    from torch.distributed.tensor import DTensor

    shape = [sl.stop - sl.start for sl in sharding.local_slices(t.shape)]
    local = torch.full(shape, fill, dtype=t.dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=t.shape, stride=t.stride())
