"""Architecture configuration registry of the port.

Copy of ``repro/configs/__init__.py:19-197``: ``MoEConfig``, ``ArchConfig``
(with its analytic parameter count), ``ShapeConfig``/``SHAPES`` and
``get``/``get_smoke``. Each ``<id>.py`` module
exports ``CONFIG`` (the published configuration) and ``SMOKE`` (a reduced
same-family configuration for CPU tests). ``ARCH_IDS`` lists every
configuration of the reference's, all of which run through
``models/lm.py``: the attention-only dense models, the recurrent ones
(RG-LRU with local attention, xLSTM), the MoE ones (DeepSeek-MoE-16B,
Kimi-K2) and the two with a frontend (HuBERT X-Large: audio frames,
encoder-only; Qwen2-VL-72B: image patches and M-RoPE). The port keeps its
own order and appends the frontends.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    d_expert: int  # per-expert FFN width
    n_shared: int = 0
    first_k_dense: int = 0  # leading layers with a dense FFN instead of MoE
    d_ff_dense: int = 0  # width of those dense FFNs
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    expert_impl: str = "ragged"  # "ragged" | "batched"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: MoEConfig | None = None
    qkv_bias: bool = False
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    causal: bool = True  # False -> encoder-only
    window: int = 0  # >0 -> sliding-window attention
    block_pattern: tuple[str, ...] = ("attn",)  # unit repeated over depth
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    frontend: str = ""  # "" | audio | vision
    frontend_dim: int = 0
    n_frontend_tokens: int = 256
    d_rnn: int = 0  # recurrent width for rglru/xlstm blocks (0 -> d_model)
    init_scale: float = 0.02
    # chunk sizes of the JAX package's jnp attention; the port's attention
    # is one kernel and does not read them
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    ring_kv: bool = True  # sliding-window ring-buffer KV cache
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    # -- analytic parameter counts ------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads * hd, self.n_kv_heads * hd
        p = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            p += n_q + 2 * n_kv
        return p

    def _mlp_params(self, d_ff: int) -> int:
        return (3 if self.glu else 2) * self.d_model * d_ff

    def _block_params(self, kind: str) -> int:
        d, dr = self.d_model, self.resolved_d_rnn
        if kind == "attn":
            if self.moe is not None:
                m = self.moe
                experts = (m.n_experts + m.n_shared) * self._mlp_params(m.d_expert)
                return self._attn_params() + experts + d * m.n_experts
            return self._attn_params() + self._mlp_params(self.d_ff)
        if kind == "rglru":
            rec = 2 * d * dr + dr * d + 4 * dr + 2 * dr * dr + dr
            return rec + self._mlp_params(self.d_ff)
        if kind == "mlstm":
            return d * 2 * dr + 3 * dr * dr + 2 * dr + dr * d
        if kind == "slstm":
            return 4 * d * dr + 4 * dr * dr + 4 * dr + dr * d
        raise ValueError(kind)

    def param_count(self) -> int:
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.d_model * self.vocab_size
        if self.frontend:
            total += self.frontend_dim * self.d_model
        if self.moe is not None:
            m = self.moe
            dense_layer = self._attn_params() + self._mlp_params(m.d_ff_dense)
            moe_layer = self._block_params("attn")
            return total + m.first_k_dense * dense_layer + (
                self.n_layers - m.first_k_dense
            ) * moe_layer
        pat = self.block_pattern
        n_units, rem = divmod(self.n_layers, len(pat))
        for i, kind in enumerate(pat):
            total += (n_units + (1 if i < rem else 0)) * self._block_params(kind)
        return total

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: its top_k routed experts and
        the shared ones). Copy of ``repro/configs/__init__.py:138``."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (self.n_layers - m.first_k_dense) * (
            m.n_experts - m.top_k
        ) * self._mlp_params(m.d_expert)
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "stablelm_3b",
    "command_r_plus_104b",
    "granite_20b",
    "qwen2_5_32b",
    "recurrentgemma_9b",
    "xlstm_1_3b",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "hubert_xlarge",
    "qwen2_vl_72b",
]


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name.replace('-', '_')}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
