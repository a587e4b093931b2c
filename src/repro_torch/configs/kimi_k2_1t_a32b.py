"""Kimi K2 — trillion-parameter MoE, 384 routed experts top-8
[arXiv:2501.kimi2 paper-table; DeepSeek-V3-style skeleton].

Copy of ``repro/configs/kimi_k2_1t_a32b.py``.
"""
from . import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1,
                  first_k_dense=1, d_ff_dense=18432),
    rope="rope", norm="rmsnorm", act="silu", glu=True,
    notes="Assignment table gives GQA kv=8 (we follow it; the real model uses "
          "MLA). head_dim=128 per K2 tech report. First layer dense.",
)

SMOKE = ArchConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=64, vocab_size=64,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=64, n_shared=1,
                  first_k_dense=1, d_ff_dense=192),
)
