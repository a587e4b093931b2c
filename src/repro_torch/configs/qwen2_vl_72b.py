"""Qwen2-VL 72B — M-RoPE, dynamic-resolution vision [arXiv:2409.12191].

Copy of ``repro/configs/qwen2_vl_72b.py``. Backbone only, as there: the
ViT tower is a stub, and a batch may give precomputed patch embeddings
(``patches``) that take the first positions of the token rows.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope="mrope", rope_theta=1e6,
    norm="rmsnorm", act="silu", glu=True,
    frontend="vision", frontend_dim=1280, n_frontend_tokens=256,
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=64,
    qkv_bias=True, rope="mrope",
    norm="rmsnorm", act="silu", glu=True,
    frontend="vision", frontend_dim=24, n_frontend_tokens=16,
)
