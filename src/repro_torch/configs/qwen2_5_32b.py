"""Qwen2.5 32B — GQA kv=8 with QKV bias [hf:Qwen/Qwen2.5-32B].

Copy of ``repro/configs/qwen2_5_32b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope="rope", rope_theta=1e6,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = ArchConfig(
    name="qwen2.5-32b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=64,
    qkv_bias=True, rope="rope", norm="rmsnorm", act="silu", glu=True,
)
