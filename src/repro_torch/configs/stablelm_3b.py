"""StableLM 3B [hf:stabilityai/stablelm-2; assignment table].

Copy of ``repro/configs/stablelm_3b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    rope="rope", norm="layernorm", act="silu", glu=True,
)

SMOKE = ArchConfig(
    name="stablelm-3b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=64,
    rope="rope", norm="layernorm", act="silu", glu=True,
)
