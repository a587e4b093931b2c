"""Granite 20B Code — MQA (kv=1), GPT-BigCode lineage [arXiv:2405.04324].

Copy of ``repro/configs/granite_20b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    rope="rope", norm="layernorm", act="gelu", glu=False,
    notes="d_ff = 4*d, plain GELU MLP (BigCode style); MQA exercises the "
          "kv-head<model-axis sharding fallback.",
)

SMOKE = ArchConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=1, head_dim=8,
    d_ff=256, vocab_size=64,
    rope="rope", norm="layernorm", act="gelu", glu=False,
)
