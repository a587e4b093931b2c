"""Command R+ 104B — GQA, no biases [hf:CohereForAI/c4ai-command-r-plus].

Copy of ``repro/configs/command_r_plus_104b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    rope="rope", norm="layernorm", act="silu", glu=True,
    tie_embeddings=True,  # Cohere ties input/output embeddings
)

SMOKE = ArchConfig(
    name="command-r-plus-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=64,
    rope="rope", norm="layernorm", act="silu", glu=True,
    tie_embeddings=True,
)
