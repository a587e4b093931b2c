"""RecurrentGemma 9B — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427]. Pattern unit = (rglru, rglru, attn-local-2048).

Copy of ``repro/configs/recurrentgemma_9b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    window=2048, block_pattern=("rglru", "rglru", "attn"),
    rope="rope", norm="rmsnorm", act="gelu", glu=True,
    tie_embeddings=True,
    notes="38 layers = 12 scanned (rec,rec,attn) units + 2 unrolled tail "
          "rglru layers. Local attention window 2048 => sub-quadratic; "
          "long_500k runs.",
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=64,
    window=16, block_pattern=("rglru", "rglru", "attn"),
    rope="rope", norm="rmsnorm", act="gelu", glu=True, tie_embeddings=True,
)
