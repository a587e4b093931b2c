"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

Copy of ``repro/configs/hubert_xlarge.py``. Backbone only, as there: the
conv feature extractor is a stub, and a batch gives precomputed 512-d
frame embeddings (``frames``) with k-means cluster ids as ``labels``
(vocab 504). Encoder-only, so it has no decode serving.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, rope="none", norm="layernorm", act="gelu", glu=False,
    frontend="audio", frontend_dim=512,
    notes="HuBERT uses conv-positional embeddings; stubbed as position-free "
          "(relative position information is out of scope for the backbone assignment).",
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=32,
    causal=False, rope="none", norm="layernorm", act="gelu", glu=False,
    frontend="audio", frontend_dim=24,
)
