"""xLSTM 1.3B — mLSTM/sLSTM 7:1 [arXiv:2405.04517]. d_ff=0: blocks are
self-contained (mLSTM up-projects internally).

Copy of ``repro/configs/xlstm_1_3b.py``.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    rope="none", norm="layernorm", act="gelu", glu=False,
    notes="48 layers = 6 scanned units of (7 mLSTM + 1 sLSTM). Fully "
          "recurrent => long_500k runs.",
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=64,
    block_pattern=("mlstm", "slstm"),
    rope="none", norm="layernorm", act="gelu", glu=False,
)
