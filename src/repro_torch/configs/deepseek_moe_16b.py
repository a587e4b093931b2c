"""DeepSeekMoE 16B — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base].

Copy of ``repro/configs/deepseek_moe_16b.py``.
"""
from . import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_k_dense=1, d_ff_dense=10944),
    rope="rope", norm="rmsnorm", act="silu", glu=True,
    notes="first layer dense FFN (d_ff 10944) per the released model.",
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=64,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                  first_k_dense=1, d_ff_dense=256),
)
