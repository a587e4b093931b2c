"""The paper's case-study model: LSTM seq2seq title generator (see
repro_torch.models.seq2seq). Copy of ``repro/configs/p3sapp_summarizer.py``."""
from ..models.seq2seq import Seq2SeqConfig

CONFIG = Seq2SeqConfig(vocab_size=8000, d_embed=128, d_hidden=256,
                       n_encoder_layers=3, max_abstract_len=128, max_title_len=24)
SMOKE = Seq2SeqConfig(vocab_size=128, d_embed=16, d_hidden=32,
                      n_encoder_layers=2, max_abstract_len=24, max_title_len=8)
