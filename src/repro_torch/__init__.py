"""PyTorch/CUDA port of the P3SAPP case study (counterpart of ``repro``).

The package serves the paper's LSTM title generator (paper §4.2.3,
Algorithm 3) on one NVIDIA Hopper card: the abstract cleaning chain, the
word tokenizer, a 3-layer LSTM encoder and a greedy Bahdanau-attention
decoder. Its two hot kernels (the fused LSTM cell and the cleaning scan
pass) are hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc``.

It imports ``torch``, numpy and the standard library only; nothing of JAX
and nothing of the ``repro`` package. Importing it builds nothing: the
kernels compile at their first launch.
"""
