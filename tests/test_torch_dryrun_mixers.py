"""The dry run's FLOPs against the JAX dry run's cost model for the
families with a recurrent or MoE layer (RecurrentGemma-9B, xLSTM-1.3B,
DeepSeek-MoE-16B, Kimi-K2), each cell kind at SMOKE size, within 1% after
the differences ``test_torch_dryrun.py`` states (remat, the sLSTM's first
step, the CPU's dense lowering of ``ragged_dot``)."""

import pytest

from test_torch_dryrun import cases, check_against_reference, one_torch_thread  # noqa: F401

MIXERS = ("recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b", "kimi_k2_1t_a32b")


@pytest.mark.parametrize("arch,kind", cases(MIXERS))
def test_flops_match_the_reference(arch, kind):
    check_against_reference(arch, kind)
