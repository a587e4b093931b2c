"""``chip_smoke.py``'s bf16 step split at the residual stream, on the CPU.

Where a gradient of the bf16 train step misses its rule card against CPU,
``chip_smoke.py`` splits the step: it records the CPU step's residual
stream at the layer boundaries (``residual_stream``: each layer's input
and the loss's cotangent of it) and runs each layer, the embedding and the
head alone from those values (``bf16_split_step``), on the card and on the
CPU. That is a check of the card only if the split step is the step: on
one device, from its own boundary values, the split step's parameter
gradients, boundary cotangents and layer outputs are the whole step's bit
for bit, with remat (the CPU step is recorded as it runs) and in fp32 too.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.lm import LM
from repro_torch.runtime.train_loop import functional_loss, params_of, value_and_grad

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = load_smoke()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("arch", SMOKE.BF16_CHECKED)
def test_split_step_is_the_whole_step(arch, dtype):
    cfg = dataclasses.replace(get_smoke(arch), init_scale=1.0)
    model = LM(cfg, "cpu", dtype=dtype, seed=1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        4, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    with SMOKE.residual_stream(model) as (xs, cotangents):
        _, whole = value_and_grad(functional_loss(model))(params_of(model), {"tokens": tokens})
    assert len(xs) == len(cotangents) == len(model.layers) + 1
    dxs = [cotangents[i] for i in range(len(xs))]
    split, outs = SMOKE.bf16_split_step(model, tokens, xs, dxs)
    assert model.remat
    assert set(split) == set(whole) | {f"residual/{i}" for i in range(len(xs))}
    for path, g in whole.items():
        torch.testing.assert_close(split[path], g, rtol=0, atol=0, msg=path)
    for i, d in enumerate(dxs):
        torch.testing.assert_close(split[f"residual/{i}"], d, rtol=0, atol=0)
    for y, x in zip(outs, xs[1:]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
