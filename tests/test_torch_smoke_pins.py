"""``chip_smoke.py``'s pinned ``mlstm_chunk`` draws, on the CPU: each
recorded generator state in ``chip_smoke_pins/`` restores and gives the draw
whose q sum the smoke checks, so a pin that no longer reproduces its case
shows here before a run on the card."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = load_smoke()


@pytest.mark.parametrize("name", sorted(SMOKE.MLSTM_PINNED))
def test_pinned_state_gives_its_draw(name, monkeypatch):
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    (b, s, H, dh), q_sum, _ = SMOKE.MLSTM_PINNED[name]
    raw = (SMOKE.PINS / f"{name}.state").read_bytes()
    gen = torch.Generator()
    gen.set_state(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    q, k, v, i_gate, f_gate = SMOKE.mlstm_inputs(b, s, H, dh, gen)
    assert q.shape == (b, s, H, dh) and f_gate.shape == (b, s, H)
    assert q.double().sum().item() == pytest.approx(q_sum, rel=1e-9, abs=0)
