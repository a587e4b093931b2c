"""``tools/kernel_stamps.py`` puts its timer stamps before or after anchor
lines of the CUDA sources (with their local headers inlined). An edit of a kernel that drops an anchor would
only show on the card; here every anchor is looked up in the current
sources, on the CPU, with nothing built."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def load_tool():
    spec = importlib.util.spec_from_file_location("kernel_stamps", ROOT / "tools" / "kernel_stamps.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("source, stamps, phases", [
    ("lstm_cell.cu", "LSTM_STAMPS", "LSTM_PHASES"),
    ("mlstm_chunk.cu", "MLSTM_STAMPS", "MLSTM_PHASES"),
    ("flash_attention.cu", "FLASH_STAMPS", "FLASH_PHASES"),
    ("text_clean.cu", "CLEAN_STAMPS", "CLEAN_PHASES"),
    ("text_scan.cu", "SCAN_STAMPS", "SCAN_PHASES"),
])
def test_every_anchor_is_in_the_source(source, stamps, phases):
    tool = load_tool()
    stamps, phases = getattr(tool, stamps), getattr(tool, phases)
    assert len(stamps) == len(phases) <= tool.SLOTS
    src = tool.source_text(source)
    for anchor, where, _ in stamps:
        assert src.count(anchor) == 1, anchor
        assert where in ("before", "after")
    out = tool.instrument(src, stamps)
    assert all(f"STAMP({i});" in out for i in range(len(stamps)))
