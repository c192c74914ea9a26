"""The cells at a small size on the card: sound runs, untraced and traced,
come out correct and report their metrics; the controls come out not
correct.  Marked ``cuda``: each test skips without a card."""

import pytest
import torch

from portbench import control
from tiny import tiny_cell, tiny_run

CELLS = ("gov2pfd-decode", "gov2-stream", "dsv2lite-decode-conv")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = tiny_run(name, device="cuda", seconds=2.0, trace=trace)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
        assert any(n.startswith("device_idle") for n in out["metrics"])
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    got = control.control(tiny_cell(name), 11, 4, card)
    assert got["failed"], got
