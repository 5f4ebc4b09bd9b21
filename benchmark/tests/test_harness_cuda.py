"""On the card (marker ``cuda``; skipped without one): a traced tiny run
gives the traced keys, a breakdown and every per-layer metric its cell
lists, with shares under 100%."""

import pytest
import torch

from benchmark import run
from benchmark.tests.harness_cells import tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_traced_serving_run(card):
    line = run.measure(tiny_cell("serve"), 3_000_000_031, 2.0, 1, card)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["busy_s"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["device_ops"]) <= 10
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105, name
    assert {"denoise_s", "step_device_ms", "idle_share.serve",
            "mfu.serve"} <= set(line["metrics"])


@pytest.mark.cuda
def test_traced_training_run(card):
    line = run.measure(tiny_cell("train"), 3_000_000_033, 1.0, 1, card)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mfu.train", "idle_share.train"}
