"""The controls at the tiny configurations: the reference in the
program's place with every product's operands in float8 e4m3 reads far
above the program on the same seed, and fails the cell's limits; the
program's own W8A8 path fails them through its int8 codes; the training
faults planted in the reference read as ``compare`` says."""

import pytest

from benchmark import control
from benchmark.harness import common, serve, train
from benchmark.tests.harness_cells import CPU, tiny_cell

SEEDS = (3_000_000_021, 3_000_000_022, 3_000_000_023)


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(seed):
    cell = tiny_cell("serve")
    got, _ = serve.e4m3_control(cell, seed, CPU)
    sound = serve.run(cell, seed, 0.0, False, CPU, 0.0)["readings"]
    assert common.judge(got, cell["limits"])[0] is False
    assert common.judge(sound, cell["limits"])[0] is True
    for k in ("encode_rel", "step_ratio", "decode_rel"):
        assert got[k] > 3 * sound[k], k


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_serving_w8a8_control_fails(seed):
    cell = tiny_cell("serve")
    res = serve.run(cell, seed, 0.0, False, CPU, 0.0, prepare=control.w8a8)
    correct, checks = common.judge(res["readings"], cell["limits"])
    assert correct is False
    narrow = next(c for c in checks if c["name"] == "narrow_tensors")
    assert narrow["value"] > narrow["limit"] == 0


def test_training_control_fails():
    cell = tiny_cell("train")
    got, _ = train.e4m3_control(cell, SEEDS[0], CPU)
    assert common.judge(got, cell["limits"])[0] is False


def test_training_faults_in_the_reference():
    cell = tiny_cell("train")
    faults = train.fault_readings(cell, SEEDS[0], CPU)
    assert common.judge(faults["half_batch"], cell["limits"])[0] is False
    assert faults["loss_x1.05"]["loss_rel"] == pytest.approx(0.05, rel=1e-3)
