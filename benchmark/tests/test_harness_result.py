"""The result line, and the runs that must print none."""

import json
import sys
import types

import pytest
import torch

from benchmark import run
from benchmark.tests.harness_cells import CPU, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def serve_line():
    return run.measure(tiny_cell("serve"), 3_000_000_007, 0.0, 0, CPU)


def test_result_keys_untraced(serve_line):
    assert list(serve_line) == KEYS
    assert "breakdown" not in serve_line
    assert set(serve_line["metrics"]) == {"setup_s", "request_s",
                                          "request_s.p95", "peak_gib"}
    for m in serve_line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(serve_line["device"]) == {"platform", "kind", "count",
                                         "memory_peak_bytes"}
    json.dumps(serve_line)


def test_checks_hold_every_number_beside_its_limit(serve_line):
    checks = serve_line["checks"]
    assert set(checks) == {"encode_rel", "step_ratio", "decode_rel",
                           "narrow_tensors", "failed"}
    for c in checks.values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None
    assert serve_line["correct"] is True


def test_train_line_keys():
    line = run.measure(tiny_cell("train"), 3_000_000_009, 0.1, 0, CPU)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"setup_s", "train_step_s", "peak_gib"}
    assert set(line["checks"]) == {"loss_rel", "grad_rel", "change_rel",
                                   "narrow_tensors", "failed"}
    assert line["correct"] is True


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    measured = []
    monkeypatch.setattr(run, "measure", lambda *a, **k: measured.append(a))
    rc = run.main(["--workload", "serve.vitonhd_b2", "--seed",
                   "4294967297", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and not measured
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "serve.vitonhd_b2", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_jax_loaded_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "measure", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "serve.vitonhd_b2", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_the_port_name_alone_is_not_forbidden():
    from benchmark.harness import common
    assert "idmvton_tpu_torch" in sys.modules
    assert common.forbidden_modules() == []


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and benchmark/: the harness cannot build the
    program, and the process exits with an error."""
    import shutil
    import subprocess
    from benchmark.harness import common
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark.harness import common, serve; "
            "cell = common.cell('serve.vitonhd_b2'); "
            "serve.build_models(cell['config'], 1, 'cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "idmvton_tpu_torch" in p.stderr
