"""The readers of the program's spans (``harness/spans.py`` and the seven
metrics it serves) at the tiny cells: a finite value from an untraced
run's result, the profiled record left out, and None where the program's
ring cannot give the window's records."""

import importlib
import math

import pytest

from benchmark import run
from benchmark.harness import common, spans
from benchmark.tests.harness_cells import CPU, tiny_cell

SEED = 3_000_000_013
READERS = {"serve": ("encode_s", "decode_s", "capture_s"),
           "train": ("forward_s", "backward_s", "optimizer_s",
                     "host_wait_s")}
ROOT = {"serve": "serve.request", "train": "train.step"}


def _measured(kind, monkeypatch):
    """(cell, the generator's result) of ``run.measure`` at ``trace=0``."""
    cell = tiny_cell(kind)
    gen = importlib.import_module(
        f"benchmark.harness.{cell['traffic']['generator']}")
    kept = []
    orig = gen.run

    def keeping(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    monkeypatch.setattr(gen, "run", keeping)
    line = run.measure(cell, SEED, 0.1, 0, CPU)
    assert line["correct"] is True
    return cell, kept[0]


@pytest.fixture(scope="module")
def results():
    mp = pytest.MonkeyPatch()
    try:
        out = {kind: _measured(kind, mp) for kind in ("serve", "train")}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind,metric", [(k, m) for k, ms in READERS.items()
                                         for m in ms])
def test_reader_gives_a_finite_value(results, kind, metric):
    cell, res = results[kind]
    value = common.reader(metric).read(cell, res)
    assert value is not None and math.isfinite(value) and value >= 0


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_window_pairs_each_record_with_its_root(results, kind):
    _, res = results[kind]
    recs = spans.window(res, ROOT[kind])
    assert len(recs) == len(res["done"])
    for root, inner in recs:
        assert root.name == ROOT[kind] and root.parent is None
        assert inner and all(s.root == root.id for s in inner)
    # a profiled record is left out of the window
    done = [dict(r, traced=i == 0) for i, r in enumerate(res["done"])]
    if len(done) > 1:
        kept = spans.window(dict(res, done=done), ROOT[kind])
        assert [r for r, _ in kept] == [r for r, _ in recs[1:]]


def test_too_few_roots_give_none(results):
    cell, res = results["serve"]
    from idmvton_tpu_torch.utils import profiling
    done = [{"traced": False}] * (profiling.RING_SPANS + 1)
    assert spans.window(dict(res, done=done), "serve.request") is None
    for metric in READERS["serve"][:2]:
        assert common.reader(metric).read(cell, dict(res, done=done)) is None


def test_a_program_without_spans_gives_none(results, monkeypatch):
    """A program older than its spans (the parent of this change) reads
    as nothing, without raising."""
    from idmvton_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    for kind, metrics in READERS.items():
        cell, res = results[kind]
        for metric in metrics:
            assert common.reader(metric).read(cell, res) is None, metric
