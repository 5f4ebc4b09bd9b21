"""The harness driven end to end at the tiny configurations, with the
timed path broken underneath: ``correct`` has to come out false for each
fault a cell can have. (The exchange between chips has no fault here:
every cell runs on one card.)"""

import pytest

from benchmark import run
from benchmark.tests.harness_cells import CPU, tiny_cell

SEED = 3_000_000_011


def serve_line(**kw):
    return run.measure(tiny_cell("serve"), SEED, 0.0, 0, CPU, **kw)


def test_sound_serving_is_correct():
    assert serve_line()["correct"] is True


def _patch_step(monkeypatch, fn):
    from idmvton_tpu_torch.pipeline import tryon
    orig = tryon.TryonPipeline._step

    def step(self, cond, latents, row, noise, feats=None, blend=None, **kw):
        return fn(orig(self, cond, latents, row, noise, feats, blend, **kw),
                  latents)

    monkeypatch.setattr(tryon.TryonPipeline, "_step", step)


def test_step_returning_its_state_unchanged(monkeypatch):
    _patch_step(monkeypatch, lambda new, old: old)
    line = serve_line()
    assert line["correct"] is False
    check = line["checks"]["step_ratio"]
    assert check["value"] > check["limit"]


def test_half_the_batch_left_out(monkeypatch):
    def half(new, old):
        out = new.clone()
        out[new.shape[0] // 2:] = new[:new.shape[0] // 2]
        return out
    _patch_step(monkeypatch, half)
    assert serve_line()["correct"] is False


def test_answer_altered_where_produced(monkeypatch):
    from idmvton_tpu_torch.pipeline import tryon
    orig = tryon.TryonPipeline.decode
    monkeypatch.setattr(tryon.TryonPipeline, "decode",
                        lambda self, lat: orig(self, lat) * 1.05)
    line = serve_line()
    assert line["correct"] is False
    assert line["checks"]["decode_rel"]["value"] > 0.04


def train_line():
    return run.measure(tiny_cell("train"), SEED, 0.0, 0, CPU)


def test_sound_training_is_correct():
    assert train_line()["correct"] is True


def test_train_state_unchanged(monkeypatch):
    from idmvton_tpu_torch.train import train_step
    monkeypatch.setattr(train_step.Optimizer, "update_",
                        lambda self, grads, state, params, **kw: True)
    line = train_line()
    assert line["correct"] is False
    assert line["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_train_half_batch_mean_over_the_rest(monkeypatch):
    from idmvton_tpu_torch.train import train_step
    orig = train_step.tryon_loss

    def half(trainable, models, scheduler, batch, generator=None, **kw):
        b = batch["person"].shape[0] // 2
        return orig(trainable, models, scheduler,
                    {k: v[:b] for k, v in batch.items()}, generator, **kw)

    monkeypatch.setattr(train_step, "tryon_loss", half)
    assert train_line()["correct"] is False


def test_train_loss_altered_where_produced(monkeypatch):
    from idmvton_tpu_torch.train import train_step
    orig = train_step.tryon_loss
    monkeypatch.setattr(train_step, "tryon_loss",
                        lambda *a, **kw: orig(*a, **kw) * 1.25)
    line = train_line()
    assert line["correct"] is False
    assert line["checks"]["loss_rel"]["value"] > 0.1
