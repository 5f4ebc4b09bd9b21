"""The port's train state and fine-tuning CLI, on the CPU.

- ``save_train_state`` / ``load_train_state`` / ``latest_train_state_step``
  (modelled on JAX's ``tests/test_checkpoint_resume.py``): a run
  interrupted after a step, saved and resumed into a fresh template,
  continues bit for bit as the uninterrupted run (each optimizer's state,
  mid-accumulation too); old states are pruned; a state of another
  optimizer is refused.
- ``cli.train.main --micro --device cpu`` end to end on a synthetic
  VITON-HD tree: the optimizer-step cadence under gradient accumulation,
  the pipeline checkpoints (``save_pipeline`` of the trained masters), the
  eval images, and a resumed second run.

Port only, the micro stack in fp32 (the CLI's bf16): the property under
test is the bookkeeping, which JAX's own tests hold for its package.
"""

import os

import numpy as np
import pytest
import torch

from idmvton_tpu_torch.cli import train as cli_train
from idmvton_tpu_torch.core.config import SchedulerConfig
from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
from idmvton_tpu_torch.pipeline.tryon import TryonModels
from idmvton_tpu_torch.train.train_step import (
    flat_params, init_train_state, make_optimizer, make_train_step,
)
from idmvton_tpu_torch.weights.checkpoint import (
    latest_train_state_step, load_pipeline, load_train_state,
    save_train_state,
)
from test_data_cli import make_viton_tree


@pytest.fixture(scope="module")
def models():
    return TryonModels.init(0, micro=True, device="cpu", dtype=torch.float32)


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    img = lambda: torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    ids = lambda: torch.randint(0, 1000, (2, 7), generator=g)
    return dict(person=img(), pose=img(), cloth=img(),
                mask=(torch.rand(2, 32, 32, 1, generator=g) > 0.5).float(),
                prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                cloth_ids_g=ids(),
                ip_pixels=torch.rand(2, 28, 28, 3, generator=g) * 2 - 1)


def _tensors(state) -> dict:
    """Every tensor and counter of a state, by path."""
    out = {"step": state.step}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v
    walk({"trainable": state.trainable, "opt_state": state.opt_state}, "")
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k, v in ta.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == tb[k].dtype and torch.equal(v, tb[k]), k
        else:
            assert v == tb[k], k


@pytest.mark.parametrize("optimizer,accum", [
    ("adamw", 1), ("adamw8bit", 2), ("adafactor", 1)])
def test_resume_equals_uninterrupted_run(models, tmp_path, optimizer, accum):
    """Three micro-steps straight against one, a save, a load into a fresh
    template and two more: every tensor and counter of the two states
    equal bit for bit after each step (the VAE posteriors, noises and
    timesteps drawn from generators seeded per step, as a run's would be
    replayed). With accumulation the save falls mid-accumulation, so the
    running mean is part of what resumes."""
    sched = DDPMScheduler(SchedulerConfig.train())
    tx = make_optimizer(learning_rate=1e-3, optimizer=optimizer,
                        accum_steps=accum)
    step = make_train_step(models, sched, tx, snr_gamma=5.0,
                           compute_dtype=torch.float32, remat=False)
    gen = lambda i: torch.Generator().manual_seed(100 + i)
    straight = init_train_state(models, tx)
    for i in range(3):
        straight, _ = step(straight, _batch(i), gen(i))
    first = init_train_state(models, tx)
    first, _ = step(first, _batch(0), gen(0))
    path = str(tmp_path / "state")
    save_train_state(path, first)
    assert latest_train_state_step(path) == 1
    resumed = load_train_state(path, init_train_state(models, tx))
    _assert_states_equal(resumed, first)
    for p in flat_params(resumed.trainable).values():
        assert p.requires_grad and p.is_leaf
    for i in (1, 2):
        resumed, _ = step(resumed, _batch(i), gen(i))
    _assert_states_equal(resumed, straight)


def test_prune_and_refuse(models, tmp_path):
    """``keep`` newest states survive (JAX's ``test_prune_old_states``); an
    empty directory has no latest step; a template of another optimizer
    finds its moments missing and is refused."""
    tx = make_optimizer()
    state = init_train_state(models, tx)
    path = str(tmp_path / "state")
    assert latest_train_state_step(path) is None
    for s in range(5):
        state.step = s
        save_train_state(path, state, keep=2)
    assert sorted(os.listdir(path)) == ["state_3", "state_4"]
    assert latest_train_state_step(path) == 4
    other = init_train_state(models, make_optimizer(optimizer="adafactor"))
    with pytest.raises(KeyError, match="not in the saved state"):
        load_train_state(path, other)


def test_train_cli_micro_cadence_checkpoint_eval_resume(tmp_path, capsys):
    """``cli.train.main`` on the micro stack: accumulation 2 and max_steps
    2 run four micro-batches; a checkpoint every optimizer step (step_1,
    step_2: the trained masters in bf16, ``load_pipeline`` reads them
    back), eval images at step 2, the train states of micro-steps 2 and 4.
    A second run with ``--resume_from_checkpoint`` (and ``--zero1``,
    accepted on one device) continues from micro-step 4 to optimizer step
    3."""
    root = str(tmp_path / "v")
    make_viton_tree(root, n=4, phase="train", size=(32, 32))
    make_viton_tree(root, n=2, phase="test", size=(32, 32))
    out = str(tmp_path / "out")
    common = ["--data_dir", root, "--output_dir", out, "--micro",
              "--width", "32", "--height", "32", "--train_batch_size", "1",
              "--gradient_accumulation_steps", "2",
              "--checkpointing_steps", "1", "--logging_steps", "1",
              "--optimizer", "adamw8bit", "--device", "cpu"]
    state = cli_train.main(common + [
        "--max_steps", "2", "--eval_steps", "2", "--num_inference_steps",
        "2", "--test_batch_size", "2"])
    log = capsys.readouterr().out
    assert state.step == 4 and state.opt_state["inner"]["count"] == 2
    assert "step 1: loss" in log and "step 2: loss" in log
    assert sorted(f for f in os.listdir(out) if f.endswith("_test.jpg")) \
        == ["2_0_test.jpg", "2_1_test.jpg"]
    assert {"step_1", "step_2"} <= set(os.listdir(out))
    assert sorted(os.listdir(os.path.join(out, "state"))) == \
        ["state_2", "state_4"]
    saved = load_pipeline(os.path.join(out, "step_2"), torch.bfloat16,
                          device="cpu", calibrate=False)
    for n, p in saved.unet.named_parameters():
        master = state.trainable["unet"][n].detach()
        assert torch.equal(p.float(), master.bfloat16().float()), n

    state = cli_train.main(common + [
        "--max_steps", "3", "--zero1", "--resume_from_checkpoint",
        os.path.join(out, "state")])
    log = capsys.readouterr().out
    assert "step 4" in log.split("resumed from")[1].splitlines()[0]
    assert state.step == 6 and state.opt_state["inner"]["count"] == 3
    assert "step 3: loss" in log and "step 1: loss" not in log
    assert os.path.isdir(os.path.join(out, "step_3"))
    assert sorted(os.listdir(os.path.join(out, "state"))) == \
        ["state_2", "state_4", "state_6"]
    assert np.isfinite([p.detach().sum().item() for p in flat_params(
        state.trainable).values()]).all()
