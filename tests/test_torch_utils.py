"""The port's utilities (``idmvton_tpu_torch/utils``) against the JAX
package's, on the CPU: SSIM, PSNR, LPIPS and ``convert_lpips`` on shared
numpy inputs and JAX's parameter trees (fp32 both sides, within 1e-5);
``PhaseTimer``'s accounting and ``trace``'s events, in memory and as a
Chrome trace; the golden gate on a fixture directory made from a tiny port
stack (JAX's ``test_fixture_protocol_self_round_trip``)."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from idmvton_tpu.utils import metrics as jm
from idmvton_tpu_torch.utils import metrics, profiling
from idmvton_tpu_torch.weights.from_jax import load_module_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs at tiny shapes, where torch's intra-op threads
    only contend with the other test workers for the CPU (the spawned
    ranks take one thread each too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(shape, seed, noise):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape).astype(np.float32),
                -1, 1)
    return a, b


@pytest.mark.parametrize("shape,noise", [((1, 32, 32, 3), 0.2),
                                         ((2, 24, 40, 1), 0.5),
                                         ((1, 16, 16, 3), 0.0)])
def test_ssim_psnr_match_jax(shape, noise):
    """SSIM and PSNR against JAX's within 1e-5 (PSNR relative)."""
    a, b = _images(shape, 0, noise)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)),
                               float(jm.ssim(a, b)), atol=1e-5)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jm.psnr(a, b)), rtol=1e-5)


@pytest.fixture(scope="module")
def lpips_tree():
    return jax.tree.map(np.asarray, jm.init_lpips(jax.random.PRNGKey(0)))


def test_lpips_matches_jax(lpips_tree):
    """LPIPS of JAX's random tree, loaded into the port's ``LPIPS``, on
    (2, 32, 32, 3) images: within 1e-5 of JAX's (relative), 0 on equal
    images."""
    net = load_module_params(metrics.LPIPS(device="cpu"), lpips_tree)
    a, b = _images((2, 32, 32, 3), 1, 0.3)
    got = metrics.lpips(net, torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jm.lpips(lpips_tree, a, b))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    same = metrics.lpips(net, torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_convert_lpips_matches_jax():
    """``convert_lpips`` of torchvision / lpips state dicts (OIHW): the
    same HWIO leaves as JAX's converter, and the same distances."""
    rng = np.random.default_rng(2)
    vgg_sd, lin_sd, in_ch, taps = {}, {}, 3, []
    chans = [v for v in metrics._VGG_CFG if v != "M"]
    for i, (li, v) in enumerate(zip(metrics._expand_vgg_layer_ids(), chans)):
        vgg_sd[f"features.{li}.weight"] = (
            0.05 * rng.standard_normal((v, in_ch, 3, 3))).astype(np.float32)
        vgg_sd[f"features.{li}.bias"] = (
            0.05 * rng.standard_normal(v)).astype(np.float32)
        if i in metrics._TAP_LAYERS:
            taps.append(v)
        in_ch = v
    for i, ch in enumerate(taps):
        lin_sd[f"lin{i}.model.1.weight"] = (
            0.1 * rng.uniform(size=(1, ch, 1, 1))).astype(np.float32)
    assert metrics._expand_vgg_layer_ids() == jm._expand_vgg_layer_ids()
    want = jax.tree.map(np.asarray, jm.convert_lpips(vgg_sd, lin_sd))
    net = metrics.convert_lpips(vgg_sd, lin_sd, device="cpu")
    for part in ("vgg", "lin"):
        for mod, leaf in zip(getattr(net, part), want[part]):
            for k, v in leaf.items():
                np.testing.assert_array_equal(getattr(mod, k).numpy(), v)
    a, b = _images((1, 32, 32, 3), 3, 0.3)
    np.testing.assert_allclose(
        metrics.lpips(net, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.lpips(want, a, b)), rtol=1e-5)


def test_phase_timer_accounting():
    """Totals and counts per phase, the summary ordered by total in JAX's
    format; ``sync`` takes a tensor tree."""
    timer = profiling.PhaseTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("a", sync={"x": [x]}):
            pass
    with timer.phase("b", sync=x):
        torch.ones(256, 256).sum()
    timer.totals["b"] += 10.0
    assert timer.counts == {"a": 3, "b": 1}
    lines = timer.summary().splitlines()
    assert lines[0].startswith("b: ") and ", 1x, " in lines[0]
    assert lines[1].startswith("a: ") and ", 3x, " in lines[1]
    assert lines[1].endswith("s avg")


def test_trace_writes_chrome_trace(tmp_path):
    """``trace`` given a directory writes a Chrome trace holding a span's
    range."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("idmvton_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "idmvton_phase" for e in events)


def test_trace_keeps_events_in_memory(tmp_path, monkeypatch):
    """Without a directory ``trace`` writes nothing; the span's range and
    the op under it are in the profiler's events."""
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as prof:
        with profiling.span("idmvton_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(tmp_path) == []
    names = {e.key for e in prof.key_averages()}
    assert {"idmvton_phase", "aten::mm"} <= names


def test_golden_gate_self_round_trip(tmp_path):
    """The gate on a fixture directory written by
    ``scripts/dump_golden_fixtures.write_fixture_dir`` from a tiny fp32
    port stack acting as the reference (its ``save_pipeline`` checkpoint,
    its own images on injected noises): SSIM above 0.999."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
    from idmvton_tpu_torch.utils.golden import run_golden_gate
    from idmvton_tpu_torch.weights.checkpoint import save_pipeline
    spec = importlib.util.spec_from_file_location(
        "dump_golden_fixtures",
        os.path.join(ROOT, "scripts", "dump_golden_fixtures.py"))
    dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dump)

    models = TryonModels.init(0, tiny=True, device="cpu", dtype=torch.float32)
    b, h, w, steps = 1, 32, 32, 3
    rng = np.random.default_rng(0)
    img = lambda: rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    ids = lambda: rng.integers(0, models.clip_l_cfg.vocab_size, (b, 7))
    isz = models.vision_cfg.image_size
    inputs = dict(person=img(), pose=img(), cloth=img(),
                  mask=(rng.uniform(size=(b, h, w, 1)) > 0.5).astype(
                      np.float32),
                  prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                  neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                  ip_pixels=rng.uniform(-1, 1, (b, isz, isz, 3)).astype(
                      np.float32))
    f = models.vae_cfg.downscale
    lat = (b, h // f, w // f, 4)
    init_noise = rng.standard_normal(lat).astype(np.float32)
    step_noise = rng.standard_normal((steps,) + lat).astype(np.float32)
    fn = TryonPipeline(models).jit_generate(num_steps=steps,
                                            vae_sample=False)
    expected = fn(torch.Generator().manual_seed(42),
                  **{k: torch.from_numpy(v) for k, v in inputs.items()},
                  init_noise=torch.from_numpy(init_noise),
                  step_noise=torch.from_numpy(step_noise))
    out = str(tmp_path / "golden")
    dump.write_fixture_dir(out, inputs=inputs, init_noise=init_noise,
                           step_noise=step_noise,
                           images=expected.float().numpy(), num_steps=steps,
                           guidance_scale=2.0, seed=42, diffusers=False,
                           dtype="float32")
    save_pipeline(os.path.join(out, "models"), models)
    report = run_golden_gate(out, device="cpu")
    assert report["passed"] and report["ssim"] > 0.999, report
