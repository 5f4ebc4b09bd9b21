"""The port at full width on the card: the checks that neither the kernel
tests (``tests/test_torch_cuda.py``) nor the benchmark's cells hold.

The cells judge a full-width request, a demo request and a train step
against their fp32 references; the kernel tests hold each kernel against
its plain version at the path's shapes. This file holds the full-width
paths' launch gates (each path launches every kernel it runs and no other,
the conv kernels exactly once a conv site), the inference CLI's batch
loop, the checkpoint round trip, the W8A8 variant path, the ``--tiny``
CLI, the full-width train step's launches, the train CLI with resume, the
one-rank NCCL data-parallel step and the metrics on the card.

Each path's launches, read with its counters zeroed just before its run,
are kept under its name (``torch_card.record``), and ``chip_smoke.py``
prints them in its kernels line.

Marked ``cuda``: each test skips without a card. This file imports no JAX:
``python -m pytest --noconftest -q tests/test_torch_cuda.py
tests/test_torch_cuda_full.py``. The serving tests share one full-width
bf16 stack (random weights from a seed, random biases and norm affines:
``parallel.onecard.random_affine_``, which would show a bias or
scale/shift fault the init's zeros hide); the last of them quantizes its
UNets in place, so it runs last. The training tests share another.
"""

import gc
import json
import math
import os
import shutil
import tempfile

import pytest
import torch

import torch_card as tc

pytestmark = pytest.mark.cuda

# the kernels each path must launch, and no others
BF16_PATH = ("ln_linear", "fused_layer_norm", "gn_spatial_stats", "conv3x3",
             "conv3x3_hblock", "flash_attention_gemm", "gn_apply")
PATH_KERNELS = {
    "bf16": BF16_PATH,
    "cli": BF16_PATH,
    # the CLI batch again, on the stack loaded from its exported tree
    "checkpoint": BF16_PATH,
    # the preprocessing nets, then one try-on request
    "demo": BF16_PATH,
    "variant": ("ln_linear", "fused_layer_norm", "gn_spatial_stats",
                "conv3x3_hblock", "flash_attention_gemm", "ln_linear_i8",
                "cross_attention_small_kv", "conv3x3_padacc", "gn_apply"),
    # read on an H100: the tiny stack at 768x1024 also reaches the bf16
    # path's kernels (the 128-wide level and mid block take ln_linear and
    # flash_attention_gemm, one VAE conv takes conv3x3_hblock) besides
    # flash_attention
    "tiny": BF16_PATH + ("flash_attention",),
    # full-width train steps: the frozen towers and TryonNet's forward
    # (GarmentNet's emit LayerNorm, the VAE encode's large levels), no
    # kernel in a backward
    "train": BF16_PATH,
    "train_adamw8bit": BF16_PATH + ("adam_int8_update", "adam_int8_norm"),
    "dp_nccl": BF16_PATH,
    # cli/train.py --micro at TRAIN_CLI_SIZE, two runs (train, resume)
    "train_cli": ("conv3x3", "gn_spatial_stats", "flash_attention",
                  "gn_apply"),
    # LPIPS's VGG16 on fp32 x
    "lpips": ("conv3x3", "conv3x3_hblock"),
}
# The conv sites of one full-width request (read on an H100): 1999
# conv3x3 launches (every UNet resnet / upsample conv, 30 steps x 2 UNets,
# and the VAE's 128x96 level) and 32 conv3x3_hblock (the VAE's larger
# levels); the variant path sends the conv3x3 sites to conv3x3_padacc. Gated
# exactly, so a kernel predicate that narrows cannot take sites off the
# kernel unseen. The tiny CLI batch: 860 and 1.
CONV_PER_REQUEST = {"conv3x3": 1999, "conv3x3_hblock": 32}
TINY_CONV_PER_BATCH = {"conv3x3": 860, "conv3x3_hblock": 1}
# UNetConfig.tiny: widths (32, 64, 128), transformer depth (0, 1, 2), head
# dim 16, 2 layers a block. The 64-wide level has 4 heads (H*D = 64, not a
# multiple of 128, so not flash_attention_gemm) and 2 down + 3 up blocks a
# UNet; at 768x1024 it holds 64x48 = 3072 tokens, so GarmentNet attends over
# 3072 keys and TryonNet over [own | garment] = 6144, both past the 256-key
# cutoff: 5 + 5 flash_attention launches a denoise step.
TINY_FLASH_PER_STEP = 10
# The demo's preprocessing nets: the conv kernel sites of each, read from
# the code (3x3, stride 1, SAME, Cin and Cout >= 128, W >= 8; a site takes
# conv3x3_hblock from 32 MiB an fp32 image). OpenPose at one scale on its
# 184x144 input: conv2_2, conv3_1-3_4, conv4_1-4_4_CPM and
# conv5_{1,2,3}_CPM of both branches, 1 + 4 + 4 + 6 = 15. SCHP (ATR at
# 512, LIP at 473): the stride-1 undilated bottleneck conv2 of layer2 (3
# of 4 blocks) and layer3 (22 of 23), and the PSP bottleneck: 26 a net.
# DensePose at 1088x800: res3-res5's conv2 (4 + 6 + 3), the 4 FPN outputs,
# the RPN conv on 5 levels, the decoder's 1 + 1 + 2 + 3 and the head's 8
# over 5 chunks of 20: 69, of which the three at P2 (272x200x256, 53 MiB:
# the FPN output, the RPN conv, the decoder's P2 conv) take the hblock site
DEMO_CONV = {"openpose": {"conv3x3": 15}, "atr": {"conv3x3": 26},
             "lip": {"conv3x3": 26},
             "densepose": {"conv3x3": 66, "conv3x3_hblock": 3}}
TRAIN_LEAVES = (
    "unet.conv_in.kernel",
    "unet.down_blocks.1.attentions.0.blocks.0.attn1.to_qkv.kernel",
    "unet.down_blocks.1.attentions.0.blocks.0.ff.proj_in.kernel",
    "unet.conv_out.kernel",
    "resampler.proj_in.kernel")
TRAIN_STEPS = 3
TRAIN8_STEPS = 2
TRAIN_TIMESTEP = 500
# the micro CLI run (cli/train.py --micro) at this image size: the VAE's
# 128-channel convs take #5, GroupNorm #3, TryonNet's 32-wide level (4
# heads of 8) over 192 own + 192 garment keys #9 (GarmentNet's 192 keys
# stay on the plain formula, as in JAX)
TRAIN_CLI_SIZE = (192, 256)
# LPIPS (VGG16, fp32 x) on two 768x1024 images, read from the code: per
# image, the 3x3 sites with Cin and Cout >= 128 are conv2_2, conv3_1-3_3,
# conv4_1-4_3, conv5_1-5_3; those whose fp32 input image reaches 32 MiB
# take conv3x3_hblock: conv2_2 (512x384x128, 96 MiB), conv3_2 and conv3_3
# (256x192x256, 48 MiB); conv3_1 (256x192x128) is 24 MiB
LPIPS_CONV = {"conv3x3": 2 * 7, "conv3x3_hblock": 2 * 3}
# LPIPS impl="cuda" (bf16 operands at the kernel sites) against
# impl="torch" (fp32, TF32 off): relative difference of the distance.
# First readings (an H100 80GB HBM3 at 700 W, random VGG16 from the seed):
# 9.3e-4 on two random images, 7.4e-4 on two served images; the bound at ~3x
LPIPS_TOL = 3e-3
# SSIM / PSNR on the card against the same on the host
METRIC_TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the bf16 path runs with the variant switches off, whatever the
    # caller's environment holds; the variant test turns them on
    saved = {k: os.environ.get(k) for k in ("IDMVTON_CROSS_KERNEL",
                                            "IDMVTON_CONV_PADACC")}
    os.environ.update(dict.fromkeys(saved, "0"))
    yield torch.device("cuda", 0)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def wrappers(dev):
    """Every counted kernel wrapper by name."""
    return tc.counted()


def _zero(wrappers):
    for w in wrappers.values():
        w.launches = 0


def _gate(wrappers, path, exact=None):
    """The launch counts of a run (zeroed just before it): every kernel of
    ``PATH_KERNELS[path]`` launched, no other, and each kernel in
    ``exact`` exactly that many times; kept under ``path``."""
    counts = {name: w.launches for name, w in wrappers.items()}
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    stray = [k for k, n in counts.items() if n and k not in PATH_KERNELS[path]]
    assert not missing and not stray, (path, missing, stray, counts)
    for k, n in (exact or {}).items():
        assert counts[k] == n, (path, k, counts[k], n)
    return tc.record(path, counts)


def _steps_gate(label, readings, tols):
    """``step_readings``' (max rel, mean rel) within ``tols``."""
    for what, (max_tol, mean_tol) in tols.items():
        err, mean_rel = readings[what]
        assert err <= max_tol, (label, what, err)
        assert mean_tol is None or mean_rel <= mean_tol, (label, what,
                                                          mean_rel)


def _cli_run(args, models, built, wrappers, path, exact=None):
    """One batch of 2 synthetic samples through ``cli.infer.run`` (the CLI's
    per-batch loop and its BatchLoader) with ``built`` (the CLI's
    ``cli.infer.build(args, models)``), gated on its launches; uint8
    (2, HEIGHT, WIDTH, 3) images, not constant. Returns (launch counts,
    images)."""
    import numpy as np
    from idmvton_tpu_torch.cli import infer
    from idmvton_tpu_torch.data.datasets import BatchLoader
    pipe, tok1, tok2, gen = built
    loader = BatchLoader(tc.synthetic_batch(tc.BATCH, tc.SEED + 2),
                         args.test_batch_size)
    _zero(wrappers)
    out = list(infer.run(args, pipe, models, loader, tok1, tok2, gen))
    counts = _gate(wrappers, path, exact)
    assert len(out) == 1
    images = out[0][1]
    assert images.dtype == np.uint8
    assert images.shape == (tc.BATCH, tc.HEIGHT, tc.WIDTH, 3)
    assert images.std() > 0
    return counts, images


class TestServing:
    """One full-width bf16 stack; the variant test quantizes it, last."""

    @pytest.fixture(scope="class")
    def stack(self, dev):
        from idmvton_tpu_torch.parallel.onecard import random_affine_
        from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
        with torch.inference_mode():
            models = TryonModels.init(tc.SEED, device=dev,
                                      dtype=torch.bfloat16)
            for i, module in enumerate(models.components().values()):
                random_affine_(module, tc.SEED + 10 + i)
            pipe = TryonPipeline(models)
            gen = torch.Generator(device=dev).manual_seed(tc.SEED + 1)
            inputs = tc.make_inputs(models, dev, gen)
        yield models, pipe, inputs, gen
        # a pipeline and its captured steps reference each other
        del models, pipe, inputs
        gc.collect()
        torch.cuda.empty_cache()

    def _serve(self, stack, wrappers, path, exact):
        """Two requests through ``stepwise_generate`` (every step replayed
        from the captured step, whose launches count as an eager step's;
        the second request finds the first's graph in the cache), each
        gated on its launches, the second's equal to the first's."""
        _, pipe, inputs, gen = stack
        serve = pipe.stepwise_generate(num_steps=tc.STEPS,
                                       guidance_scale=tc.GUIDANCE,
                                       garment_cache="every_step")
        counts = []
        for _ in range(2):
            _zero(wrappers)
            images = serve(gen, **inputs)
            torch.cuda.synchronize()
            assert tuple(images.shape) == (tc.BATCH, tc.HEIGHT, tc.WIDTH, 3)
            assert bool(torch.isfinite(images).all())
            counts.append(_gate(wrappers, path, exact))
        assert counts[0] == counts[1], counts

    def test_request_launches_the_bf16_path(self, dev, stack, wrappers):
        with torch.inference_mode():
            self._serve(stack, wrappers, "bf16", CONV_PER_REQUEST)

    def test_cli_batch_at_full_width(self, dev, stack, wrappers):
        """``cli.infer.run`` over one batch on the stack: the bf16 path's
        kernels with exact conv sites, ``flash_attention`` never."""
        from idmvton_tpu_torch.cli import infer
        models = stack[0]
        args = infer.parse_args(["--data_dir", "-"])
        with torch.inference_mode():
            _cli_run(args, models, infer.build(args, models), wrappers,
                     "cli", dict(CONV_PER_REQUEST, flash_attention=0))

    def test_demo_nets_and_request_launch_exact_convs(self, dev, stack,
                                                      wrappers):
        """``cli.demo``'s ``TryonService`` around the stack (its three fp32
        preprocessing nets from their seeds): each net at the demo's
        full-size shapes launches the conv kernels at ``DEMO_CONV``'s sites
        and nothing else, and two ``tryon`` requests (a seeded 768x1024
        person and garment, the auto mask, 30 steps) each every net's
        sites and ``CONV_PER_REQUEST`` exactly, the second's launches equal
        to the first's."""
        import numpy as np
        from PIL import Image
        from idmvton_tpu_torch.cli import demo
        from idmvton_tpu_torch.models.layers import weights_changed_
        models = stack[0]
        with torch.inference_mode():
            svc = demo.TryonService(demo.parse_args(
                ["--width", str(tc.WIDTH), "--height", str(tc.HEIGHT),
                 "--device", str(dev)]), models=models)
            # the R-CNN's stem at mean-subtracted pixel scale (|x| ~ 50)
            svc.densepose.model.backbone.stem.conv.kernel.div_(50.0)
            weights_changed_(svc.densepose.model)
            rng = np.random.default_rng(tc.SEED + 5)
            person = rng.integers(0, 256, (tc.HEIGHT, tc.WIDTH, 3), np.uint8)
            garment = rng.integers(0, 256, (tc.HEIGHT, tc.WIDTH, 3),
                                   np.uint8)
            small = np.asarray(Image.fromarray(person).resize((384, 512)))
            runs = {"openpose": lambda: svc.openpose.net(torch.from_numpy(
                svc.openpose.prepare(small[:, :, ::-1], 0.5)[0]).to(dev))}
            for name, size in (("atr", 512), ("lip", 473)):
                x = np.ascontiguousarray(svc.parsing.net_input(small, size)[0])
                net = getattr(svc.parsing, name)
                runs[name] = lambda net=net, x=x: net(
                    torch.from_numpy(x).to(dev))
            bgr = np.ascontiguousarray(svc.densepose._preprocess(person)[0])
            runs["densepose"] = lambda: svc.densepose.model(
                torch.from_numpy(bgr[None]).to(dev))
            for name, run in runs.items():
                _zero(wrappers)
                run()
                torch.cuda.synchronize()
                got = {k: w.launches for k, w in wrappers.items()
                       if w.launches}
                assert got == DEMO_CONV[name], (name, got)
            exact = {k: n + sum(c.get(k, 0) for c in DEMO_CONV.values())
                     for k, n in CONV_PER_REQUEST.items()}
            counts = []
            for _ in range(2):
                _zero(wrappers)
                result, masked = svc.tryon(Image.fromarray(person),
                                           Image.fromarray(garment), "shirt",
                                           auto_mask=True, steps=tc.STEPS,
                                           seed=42)
                img, preview = np.asarray(result), np.asarray(masked)
                assert img.shape == preview.shape == (tc.HEIGHT, tc.WIDTH, 3)
                assert img.std() > 0
                counts.append(_gate(wrappers, "demo", exact))
            assert counts[0] == counts[1], counts
        del svc
        gc.collect()

    def test_checkpoint_round_trip(self, dev, stack, wrappers):
        """The stack exported as a bf16 diffusers tree (the port's
        exporters) into a temporary directory, loaded back through the
        CLI's ``load_models`` into a second stack (every parameter equal to
        its source, the load-time softmax calibration run), and the CLI's
        batch served from both: the same uint8 images bit for bit and the
        same launch counts; the second stack freed after."""
        import numpy as np
        from idmvton_tpu_torch.cli import infer
        from idmvton_tpu_torch.pipeline.tryon import COMPONENTS
        from idmvton_tpu_torch.weights.checkpoint import save_diffusers
        models = stack[0]
        exact = dict(CONV_PER_REQUEST, flash_attention=0)
        n_params = sum(p.numel() for m in models.components().values()
                       for p in m.parameters())
        tmp = tempfile.mkdtemp(prefix="idmvton_ckpt_")
        try:
            # every exported tensor in bf16; the Resampler rides in the
            # UNet file
            assert shutil.disk_usage(tmp).free >= 2 * n_params + 2**30
            with torch.inference_mode():
                args = infer.parse_args(["--data_dir", "-"])
                want_counts, want = _cli_run(
                    args, models, infer.build(args, models), wrappers,
                    "cli", exact)
                save_diffusers(tmp, models, dtype=torch.bfloat16)
                args = infer.parse_args(["--data_dir", "-", "--pretrained",
                                         tmp, "--diffusers", "--device",
                                         "cuda"])
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                loaded = infer.load_models(args, torch.bfloat16)
                assert loaded.calibration is not None
                for name in COMPONENTS:
                    src = dict(getattr(models, name).named_parameters())
                    got = dict(getattr(loaded, name).named_parameters())
                    assert src.keys() == got.keys(), name
                    diff = [k for k, p in src.items()
                            if got[k].dtype != p.dtype
                            or not torch.equal(got[k], p)]
                    assert not diff, (name, diff[:5])
                counts, images = _cli_run(
                    args, loaded, infer.build(args, loaded), wrappers,
                    "checkpoint", exact)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        assert np.array_equal(images, want)
        assert counts == want_counts
        # a pipeline and its captured steps reference each other: collect
        # the cycle, or the second stack stays resident
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() <= base + 2**30

    def test_variant_path(self, dev, stack, wrappers, monkeypatch):
        """The opt-in variants of the same path: both UNets quantized for
        W8A8 serving in place (TryonNet's to_qkv and ff.proj_in,
        GarmentNet's ff.proj_in), ``IDMVTON_CROSS_KERNEL=1`` and
        ``IDMVTON_CONV_PADACC=1``: one step ``impl="cuda"`` against
        ``impl="torch"`` within ``STEP_TOLS``, then two requests each
        launching the variant path's kernels, its conv3x3 sites on
        conv3x3_padacc."""
        from idmvton_tpu_torch.models.attention import (
            quantize_unet_linears_int8,
        )
        models, pipe, inputs, gen = stack
        with torch.inference_mode():
            quantize_unet_linears_int8(models.unet)
            quantize_unet_linears_int8(models.garm, attn_qkv=False)
            monkeypatch.setenv("IDMVTON_CROSS_KERNEL", "1")
            monkeypatch.setenv("IDMVTON_CONV_PADACC", "1")
            _steps_gate("variant",
                        tc.step_readings(pipe, inputs, gen, "variant"),
                        tc.STEP_TOLS)
            self._serve(stack, wrappers, "variant", {
                "conv3x3_padacc": CONV_PER_REQUEST["conv3x3"],
                "conv3x3_hblock": CONV_PER_REQUEST["conv3x3_hblock"]})


def test_tiny_cli_batch(dev, wrappers):
    """The inference CLI's ``--tiny`` mode (``cli.infer.load_models``,
    random biases and norm affines) at 768x1024, batch 2, 30 steps: one
    tiny step ``impl="cuda"`` against ``impl="torch"`` within
    ``TINY_STEP_TOLS``, then a batch, whose 64-wide level runs
    ``flash_attention`` (kernel #9) 10 times a step."""
    from idmvton_tpu_torch.cli import infer
    from idmvton_tpu_torch.parallel.onecard import random_affine_
    args = infer.parse_args(["--data_dir", "-", "--tiny", "--device",
                             "cuda"])
    with torch.inference_mode():
        tiny = infer.load_models(args, torch.bfloat16)
        for i, module in enumerate(tiny.components().values()):
            random_affine_(module, tc.SEED + 30 + i)
        built = infer.build(args, tiny)
        gen = torch.Generator(device=dev).manual_seed(tc.SEED + 1)
        _steps_gate("tiny", tc.step_readings(
            built[0], tc.make_inputs(tiny, dev, gen), gen, "tiny"),
            tc.TINY_STEP_TOLS)
        _cli_run(args, tiny, built, wrappers, "tiny",
                 dict(TINY_CONV_PER_BATCH,
                      flash_attention=TINY_FLASH_PER_STEP * tc.STEPS))
    del tiny, built
    gc.collect()


class TestTraining:
    """The full-width ``sdxl_tryon`` TryonNet and the Resampler trained
    (fp32 masters, bf16 compute, remat) beside a stack's frozen towers
    (random biases and norm affines), batch 1 at 768x1024,
    ``SchedulerConfig.train()``."""

    @pytest.fixture(scope="class")
    def train_stack(self, dev):
        from idmvton_tpu_torch.core.config import SchedulerConfig
        from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
        from idmvton_tpu_torch.parallel.onecard import random_affine_
        from idmvton_tpu_torch.pipeline.tryon import TryonModels
        gc.collect()
        torch.cuda.empty_cache()
        models = TryonModels.init(tc.SEED, device=dev, dtype=torch.bfloat16)
        for i, module in enumerate(models.components().values()):
            random_affine_(module, tc.SEED + 10 + i)
        yield models, DDPMScheduler(SchedulerConfig.train())
        del models
        gc.collect()
        torch.cuda.empty_cache()

    @staticmethod
    def _batch(models, dev, gen):
        """One training sample (batch 1, HEIGHT x WIDTH) from the seed,
        with the noise and timestep given."""
        ds = models.vae_cfg.downscale
        img = lambda: (torch.rand(1, tc.HEIGHT, tc.WIDTH, 3, generator=gen,
                                  device=dev) * 2 - 1)
        ids = lambda: torch.randint(0, models.clip_l_cfg.vocab_size, (1, 77),
                                    generator=gen, device=dev)
        mask = torch.zeros(1, tc.HEIGHT, tc.WIDTH, 1, device=dev)
        mask[:, tc.HEIGHT // 5:4 * tc.HEIGHT // 5,
             tc.WIDTH // 6:5 * tc.WIDTH // 6] = 1
        isz = models.vision_cfg.image_size
        return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                    prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                    cloth_ids_g=ids(),
                    ip_pixels=torch.rand(1, isz, isz, 3, generator=gen,
                                         device=dev) * 2 - 1,
                    noise=torch.randn(1, tc.HEIGHT // ds, tc.WIDTH // ds, 4,
                                      generator=gen, device=dev),
                    timesteps=torch.tensor([TRAIN_TIMESTEP], device=dev))

    @staticmethod
    def _sites(models, state, sched, batch, wrappers):
        """The launches of one training forward (the loss under no_grad:
        each frozen tower once, TryonNet once), plus those inside
        TryonNet's resnet blocks and Transformer2Ds (read by hooks), which
        remat runs again in the backward: a train step's exact count, as
        no kernel runs in a backward."""
        from idmvton_tpu_torch.models.resnet import ResnetBlock
        from idmvton_tpu_torch.models.transformer import Transformer2D
        from idmvton_tpu_torch.train.train_step import tryon_loss
        remat = dict.fromkeys(wrappers, 0)
        snap = {}

        def pre(mod, args):
            snap[id(mod)] = {k: w.launches for k, w in wrappers.items()}

        def post(mod, args, res):
            for k, w in wrappers.items():
                remat[k] += w.launches - snap[id(mod)][k]

        hooks = [h for m in models.unet.modules()
                 if isinstance(m, (ResnetBlock, Transformer2D))
                 for h in (m.register_forward_pre_hook(pre),
                           m.register_forward_hook(post))]
        _zero(wrappers)
        try:
            with torch.no_grad():
                tryon_loss(state.trainable, models, sched, batch,
                           impl="cuda", vae_sample=False)
        finally:
            for h in hooks:
                h.remove()
        return {k: w.launches + remat[k] for k, w in wrappers.items()}

    def test_adamw_steps_launch_exact_kernels(self, dev, train_stack,
                                              wrappers):
        """Three adamw steps through ``make_train_step``, each finite,
        moving the masters and launching exactly its forward's kernels plus
        the rematerialized blocks' once more; then two adamw8bit steps
        (the benchmark's optimizer), each launching the same kernels plus
        adamw8bit's norm and update once and counting every block of the
        tree in ``adamw8bit.fused_blocks``."""
        from idmvton_tpu_torch.train.quant_opt import BLOCK
        from idmvton_tpu_torch.train.train_step import (
            flat_params, init_train_state, make_optimizer, make_train_step,
        )
        from idmvton_tpu_torch.utils.profiling import counters
        models, sched = train_stack
        batch = self._batch(models, dev, torch.Generator(
            device=dev).manual_seed(tc.SEED + 40))
        watch = TRAIN_LEAVES[1]
        for optimizer, steps in (("adamw", TRAIN_STEPS),
                                 ("adamw8bit", TRAIN8_STEPS)):
            tx = make_optimizer(optimizer=optimizer)
            state = init_train_state(models, tx)
            exact = self._sites(models, state, sched, batch, wrappers)
            path = "train"
            if optimizer == "adamw8bit":
                exact.update(adam_int8_update=1, adam_int8_norm=1)
                path = "train_adamw8bit"
            tree_blocks = sum(-(-p.numel() // BLOCK)
                              for p in flat_params(state.trainable).values())
            step = make_train_step(models, sched, tx, impl="cuda",
                                   vae_sample=False)
            total = dict.fromkeys(wrappers, 0)
            for i in range(steps):
                before = flat_params(state.trainable)[watch].detach().clone()
                walked = counters().get("adamw8bit.fused_blocks", 0)
                _zero(wrappers)
                state, metrics = step(state, batch)
                loss, gnorm = float(metrics["loss"]), float(
                    metrics["grad_norm"])
                torch.cuda.synchronize()
                walked = counters().get("adamw8bit.fused_blocks", 0) - walked
                got = {k: w.launches for k, w in wrappers.items()}
                moved = float((flat_params(state.trainable)[watch].detach()
                               - before).abs().max())
                assert math.isfinite(loss) and math.isfinite(gnorm), i
                assert moved > 0, (optimizer, i)
                assert got == exact, (optimizer, i, got, exact)
                if optimizer == "adamw8bit":
                    assert walked == tree_blocks, (walked, tree_blocks)
                for k, n in got.items():
                    total[k] += n
            for k, w in wrappers.items():
                w.launches = total[k]
            _gate(wrappers, path)
            del state, step, tx
            gc.collect()
            torch.cuda.empty_cache()

    def test_dp_one_rank_nccl_step_is_bit_exact(self, dev, train_stack,
                                                wrappers):
        """A full-width adamw step (remat, the VAE sample, noise and
        timestep from a seeded generator) without a process group, then
        through the data-parallel path (``make_train_step(mesh=...)``) on a
        one-rank NCCL group made in this process: loss, gradient norm,
        ``TRAIN_LEAVES`` and launch counts equal bit for bit."""
        import torch.distributed as dist
        from idmvton_tpu_torch.parallel.mesh import make_mesh
        from idmvton_tpu_torch.train.train_step import (
            flat_params, init_train_state, make_optimizer, make_train_step,
        )
        models, sched = train_stack
        tx = make_optimizer()
        batch = self._batch(models, dev, torch.Generator(
            device=dev).manual_seed(tc.SEED + 40))
        del batch["noise"], batch["timesteps"]

        def run(mesh):
            state = init_train_state(models, tx)
            step = make_train_step(models, sched, tx, impl="cuda", mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(tc.SEED + 41)
            _zero(wrappers)
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            got = dict(loss=metrics["loss"].clone(),
                       grad_norm=metrics["grad_norm"].clone(),
                       counts={k: w.launches for k, w in wrappers.items()},
                       leaves={k: flat_params(state.trainable)[k].detach()
                               .clone() for k in TRAIN_LEAVES})
            del state, step, metrics
            gc.collect()
            torch.cuda.empty_cache()
            return got

        plain = run(None)
        root = tempfile.mkdtemp(prefix="idmvton_nccl_")
        dist.init_process_group("nccl", init_method=f"file://{root}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            dp = run(make_mesh())
        finally:
            dist.destroy_process_group()
            shutil.rmtree(root, ignore_errors=True)
        for k in ("loss", "grad_norm"):
            assert torch.equal(plain[k], dp[k]), k
        for k in TRAIN_LEAVES:
            assert torch.equal(plain["leaves"][k], dp["leaves"][k]), k
        assert plain["counts"] == dp["counts"]
        for k, w in wrappers.items():
            w.launches = dp["counts"][k]
        _gate(wrappers, "dp_nccl")


def _write_viton_tree(root, phase, n, size, seed):
    """A synthetic VITON-HD split of n seeded samples (images, DensePose
    images, garments, agnostic masks, pairs, tagged captions) at ``size``
    (width, height)."""
    import numpy as np
    from PIL import Image
    w, h = size
    names = [f"{i:05d}_00.jpg" for i in range(n)]
    for sub in ("image", "cloth", "image-densepose", "agnostic-mask"):
        os.makedirs(os.path.join(root, phase, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
        for sub in ("image", "cloth", "image-densepose"):
            img.save(os.path.join(root, phase, sub, name))
        Image.fromarray((rng.rand(h, w) > 0.5).astype(np.uint8) * 255).save(
            os.path.join(root, phase, "agnostic-mask",
                         name.replace(".jpg", "_mask.png")))
    with open(os.path.join(root, f"{phase}_pairs.txt"), "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in zip(names, names[::-1])))
    tagged = {"data": [{"file_name": name, "tag_info": [
        {"tag_name": "item", "tag_category": "t shirts"}]}
        for name in names]}
    with open(os.path.join(root, phase, f"vitonhd_{phase}_tagged.json"),
              "w") as f:
        json.dump(tagged, f)


def test_train_cli_micro_with_resume(dev, wrappers):
    """``cli.train.main --micro`` on the card over a synthetic VITON-HD
    tree in a temporary directory: 2 optimizer steps of 2 micro-batches, a
    checkpoint at each (``step_{n}``: the trained stack; the train state),
    eval images at step 2 (``stepwise_generate``), then
    ``--resume_from_checkpoint`` on to step 3."""
    from idmvton_tpu_torch.cli import train as cli_train
    tmp = tempfile.mkdtemp(prefix="idm_train_cli_")
    try:
        root, out = os.path.join(tmp, "viton"), os.path.join(tmp, "out")
        _write_viton_tree(root, "train", 4, TRAIN_CLI_SIZE, tc.SEED)
        _write_viton_tree(root, "test", 2, TRAIN_CLI_SIZE, tc.SEED)
        w, h = TRAIN_CLI_SIZE
        common = ["--data_dir", root, "--output_dir", out, "--micro",
                  "--width", str(w), "--height", str(h),
                  "--train_batch_size", "1",
                  "--gradient_accumulation_steps", "2",
                  "--checkpointing_steps", "1", "--logging_steps", "1",
                  "--device", "cuda"]
        _zero(wrappers)
        state = cli_train.main(common + ["--max_steps", "2", "--eval_steps",
                                         "2", "--num_inference_steps", "2",
                                         "--test_batch_size", "2"])
        files = set(os.listdir(out))
        states = sorted(os.listdir(os.path.join(out, "state")))
        assert state.step == 4 and states == ["state_2", "state_4"]
        assert {"step_1", "step_2", "2_0_test.jpg", "2_1_test.jpg"} <= files
        state = cli_train.main(common + ["--max_steps", "3",
                                         "--resume_from_checkpoint",
                                         os.path.join(out, "state")])
        assert state.step == 6
        assert os.path.isdir(os.path.join(out, "step_3"))
        _gate(wrappers, "train_cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_lpips_ssim_psnr_on_the_card(dev, wrappers):
    """LPIPS (a random VGG16 from the seed, fp32) between two seeded
    768x1024 images, ``impl="cuda"`` against ``impl="torch"`` within
    ``LPIPS_TOL`` and its conv sites exact (``LPIPS_CONV``); SSIM and PSNR
    on the card against the host; ``PhaseTimer`` and ``trace`` around the
    cuda LPIPS call, whose trace names the conv kernel and the phase."""
    from idmvton_tpu_torch.utils import metrics, profiling
    g = torch.Generator(device=dev).manual_seed(tc.SEED + 6)
    a, b = (torch.rand(1, tc.HEIGHT, tc.WIDTH, 3, generator=g, device=dev)
            * 2 - 1 for _ in range(2))
    net = metrics.init_lpips(tc.SEED + 70, device=dev)
    timer = profiling.PhaseTimer()
    logdir = tempfile.mkdtemp(prefix="idmvton_trace_")
    try:
        with torch.inference_mode():
            _zero(wrappers)
            with profiling.trace(logdir) as prof:
                with timer.phase("lpips_cuda", sync=a):
                    d_cuda = metrics.lpips(net, a, b, impl="cuda")
            _gate(wrappers, "lpips", LPIPS_CONV)
            names = {e.key for e in prof.key_averages()}
            with open(os.path.join(logdir, os.listdir(logdir)[0])) as f:
                kernels = [e.get("name", "")
                           for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel"]
            d_torch = metrics.lpips(net, a, b, impl="torch")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    assert "lpips_cuda" in names
    assert any("conv3x3" in k for k in kernels), len(kernels)
    rel = float((d_cuda - d_torch).abs().max() / d_torch.abs().max())
    assert rel <= LPIPS_TOL, rel
    s_dev, p_dev = float(metrics.ssim(a, b)), float(metrics.psnr(a, b))
    s_host = float(metrics.ssim(a.cpu(), b.cpu()))
    p_host = float(metrics.psnr(a.cpu(), b.cpu()))
    assert abs(s_dev - s_host) <= METRIC_TOL
    assert abs(p_dev - p_host) <= METRIC_TOL * abs(p_host)
    assert "lpips_cuda" in timer.summary()
