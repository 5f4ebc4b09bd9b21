#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch port (idmvton_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for CUDA;
it imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   set the TF32 flags off (fp32 products in full fp32 on both sides);
2. build the kernels from ``idmvton_tpu_torch/ops/csrc`` with nvcc;
3. hold each of the twelve kernel entry points against its plain PyTorch
   version at the shapes its path gives it (phase 14's TP and SP ranks'
   too; bf16; the conv kernels also on
   the fp32 decode's and the demo's preprocessing nets' fp32
   activations), and time the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (``library_ms``; the port never makes it), and beside #1, #8 and
   #11 a yardstick that computes part of the function or the same in
   several calls (``layer_norm+mm_ms``, ``int_mm_ms``: the s8 GEMM alone on
   the kernel's codes, ``sdpa_sum_ms``: two SDPA calls summed), beside the
   kernel's bound (its bytes over the card's memory rate or its operations
   over the peak rate of their type, the larger) and, in the log of the
   attention kernels, their exp floor (logits over ``EXP_RATE``); each
   kernel and
   library call is timed eagerly and as 10 launches in a CUDA graph
   (``graph_ms``, ``library_graph_ms``: the device alone);
4. give the full-width stack random biases and norm affines from the seed
   (the init zeroes them, which would hide a bias or scale/shift fault;
   rounded through bf16, as a bf16 load of any checkpoint rounds them),
   then one full-width denoise step (GarmentNet, TryonNet, CFG, DDPM step)
   with ``impl="cuda"`` against ``impl="torch"`` on the same inputs, and
   one more with ``IDMVTON_FLASH_FIXED_SHIFT=0`` (the attention kernel's
   online softmax at every site);
   then the captured step (``pipeline/graph.py``): one step eager
   (``denoise_step``) against the same step replayed from its CUDA graph,
   bit for bit (or, if two eager runs differ, within their difference);
   two requests through ``jit_generate`` against two through eager
   ``generate`` from generators of one seed, images bit for bit and launch
   counts equal; the replayed step's wall time against its device time
   over 5 replays, then 5 eager steps (CUDA events);
5. serve 2 requests through ``TryonPipeline.stepwise_generate`` at
   768x1024, batch 2, 30 steps, CFG 2.0, garment_cache="every_step", on
   the full SDXL try-on stack with seeded random weights (the bf16 path;
   on the card ``stepwise_generate``, ``jit_generate`` and the CLI replay
   every step from the captured step, whose launches count as an eager
   step's);
   then one fp32 VAE decode (``VAEConfig.force_upcast``) of a full-width
   latent through the conv and GroupNorm kernels, every conv
   site on a kernel, against the bf16 decode;
6. the inference CLI's batch loop (``cli.infer.run``, with its
   BatchLoader, tokenizers and ip_pixels resize) over one in-memory batch
   of 2 synthetic VITON-HD samples on the same stack: uint8 images, the
   bf16 path's kernels and ``flash_attention`` never;
   6b. the demo server's service (``cli.demo.TryonService``) around the
   same stack, its three fp32 preprocessing nets from their seeds:
   OpenPose, SCHP (ATR, LIP) and the DensePose R-CNN each with
   ``impl="cuda"`` against ``impl="torch"`` at the demo's full-size shapes
   (maps, logits and label agreement; FPN features, pre-NMS RPN scores,
   detections matched as sets and their fine labels; each net's conv sites
   on the kernels exactly, ``DEMO_CONV``), then two requests through
   ``TryonService.tryon`` (a seeded 768x1024 person and garment, the auto
   mask, 30 steps, seed 42, "shirt") with each stage's seconds, gated on
   the images' size and on exact conv launches;
7. checkpoint IO at full width: export the stack of phases 4-6 through
   the port's exporters (``weights.checkpoint.save_diffusers``) as a bf16
   diffusers tree into a temporary directory (its size and the free space
   printed first; too little space fails), load it with
   ``cli.infer.load_models`` on ``--pretrained DIR --diffusers --device
   cuda`` into a second stack beside the first (every parameter
   ``torch.equal`` to its source; the load-time softmax calibration's
   report printed), then ``cli.infer.run`` on phase 6's batch and seed:
   the uint8 images equal phase 6's bit for bit, with the same launch
   counts; export and load seconds, the tree's bytes, the peak host RSS
   during the load and the card's peak allocated memory printed; the
   second stack and the tree are freed (the load's stages alone, a cold
   page cache and a fresh process's calibration are timed by
   ``python3 -m idmvton_tpu_torch.weights.load_profile``);
8. the opt-in variants of the same path: quantize both UNets for W8A8
   serving (``IDMVTON_GEMM_INT8=2`` in the JAX bench: TryonNet's to_qkv and
   ff.proj_in, GarmentNet's ff.proj_in), set ``IDMVTON_CROSS_KERNEL=1`` and
   ``IDMVTON_CONV_PADACC=1``, hold one full-width step with ``impl="cuda"``
   against ``impl="torch"``, and serve 2 more requests (the variant path);
9. the CLI's ``--tiny`` mode (``cli.infer.load_models``, random biases and
   norm affines, then ``run`` at
   768x1024, batch 2, 30 steps): one tiny step with ``impl="cuda"``
   against ``impl="torch"``, then a batch, whose 64-wide level runs
   ``flash_attention`` (kernel #9) 10 times a step;
   the launch counters, zeroed before each serving phase and read after
   it, show that each path launched every kernel it runs and no other, and
   each conv kernel exactly once a conv site of the path;
10. training, outside inference mode: (a) each kernel with an autograd
   Function (``ops.autograd``: #1-#9, #11) at its phase-3 shapes, the
   gradient of every input through the Function against plain autograd's
   (``backward`` in the kernels line, forward + backward timed both
   ways); (b) the full-width ``sdxl_tryon`` TryonNet and the Resampler as
   fp32 masters (adamw, bf16 compute, remat) beside the phase-4 stack's
   frozen towers with random biases and norm affines, batch 1 at
   768x1024, ``SchedulerConfig.train()``: one step's loss, gradient norm,
   noise prediction and five leaves' gradients ``impl="cuda"`` against
   ``impl="torch"`` (``TRAIN_TOLS``), then three adamw steps through
   ``make_train_step`` on the card: each finite, moving the masters,
   launching exactly its forward's kernels plus the rematerialized blocks'
   once more (no kernel in a backward; #9-#11 never), the forward before
   steps 2 and 3 held cuda against torch on the updated masters; seconds a
   step, img/s and peak memory beside the card's name and power limit;
   then two adamw8bit steps through ``make_train_step`` (the benchmark's
   optimizer), each launching the same kernels plus adamw8bit's norm and
   update once (#12), the update walking every block of the tree
   (``adamw8bit.fused_blocks``); (c) ``cli.train.main --micro`` on a synthetic VITON-HD tree: 2
   optimizer steps of 2 micro-batches, checkpoints, eval images, then a
   resumed run to step 3; (d) adamw8bit's kernel (``ops/csrc/adam_int8.cu``)
   on the full trainable tree (TryonNet + Resampler: 2.991 B fp32 masters
   in 1,591 leaves, their gradients and 8-bit moments): one step against
   the plain per-leaf update (``ADAM_TOLS``, at ``ADAM_LR`` and
   ``ADAM_WD``), then the norm, the update and the whole optimizer phase
   timed eagerly and in a CUDA graph beside the bound
   (``adam_int8_bytes``) and the plain update's time, for the kernels
   line;
11. DensePose detection training (``preprocess/densepose/train.py``) at
   the served config, B = 2 at 800x1088 from a seed (3 persons an image,
   128 points, 56x56 masks): one step's losses and four leaves' gradients
   ``impl="cuda"`` against ``impl="torch"`` on the same uniforms and
   proposals (``DP_TRAIN_TOLS``), the sampled sets identical,
   ``nms_topk`` alone over the 217,413 boxes of all anchors, then three
   masked SGD steps, each finite with exactly ``DP_TRAIN_CONV`` launches
   of #5 / #6, the frozen leaves bitwise unchanged; ms a step and peak
   memory;
12. ``Face`` at 384 and ``Hand`` at its four scales
   (``preprocess/openpose_extra.py``) on seeded crops: heatmaps ``cuda``
   against ``torch`` (``FACE_HAND_TOLS``), the peaks, exact launches a
   call (``FACE_CONV``, ``HAND_CONV``);
13. ``inference_on_dataset`` with ``DensePose.detect`` over three images,
   scored by the host runtime (``runtime/native.py``, built with g++ from
   the checkout): 12 finite stats;
14. the parallel paths and the utilities (``parallel/``, ``utils/``):
   (a) phase 10's full-width adamw step through the data-parallel path on
   a one-rank NCCL group made in this process, equal to the step without
   a group bit for bit (loss, gradient norm, five leaves, launches); (b)
   two ranks sharing the card (``parallel/onecard.py``; NCCL probed first,
   gloo with CUDA tensors where it refuses two ranks on one device): one
   full-width denoise step under TP=2 and under SP=2 against the
   single-process step (``PARALLEL_TOLS``) with each rank's launches
   exact (``PARALLEL_STEP``), the micro stack's dp=2 adamw step
   replicated and with ZeRO-1, and its adamw8bit step with ZeRO-1 (the
   kernel on each rank's blocks), against one rank (``MICRO_TOL``, ZeRO-1's
   moments at most half a rank), ViT-H in 2 pipeline stages x 2 microbatches equal to the
   sequential forward bit for bit; (c) LPIPS, SSIM and PSNR on phase 5's
   two images (LPIPS cuda against torch, ``LPIPS_CONV`` exact), a
   ``PhaseTimer`` and a ``trace`` around the cuda LPIPS call. One card
   shows the parallel paths' correctness, not their scaling;
15. print a JSON line with each kernel's result, then the device line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HEIGHT, WIDTH, BATCH, STEPS, GUIDANCE = 1024, 768, 2, 30, 2.0
BF16_TOL = 2e-2   # max |kernel - plain| / max |plain|: a few bf16 ulps
# GroupNorm sums: fp32 over up to 786432 rows in another order (pass 2 adds
# up to 3072 block partials in sequence): max |err| / max |sum of squares|
GN_TOL = 5e-5
# One full denoise step, impl="cuda" against impl="torch", on both paths:
# (max rel, mean rel) bounds, max rel = max |diff| / max |torch| and mean
# rel = mean |diff| / mean |torch|, on the guided noise prediction (both
# UNets and CFG, before the scheduler step) and on the stepped latent. Near
# t = T the noise prediction enters the latent with a weight of about 1%, so
# the latent alone would hide a UNet fault. The two impls round at different
# places (~140 kernel sites) and the differences random-walk; on the variant
# path W8A8 (kernels) and weight-only int8 (plain) also differ in math, yet
# read the same: noise prediction max rel 3.2e-2 to 4.0e-2, mean rel
# 1.67e-2 to 1.75e-2 on an H100 on the init's parameters, max rel 3.2e-2 to
# 3.5e-2, mean rel 1.85e-2 to 1.96e-2 with random biases and norm affines
# (phase 4). The max is set by a few outliers and hardly moves under a
# fault; the mean bound caught a 5% output error of the W8A8 kernel at every
# site (2.77e-2) and a lost IP branch (0.23) on the init's parameters.
STEP_TOLS = {"noise_pred": (8e-2, 2.5e-2), "latent": (5e-2, None)}
# The tiny step (UNetConfig.tiny at 768x1024), impl="cuda" against "torch",
# with random biases and norm affines (phase 8) reads mean rel 2.97e-2 to
# 3.00e-2 and max rel 3.3e-2 to 4.4e-2 on the noise prediction (latent
# ~7e-3) on an H100 (the init's zero biases and unit norms read mean rel
# 2.1e-2 to 2.3e-2). scripts/torch_tiny_step_probe.py planted faults under
# the same affines: the ln_linear bias dropped at its 24 sites read mean
# rel 6.95e-2 (max 8.3e-2), the LayerNorm shift dropped at its 60 sites
# 8.64e-2 (8.6e-2), the garment KV dropped 0.417 (0.36); the
# flash_attention output x1.05 3.20e-2 and x1.02 3.03e-2. The bounds sit at
# 1.33x the clean mean and 1.36x the largest clean max: they catch the
# bias, shift and KV faults and no longer a 5% output error at kernel #9,
# which reads within 8% of a clean run.
TINY_STEP_TOLS = {"noise_pred": (6e-2, 4e-2), "latent": (5e-2, None)}
# UNetConfig.tiny: widths (32, 64, 128), transformer depth (0, 1, 2), head
# dim 16, 2 layers a block. The 64-wide level has 4 heads (H*D = 64, not a
# multiple of 128, so not flash_attention_gemm) and 2 down + 3 up blocks a
# UNet; at 768x1024 it holds 64x48 = 3072 tokens, so GarmentNet attends over
# 3072 keys and TryonNet over [own | garment] = 6144, both past the 256-key
# cutoff: 5 + 5 flash_attention launches a denoise step. The 128-wide level
# and the mid block (8 heads, H*D = 128) take flash_attention_gemm.
TINY_FLASH_PER_STEP = 10
# The conv sites of one full-width request (read on an H100, PR 1): 1999
# conv3x3 launches (every UNet resnet / upsample conv, 30 steps x 2 UNets,
# and the VAE's 128x96 level) and 32 conv3x3_hblock (the VAE's larger
# levels); the variant path sends the conv3x3 sites to conv3x3_padacc. Gated
# exactly, so a kernel predicate that narrows cannot take sites off the
# kernel unseen. The tiny CLI batch (read on an H100, PR 3): 860 and 1.
CONV_PER_REQUEST = {"conv3x3": 1999, "conv3x3_hblock": 32}
TINY_CONV_PER_BATCH = {"conv3x3": 860, "conv3x3_hblock": 1}
# The fp32 decode's mean rel (mean |fp32 - bf16| / mean |bf16|) against the
# bf16 decode of the same latent: the two differ by bf16 rounding at every
# layer of the decoder, so the bound is loose; it catches a kernel that
# drops or garbles the fp32 path, not a few ulps
DECODE_FP32_MEAN_REL = 5e-2
# the kernels each serving path must launch, and no others
BF16_PATH = ("ln_linear", "fused_layer_norm", "gn_spatial_stats", "conv3x3",
             "conv3x3_hblock", "flash_attention_gemm", "gn_apply")
PATH_KERNELS = {
    "bf16": BF16_PATH,
    "cli": BF16_PATH,
    # phase 6's batch again, on the stack loaded from its exported tree
    "checkpoint": BF16_PATH,
    "variant": ("ln_linear", "fused_layer_norm", "gn_spatial_stats",
                "conv3x3_hblock", "flash_attention_gemm", "ln_linear_i8",
                "cross_attention_small_kv", "conv3x3_padacc", "gn_apply"),
    # read on an H100: the tiny stack at 768x1024 also reaches all six (the
    # 128-wide level and mid block take ln_linear and flash_attention_gemm,
    # one VAE conv takes conv3x3_hblock) besides flash_attention
    "tiny": BF16_PATH + ("flash_attention",),
    "decode_fp32": ("conv3x3", "conv3x3_hblock", "gn_spatial_stats",
                    "gn_apply"),
    # the demo request: the preprocessing nets, then one try-on request
    "demo": BF16_PATH,
    # two jit_generate requests, every step replayed from the captured step
    "graph": BF16_PATH,
    # three full-width train steps: the frozen towers and TryonNet's forward
    # (GarmentNet's emit LayerNorm, the VAE encode's large levels), no
    # kernel in a backward
    "train": BF16_PATH,
    # two adamw8bit steps of phase 10's stack: adamw8bit's norm and update
    "train_adamw8bit": BF16_PATH + ("adam_int8_update", "adam_int8_norm"),
    # cli/train.py --micro at TRAIN_CLI_SIZE, two runs (train, resume)
    "train_cli": ("conv3x3", "gn_spatial_stats", "flash_attention",
                  "gn_apply"),
    # the fp32 preprocessing nets: the DensePose R-CNN's train steps, Face
    # and Hand, DensePose.detect under inference_on_dataset
    "densepose_train": ("conv3x3", "conv3x3_hblock"),
    "face_hand": ("conv3x3", "conv3x3_hblock"),
    "evaluate": ("conv3x3", "conv3x3_hblock"),
    # phase 14: the full-width adamw step through the data-parallel path on
    # a one-rank NCCL group (phase 10's kernels); LPIPS's VGG16 on fp32 x
    "dp_nccl": BF16_PATH,
    "lpips": ("conv3x3", "conv3x3_hblock"),
}
# the replayed step's timing (phase 4): steps a reading
TIMED_STEPS = 5
# The demo (phase 6b): the conv kernel sites of each preprocessing net, read
# from the code (3x3, stride 1, SAME, Cin and Cout >= 128, W >= 8; a site
# takes conv3x3_hblock from 32 MiB an fp32 image). OpenPose at one scale on
# its 184x144 input: conv2_2, conv3_1-3_4, conv4_1-4_4_CPM and
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
# the nets' impl="cuda" against impl="torch" (fp32 plain, TF32 off) on the
# same arrays: bf16 operands at every kernel site against full fp32, so the
# outputs differ by bf16 rounding random-walked through 15-69 sites. Each
# bound: (max rel, mean rel) on the continuous outputs, and the agreement
# rates of the discrete ones from below: SCHP's argmax labels; DensePose's
# detections matched as sets (the share of the larger run's) and the fine
# labels of the matched ones. First reading (an H100 80GB HBM3 at 700 W):
# OpenPose paf 7.2e-3 / 6.3e-3, heat 1.74e-2 / 1.10e-2; SCHP ATR 5.6e-3 /
# 3.3e-3 (labels 0.9981), LIP 4.3e-3 / 2.6e-3 (0.9998); FPN P2-P6 at most
# 5.0e-3 / 3.5e-3; pre-NMS RPN scores 3.4e-3 / 1.7e-3; the next run: the
# same, and 88 of 100 detections matched (near-ties among the random head's
# saturated scores reorder the rest), their fine labels 0.9979. The bounds
# sit at about 3x the continuous readings, the rates below them: 0.99 for
# labels, 0.7 for the detections.
DEMO_TOLS = {"openpose": (5e-2, 3e-2), "schp": (2e-2, 1e-2),
             "fpn": (1.5e-2, 1e-2), "rpn_scores": (1e-2, 5e-3),
             "labels": 0.99, "boxes": 0.7, "fine_labels": 0.99}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 10) -> float:
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10, reps: int = 3) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times (no host pace between launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (iters * reps)


def random_affine_(module, seed: int):
    """Overwrites every bias (of the layers that have one) with N(0,
    0.1^2) and every norm's scale with 1 + N(0, 0.1^2), from
    ``seed``, in place (tests/test_torch_affine.py's ``random_affine`` on
    the modules: this script imports nothing of tests/). Each draw is
    rounded through bf16: the fp32 norm parameters then hold what a bf16
    load of any checkpoint gives them (the loader rounds norms through the
    load type), so the bf16 tree of phase 7 holds the stack exactly. The
    port's ``parallel.onecard.random_affine_``, which the two-rank phase's
    ranks run."""
    from idmvton_tpu_torch.parallel import onecard
    onecard.random_affine_(module, seed)


def errors(got, want):
    """(max |got - want|, that over max |want|); inf when got is not
    finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-6)


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): HBM bytes/s and operations/s by type. A case's bound is the
# larger of its bytes (each input read once, the output written once) over
# HBM_BPS and its operations over the peak of their type.
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# The special-function units' exponentials a second (132 SMs x 16 a clock
# at ~1.83 GHz; the FlashAttention-3 paper's 3.9 TFLOPS): an attention
# case's exp floor is its logits (one exponential each) over this rate, a
# figure beside its bound, not part of it.
EXP_RATE = 3.9e12


def kernel_cases(dev):
    """(name, source, replaces, library, [case]) at the shapes the serving
    and tiny paths give each kernel. A case is a dict: ``label``, ``kern``,
    ``plain``, ``ins`` (the input tensors, for the bytes), ``ops`` and
    ``rate`` (its operations and their type), ``tol`` ("bf16" or "gn"),
    ``library`` (one PyTorch call computing the same function on the same
    inputs, timed beside the kernel and used nowhere in the port, or None)
    and optionally ``vs`` (another function to hold the kernel against
    without a gate), ``time`` (one to time beside it), ``exps`` (the
    exponentials an attention kernel takes: its logits, for the exp
    floor) or ``vjp`` (the kernel's autograd entry, its inputs and
    keywords, and the plain function whose autograd it is held to: the
    train phase's gradient check)."""
    import torch
    import torch.nn.functional as F
    from idmvton_tpu_torch.ops import autograd as AG
    from idmvton_tpu_torch.ops import cuda_attention as A
    from idmvton_tpu_torch.ops import cuda_conv as CV
    from idmvton_tpu_torch.ops import cuda_norm as N
    from idmvton_tpu_torch.ops.quant import quantize_kernel_int8

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def case(label, kern, plain, ins, ops, rate="bf16", tol="bf16",
             library=None, **extra):
        return dict(label=label, kern=kern, plain=plain, ins=ins, ops=ops,
                    rate=rate, tol=tol, library=library, **extra)

    def bhsd(t):
        return t.transpose(1, 2).contiguous()

    def ln_case(m_shape, c, n, geglu, bias):
        """As the path calls it: to_qkv / to_q have no bias, ff.proj_in a
        bf16 one (which the kernel widens). Beside it, the two-call
        yardstick F.layer_norm then torch.mm (cuBLAS): no one call fuses
        them."""
        x = rn(*m_shape, c)
        gam, bet = rn(c, dtype=torch.float32) * 0.1 + 1, rn(c, dtype=torch.float32) * 0.1
        w = rn(c, n * (2 if geglu else 1), scale=c ** -0.5)
        b = rn(w.shape[1]) * 0.1 if bias else None
        g16, b16, x2 = gam.to(x.dtype), bet.to(x.dtype), x.reshape(-1, c)
        return case(f"x{tuple(m_shape) + (c,)} w{tuple(w.shape)}"
                    f"{' geglu' if geglu else ''}",
                    lambda: N.ln_linear(x, gam, bet, w, b, geglu=geglu),
                    lambda: N.ln_linear_torch(x, gam, bet, w, b, geglu=geglu),
                    [x, gam, bet, w, b], 2 * x.numel() * w.shape[1],
                    time=("layer_norm+mm", lambda: torch.mm(
                        F.layer_norm(x2, (c,), g16, b16, 1e-5), w)),
                    vjp=(AG.ln_linear, (x, gam, bet, w, b),
                         {"geglu": geglu}, N.ln_linear_torch))

    def ln_i8_case(m_shape, c, n, geglu, bias):
        """As the variant path calls it: to_qkv has no bias, ff.proj_in a
        bf16 one. Beside it, the GEMM alone on the kernel's own codes,
        torch._int_mm (cuBLASLt s8 x s8 -> s32): a yardstick, not the same
        function (no LayerNorm, quantization or epilogue)."""
        x = rn(*m_shape, c)
        gam, bet = rn(c, dtype=torch.float32) * 0.1 + 1, rn(c, dtype=torch.float32) * 0.1
        w = rn(c, n * (2 if geglu else 1), scale=c ** -0.5)
        w_i8, w_scale = quantize_kernel_int8(w)
        b = rn(w.shape[1]) * 0.1 if bias else None
        codes, _ = N.ln_quant_i8(x, gam, bet)
        return case(f"x{tuple(m_shape) + (c,)} w_i8{tuple(w.shape)}"
                    f"{' geglu' if geglu else ''}",
                    lambda: N.ln_linear_i8(x, gam, bet, w_i8, w_scale, b,
                                           geglu=geglu),
                    lambda: N.ln_linear_i8_torch(x, gam, bet, w_i8, w_scale,
                                                 b, geglu=geglu),
                    [x, gam, bet, w_i8, w_scale, b],
                    2 * x.numel() * w.shape[1], rate="int8",
                    vs=("bf16 ln_linear_torch",
                        lambda: N.ln_linear_torch(x, gam, bet, w, b,
                                                  geglu=geglu)),
                    time=("int_mm", lambda: torch._int_mm(codes, w_i8)),
                    # JAX's VJP: the product on the dequantized weight
                    vjp=(AG.ln_linear_i8, (x, gam, bet, w_i8, w_scale, b),
                         {"geglu": geglu},
                         lambda x_, g_, be_, wi, ws, b_, geglu: (
                             N.ln_linear_torch(x_, g_, be_, (
                                 wi.float() * ws[None]).to(x_.dtype), b_,
                                 geglu=geglu)), (0, 1, 2, 5)))

    def cross_case(b, n, heads, ip):
        """Beside it, the two-call yardstick: F.scaled_dot_product_attention
        of each branch on head-major copies, summed in fp32 (one call
        without an IP branch)."""
        hd = heads * 64
        q, kv = rn(b, n, hd), rn(b, 77, 2 * hd)
        kv_ip = rn(b, 16, 2 * hd) if ip else None
        ctx = 77 + (16 if ip else 0)

        def heads_major(t, s, i):
            return bhsd(t[..., i * hd:(i + 1) * hd].reshape(b, s, heads, 64))

        qt = bhsd(q.reshape(b, n, heads, 64))
        kt, vt = heads_major(kv, 77, 0), heads_major(kv, 77, 1)
        if ip:
            kit, vit = heads_major(kv_ip, 16, 0), heads_major(kv_ip, 16, 1)
            two = lambda: (F.scaled_dot_product_attention(qt, kt, vt).float()
                           + F.scaled_dot_product_attention(qt, kit,
                                                            vit).float())
        else:
            two = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        return case(f"q{(b, n, hd)} heads {heads} kv{tuple(kv.shape)}"
                    f"{f' kv_ip{tuple(kv_ip.shape)}' if ip else ''}",
                    lambda: A.cross_attention_small_kv(q, kv, kv_ip,
                                                       heads=heads),
                    lambda: A.cross_attention_small_kv_torch(q, kv, kv_ip,
                                                             heads=heads),
                    [q, kv, kv_ip], 4 * b * n * hd * ctx,
                    exps=b * heads * n * ctx, time=("sdpa_sum", two),
                    vjp=(AG.cross_attention_small_kv, (q, kv, kv_ip),
                         {"heads": heads},
                         A.cross_attention_small_kv_torch))

    def lnorm_case(shape):
        x = rn(*shape)
        s, b = rn(shape[-1], dtype=torch.float32), rn(shape[-1], dtype=torch.float32)
        s16, b16 = s.to(x.dtype), b.to(x.dtype)
        return case(f"x{shape}", lambda: N.fused_layer_norm(x, s, b),
                    lambda: N.layer_norm_torch(x, s, b), [x, s, b],
                    8 * x.numel(), rate="fp32",
                    library=lambda: F.layer_norm(x, (shape[-1],), s16, b16,
                                                 1e-5),
                    vjp=(AG.fused_layer_norm, (x, s, b), {},
                         N.layer_norm_torch))

    def gn_case(shape):
        x = rn(*shape) + 0.2
        return case(f"x{shape}", lambda: N.gn_spatial_stats(x),
                    lambda: N.gn_spatial_stats_torch(x), [x],
                    3 * x.numel(), rate="fp32", tol="gn",
                    vjp=(AG.gn_spatial_stats, (x,), {},
                         N.gn_spatial_stats_torch))

    def gn_apply_case(shape, silu=True, dtype=torch.bfloat16, rows=None):
        """x with a mean off zero, the channel means of the whole image
        (for an SP rank's ``rows``, the first of them: group_sums adds
        every rank's sums), an fp32 affine near the identity, 32 groups."""
        x = (rn(*shape, scale=1.5, dtype=torch.float32) + 0.4).to(dtype)
        xf = x.float().reshape(shape[0], -1, shape[-1])
        m1, m2 = xf.mean(1), xf.square().mean(1)
        del xf
        if rows is not None:
            x = x[:, :rows].contiguous()
        sc = rn(shape[-1], scale=0.1, dtype=torch.float32) + 1.0
        bi = rn(shape[-1], scale=0.1, dtype=torch.float32)
        kw = {"num_groups": 32, "silu": silu}
        ins = (x, m1, m2, sc, bi)
        fp32 = " fp32" if dtype == torch.float32 else ""
        return case(f"x{tuple(x.shape)}{fp32}{' silu' if silu else ''}"
                    f"{' (an SP=2 rank)' if rows is not None else ''}",
                    lambda: N.gn_apply(*ins, **kw),
                    lambda: N.gn_apply_torch(*ins, **kw), list(ins),
                    (5 if silu else 2) * x.numel(), rate="fp32",
                    vjp=(AG.gn_apply, ins, kw, N.gn_apply_torch))

    def conv_case(fn, b, h, w, cin, cout, dtype=torch.bfloat16):
        """bf16, or an fp32 x with the bf16 weights (the fp32 decode):
        then fp32 out against the fp32 plain version, with cuDNN's TF32 off
        (phase 1), and cuDNN in fp32 as the library call."""
        x = rn(b, h, w, cin, dtype=dtype)
        k = rn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        bias = rn(cout) * 0.1
        xc = x.permute(0, 3, 1, 2)     # channels_last NCHW views
        kc = k.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(dtype)
        extra = ({"time": ("conv3x3", lambda: CV.conv3x3(x, k, bias))}
                 if fn is CV.conv3x3_padacc else {})
        fp32 = " fp32" if dtype == torch.float32 else ""
        entry = {CV.conv3x3: AG.conv3x3, CV.conv3x3_hblock:
                 AG.conv3x3_hblock, CV.conv3x3_padacc: AG.conv3x3_padacc}[fn]
        return case(f"x{(b, h, w, cin)}{fp32} -> {cout}",
                    lambda: fn(x, k, bias),
                    lambda: CV.conv3x3_torch(x, k, bias), [x, k, bias],
                    2 * b * h * w * 9 * cin * cout,
                    library=lambda: F.conv2d(xc, kc, bc, padding=1),
                    vjp=(entry, (x, k, bias), {}, CV.conv3x3_torch),
                    **extra)

    def flash_gemm_case(b, n, heads, garment, uncond, d=64):
        hd = heads * d
        qkv = rn(b, n, 3 * hd)
        kv = rn(b - uncond, n, 2 * hd) if garment else None
        q, k, v = (bhsd(qkv[..., i * hd:(i + 1) * hd].reshape(b, n, heads, d))
                   for i in range(3))
        keys = b * n
        if garment:   # the uncond rows' garment KV is zeros (analytic sink)
            kvz = torch.cat([kv.new_zeros(uncond, n, 2 * hd), kv])
            k = torch.cat([k, bhsd(kvz[..., :hd].reshape(b, n, heads, d))], 2)
            v = torch.cat([v, bhsd(kvz[..., hd:].reshape(b, n, heads, d))], 2)
            keys += (b - uncond) * n
        return case(f"qkv{(b, n, 3 * hd)} heads {heads}"
                    f"{f' garment M={n} uncond_rows={uncond}' if garment else ''}",
                    lambda: A.flash_attention_gemm(qkv, kv, heads=heads,
                                                   uncond_rows=uncond),
                    lambda: A.flash_attention_gemm_torch(qkv, kv, heads=heads,
                                                         uncond_rows=uncond),
                    [qkv, kv], 4 * heads * d * n * keys,
                    exps=heads * n * keys,
                    library=lambda: F.scaled_dot_product_attention(q, k, v),
                    vjp=(AG.flash_attention_gemm, (qkv, kv),
                         {"heads": heads, "uncond_rows": uncond},
                         A.flash_attention_gemm_torch))

    def flash_case(b, n, heads, d, m):
        """The split-heads views of a to_qkv output (row stride 3*H*D) over
        [own | m garment keys] (m = 0: self-attention), as SelfAttention
        passes them."""
        hd = heads * d
        qkv = rn(b, n, 3 * hd)
        q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(b, n, heads, d)
                   for i in range(3))
        if m:
            kg, vg = rn(b, m, heads, d), rn(b, m, heads, d)
            kern = lambda: A.flash_attention_concat_kv(q, k, v, kg, vg)
            plain = lambda: A.flash_attention_concat_kv_torch(q, k, v, kg, vg)
            ins = [qkv, kg, vg]
            kt, vt = bhsd(torch.cat([k, kg], 1)), bhsd(torch.cat([v, vg], 1))
            vjp = (AG.flash_attention_concat_kv, (q, k, v, kg, vg), {},
                   A.flash_attention_concat_kv_torch)
        else:
            kern = lambda: A.flash_attention(q, k, v)
            plain = lambda: A.flash_attention_torch(q, k, v)
            ins, kt, vt = [qkv], bhsd(k), bhsd(v)
            vjp = (AG.flash_attention, (q, k, v), {},
                   A.flash_attention_torch)
        qt = bhsd(q)
        return case(f"q{(b, n, heads, d)} over {n + m} keys"
                    f"{' (concat KV)' if m else ''}", kern, plain, ins,
                    4 * b * heads * n * (n + m) * d,
                    exps=b * heads * n * (n + m),
                    library=lambda: F.scaled_dot_product_attention(qt, kt, vt),
                    vjp=vjp)

    def flash_sp_case(b, nq, n, heads, uncond=None, d=64):
        """An SP rank's SelfAttention (``parallel/sp.py``): its ``nq``
        local queries, a view of its to_qkv output, over the ``n`` own
        keys and values gathered from every rank (contiguous (B, n, H, D))
        and, for TryonNet (``uncond`` given), the gathered garment K/V as
        the model passes it: a view of the (B, n, 2*H*D) garment GEMM
        output whose leading ``uncond`` rows are zeros."""
        hd = heads * d
        q = rn(b, nq, 3 * hd)[..., :hd].reshape(b, nq, heads, d)
        k, v = rn(b, n, heads, d), rn(b, n, heads, d)
        keys, label = n, ""
        if uncond is not None:
            kvg = torch.cat([torch.zeros(uncond, n, 2 * hd, device=dev,
                                         dtype=torch.bfloat16),
                             rn(b - uncond, n, 2 * hd)])
            kg = kvg[..., :hd].reshape(b, n, heads, d)
            vg = kvg[..., hd:].reshape(b, n, heads, d)
            kern = lambda: A.flash_attention_concat_kv(q, k, v, kg, vg)
            plain = lambda: A.flash_attention_concat_kv_torch(q, k, v, kg,
                                                              vg)
            ins, keys = [q, k, v, kg, vg], 2 * n
            label = f" (concat KV, uncond_rows={uncond})"
            kt, vt = bhsd(torch.cat([k, kg], 1)), bhsd(torch.cat([v, vg], 1))
        else:
            kern = lambda: A.flash_attention(q, k, v)
            plain = lambda: A.flash_attention_torch(q, k, v)
            ins, kt, vt = [q, k, v], bhsd(k), bhsd(v)
        qt = bhsd(q)
        return case(f"SP q{(b, nq, heads, d)} over {keys} gathered keys"
                    f"{label}", kern, plain, ins,
                    4 * b * heads * nq * keys * d,
                    exps=b * heads * nq * keys,
                    library=lambda: F.scaled_dot_product_attention(qt, kt, vt))

    def fused_case(b, st, heads, d, s_own):
        qkv = rn(b, st, 3, heads, d)
        qt, kt, vt = (bhsd(qkv[:, :s_own if i == 0 else st, i])
                      for i in range(3))
        return case(f"qkv{(b, st, 3, heads, d)} s_own {s_own}",
                    lambda: A.flash_attention_fused_qkv(qkv, s_own),
                    lambda: A.flash_attention_fused_qkv_torch(qkv, s_own),
                    [qkv], 4 * b * heads * s_own * st * d,
                    exps=b * heads * s_own * st,
                    library=lambda: F.scaled_dot_product_attention(qt, kt, vt))

    csrc = "idmvton_tpu_torch/ops/csrc/"
    sdpa = "F.scaled_dot_product_attention"
    return [
        ("ln_linear", csrc + "ln_linear.cu",
         "idmvton_tpu/ops/pallas_norm.py:131",
         "none: no one PyTorch call fuses LayerNorm into a GEMM", [
             ln_case((4, 3072), 640, 1920, False, False),
             ln_case((4, 768), 1280, 1280, False, False),
             ln_case((4, 3072), 640, 2560, True, True),
             ln_case((4, 768), 1280, 5120, True, True),
             # TryonNet's other two, GarmentNet's (B = 2; its to_qkv takes
             # fused_layer_norm), the tiny UNet's 128-wide level
             ln_case((4, 3072), 640, 640, False, False),
             ln_case((4, 768), 1280, 3840, False, False),
             ln_case((2, 3072), 640, 640, False, False),
             ln_case((2, 3072), 640, 2560, True, True),
             ln_case((2, 768), 1280, 1280, False, False),
             ln_case((2, 768), 1280, 5120, True, True),
             ln_case((4, 768), 128, 384, False, False),
             ln_case((4, 768), 128, 128, False, False),
             ln_case((4, 768), 128, 512, True, True),
             # phase 14: a TP=2 rank's TryonNet at the 1280-wide level
             # (to_qkv, to_q, GEGLU) and 640-wide GEGLU; an SP=2 rank's
             # rows: TryonNet's to_qkv, to_q and GEGLU, GarmentNet's to_q
             # and GEGLU, at the 640- and 1280-wide levels
             ln_case((4, 768), 1280, 1920, False, False),
             ln_case((4, 768), 1280, 640, False, False),
             ln_case((4, 768), 1280, 2560, True, True),
             ln_case((4, 3072), 640, 1280, True, True),
             ln_case((4, 1536), 640, 1920, False, False),
             ln_case((4, 1536), 640, 640, False, False),
             ln_case((4, 1536), 640, 2560, True, True),
             ln_case((4, 384), 1280, 3840, False, False),
             ln_case((4, 384), 1280, 1280, False, False),
             ln_case((4, 384), 1280, 5120, True, True),
             ln_case((2, 1536), 640, 640, False, False),
             ln_case((2, 1536), 640, 2560, True, True),
             ln_case((2, 384), 1280, 1280, False, False),
             ln_case((2, 384), 1280, 5120, True, True)]),
        ("fused_layer_norm", csrc + "ln_linear.cu",
         "idmvton_tpu/ops/pallas_norm.py:26", "F.layer_norm", [
             lnorm_case((2, 3072, 640)), lnorm_case((2, 768, 1280)),
             # phase 14: an SP=2 rank's GarmentNet rows
             lnorm_case((2, 1536, 640)), lnorm_case((2, 384, 1280))]),
        ("gn_spatial_stats", csrc + "gn_stats.cu",
         "idmvton_tpu/ops/pallas_norm.py:575",
         "none: no PyTorch call returns GroupNorm's per-channel sums", [
             gn_case((4, 128, 96, 320)), gn_case((4, 32, 24, 2560)),
             gn_case((6, 1024, 768, 128)),
             # phase 14: an SP=2 rank's 64 of 128 rows
             gn_case((4, 64, 96, 320))]),
        ("conv3x3", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:34", "F.conv2d (cuDNN)", [
             conv_case(CV.conv3x3, 4, 128, 96, 320, 320),
             conv_case(CV.conv3x3, 4, 64, 48, 640, 640),
             conv_case(CV.conv3x3, 4, 32, 24, 1280, 1280),
             conv_case(CV.conv3x3, 4, 128, 96, 960, 320),
             # the fp32 decode's 128x96 level
             conv_case(CV.conv3x3, 2, 128, 96, 512, 512, torch.float32),
             # the demo's fp32 preprocessing nets: OpenPose's 23x18 level,
             # SCHP's layer3 (ATR), the DensePose head's chunk of 20
             conv_case(CV.conv3x3, 1, 23, 18, 512, 512, torch.float32),
             conv_case(CV.conv3x3, 1, 23, 18, 128, 128, torch.float32),
             conv_case(CV.conv3x3, 1, 32, 32, 256, 256, torch.float32),
             conv_case(CV.conv3x3, 20, 28, 28, 512, 512, torch.float32),
             # the DensePose train step (fp32, B = 2 at 800x1088): res3's
             # conv2, the FPN / RPN / decoder at P3, an image's densepose
             # slab; FaceNet's 96x96 level (Face at 384)
             conv_case(CV.conv3x3, 2, 100, 136, 128, 128, torch.float32),
             conv_case(CV.conv3x3, 2, 100, 136, 256, 256, torch.float32),
             conv_case(CV.conv3x3, 16, 28, 28, 512, 512, torch.float32),
             conv_case(CV.conv3x3, 1, 96, 96, 256, 256, torch.float32),
             # phase 14: an SP=2 rank's rows with their two halo rows (the
             # 320- and 1280-wide levels); LPIPS's VGG16 on a 768x1024
             # image (fp32): conv3_1, conv4_2
             conv_case(CV.conv3x3, 4, 66, 96, 320, 320),
             conv_case(CV.conv3x3, 4, 18, 24, 1280, 1280),
             conv_case(CV.conv3x3, 1, 256, 192, 128, 256, torch.float32),
             conv_case(CV.conv3x3, 1, 128, 96, 512, 512, torch.float32)]),
        ("conv3x3_hblock", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:187", "F.conv2d (cuDNN)", [
             conv_case(CV.conv3x3_hblock, 6, 1024, 768, 128, 128),
             conv_case(CV.conv3x3_hblock, 2, 512, 384, 512, 256),
             # the fp32 decode's 512x384 and 1024x768 levels
             conv_case(CV.conv3x3_hblock, 2, 512, 384, 512, 256,
                       torch.float32),
             conv_case(CV.conv3x3_hblock, 2, 1024, 768, 128, 128,
                       torch.float32),
             # the demo's DensePose FPN P2 level (fp32)
             conv_case(CV.conv3x3_hblock, 1, 272, 200, 256, 256,
                       torch.float32),
             # the DensePose train step's P2 at B = 2; Hand's conv2_2 at 736
             conv_case(CV.conv3x3_hblock, 2, 200, 272, 256, 256,
                       torch.float32),
             conv_case(CV.conv3x3_hblock, 1, 368, 368, 128, 128,
                       torch.float32),
             # phase 14: LPIPS's conv2_2 and conv3_2 (fp32, 768x1024)
             conv_case(CV.conv3x3_hblock, 1, 512, 384, 128, 128,
                       torch.float32),
             conv_case(CV.conv3x3_hblock, 1, 256, 192, 256, 256,
                       torch.float32)]),
        ("flash_attention_gemm", csrc + "flash_attention_gemm.cu",
         "idmvton_tpu/ops/pallas_attention.py:356", sdpa, [
             flash_gemm_case(4, 3072, 10, True, 2),
             flash_gemm_case(4, 768, 20, True, 2),
             flash_gemm_case(2, 3072, 10, False, 0),
             flash_gemm_case(2, 768, 20, False, 0),
             # the tiny UNet's 128-wide level (8 heads of 16), TryonNet
             flash_gemm_case(4, 768, 8, True, 2, d=16),
             # phase 14: a TP=2 rank's TryonNet at the 1280-wide level
             flash_gemm_case(4, 768, 10, True, 2)]),
        ("ln_linear_i8", csrc + "ln_linear_i8.cu",
         "idmvton_tpu/ops/pallas_norm.py:380",
         "none: no PyTorch call fuses LayerNorm, int8 quantization and an "
         "int8 GEMM", [
             ln_i8_case((4, 3072), 640, 1920, False, False),
             ln_i8_case((4, 768), 1280, 3840, False, False),
             ln_i8_case((4, 3072), 640, 2560, True, True),
             ln_i8_case((4, 768), 1280, 5120, True, True),
             ln_i8_case((2, 3072), 640, 2560, True, True),
             ln_i8_case((2, 768), 1280, 5120, True, True)]),
        ("cross_attention_small_kv", csrc + "cross_attention_small_kv.cu",
         "idmvton_tpu/ops/pallas_attention.py:847",
         "none: two independently normalized softmaxes summed are two "
         "attention calls", [
             cross_case(4, 3072, 10, True), cross_case(4, 768, 20, True),
             cross_case(2, 3072, 10, False)]),
        ("conv3x3_padacc", csrc + "conv3x3_padacc.cu",
         "idmvton_tpu/ops/pallas_conv.py:67", "F.conv2d (cuDNN)", [
             conv_case(CV.conv3x3_padacc, 4, 128, 96, 320, 320),
             conv_case(CV.conv3x3_padacc, 4, 64, 48, 640, 640),
             conv_case(CV.conv3x3_padacc, 4, 32, 24, 1280, 1280),
             conv_case(CV.conv3x3_padacc, 4, 128, 96, 960, 320),
             conv_case(CV.conv3x3_padacc, 6, 128, 96, 512, 512)]),
        ("flash_attention", csrc + "flash_attention.cu",
         "idmvton_tpu/ops/pallas_attention.py:58", sdpa, [
             flash_case(4, 3072, 4, 16, 3072),   # tiny TryonNet, 64-wide
             flash_case(2, 3072, 4, 16, 0),      # tiny GarmentNet, 64-wide
             flash_case(4, 3072, 10, 64, 3072),  # SDXL width
             # phase 14: a TP=2 rank's 640-wide level (5 heads of 64); an
             # SP=2 rank's TryonNet and GarmentNet at the 640- and
             # 1280-wide levels
             flash_case(4, 3072, 5, 64, 3072),
             flash_sp_case(4, 1536, 3072, 10, uncond=2),
             flash_sp_case(4, 384, 768, 20, uncond=2),
             flash_sp_case(2, 1536, 3072, 10),
             flash_sp_case(2, 384, 768, 20)]),
        ("flash_attention_fused_qkv", csrc + "flash_attention.cu",
         "idmvton_tpu/ops/pallas_attention.py:743", sdpa, [
             fused_case(4, 6144, 4, 16, 3072),
             fused_case(4, 6144, 10, 64, 3072)]),
        # last, so that the cases above draw the inputs they drew before it
        ("gn_apply", csrc + "gn_stats.cu",
         "none: the JAX package leaves the tail after the statistics to "
         "XLA's fusion",
         "none: F.group_norm takes no given means (it computes two-pass "
         "statistics)", [
             # the UNets' GroupNorm widths at their three levels, TryonNet
             # (B = 4) and GarmentNet (B = 2); the VAE encode's level 0,
             # the decode's 512x384 level (its attention's norm: no SiLU)
             # and the fp32 decode's 1024x768 level; an SP=2 rank's rows
             *(gn_apply_case((b, h, w, c)) for b in (4, 2)
               for h, w in ((128, 96), (64, 48), (32, 24))
               for c in (320, 640, 960, 1280, 1920, 2560)),
             gn_apply_case((6, 1024, 768, 128)),
             gn_apply_case((2, 512, 384, 512), silu=False),
             gn_apply_case((2, 1024, 768, 128), dtype=torch.float32),
             gn_apply_case((4, 128, 96, 320), rows=64)]),
    ]


def nbytes(*ts) -> int:
    import torch
    total = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def check_kernels(dev):
    import torch
    results = {}
    for name, source, replaces, library, cases in kernel_cases(dev):
        worst_abs, worst_rel = 0.0, 0.0
        ms = plain_ms = bound_ms = bytes_bound_ms = g_ms = 0.0
        lib_ms = 0.0 if cases[0]["library"] is not None else None
        lib_g_ms = None if lib_ms is None else 0.0
        extra_ms = {}
        for c in cases:
            kern, plain = c["kern"], c["plain"]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            aside = ""
            if "vs" in c:   # on record, not a gate
                other, fn = c["vs"]
                _, rel = errors(got, fn())
                aside = f", rel err vs {other} {rel:.3e} (no gate)"
            if c["tol"] == "gn":   # (sum, sum of squares), scaled by the latter
                abs_err = max(errors(got[i], want[i])[0] for i in (0, 1))
                err = abs_err / float(want[1].abs().max())
                tol = GN_TOL
            else:
                (abs_err, err), tol = errors(got, want), BF16_TOL
            t_bytes = 1e3 * nbytes(c["ins"], got) / HBM_BPS
            t_ops = 1e3 * c["ops"] / PEAK[c["rate"]]
            if "exps" in c:   # on record in the log, not in the kernels line
                aside += f", exp floor {1e3 * c['exps'] / EXP_RATE:.4f} ms"
            del got, want
            # in turns: plain, kernel, kernel, plain
            p1 = cuda_time_ms(plain)
            k1 = cuda_time_ms(kern)
            k2 = cuda_time_ms(kern)
            p2 = cuda_time_ms(plain)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            kg_ms = graph_ms(kern)
            g_ms += kg_ms
            aside += f", graph {kg_ms:.4f} ms"
            if c["library"] is not None:
                l_ms = (cuda_time_ms(c["library"])
                        + cuda_time_ms(c["library"])) / 2
                lg_ms = graph_ms(c["library"])
                lib_ms += l_ms
                lib_g_ms += lg_ms
                aside += f", library {l_ms:.4f} ms (graph {lg_ms:.4f})"
            if "time" in c:
                other, fn = c["time"]
                o_ms = (cuda_time_ms(fn) + cuda_time_ms(fn)) / 2
                extra_ms[other] = extra_ms.get(other, 0.0) + o_ms
                aside += f", {other} {o_ms:.4f} ms"
            log(f"kernel {name} {c['label']}: max abs err {abs_err:.4g}, rel "
                f"{err:.3e} (tol {tol:g}), kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms (bytes "
                f"{t_bytes:.4f}, {c['rate']} ops {t_ops:.4f}){aside}")
            if not err <= tol:
                fail(f"{name} {c['label']}: error {err} above {tol}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, err)
            ms += k_ms
            plain_ms += p_ms
            bound_ms += max(t_bytes, t_ops)
            bytes_bound_ms += t_bytes if t_bytes >= t_ops else 0.0
            torch.cuda.empty_cache()
        results[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": worst_abs,
                         "max_rel_err": worst_rel, "tol_rel": tol,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": ("bytes" if 2 * bytes_bound_ms >= bound_ms
                                      else "operations"),
                         "library_ms": lib_ms, "library": library,
                         "graph_ms": g_ms, "library_graph_ms": lib_g_ms,
                         "shapes": len(cases)}
        results[name].update({f"{k}_ms": v for k, v in extra_ms.items()})
    return results


def make_inputs(models, dev, gen):
    import torch
    dt = torch.bfloat16

    def img():
        return (torch.rand(BATCH, HEIGHT, WIDTH, 3, generator=gen,
                           device=dev) * 2 - 1).to(dt)

    def ids():
        return torch.randint(0, models.clip_l_cfg.vocab_size, (BATCH, 77),
                             generator=gen, device=dev)

    mask = torch.zeros(BATCH, HEIGHT, WIDTH, 1, device=dev, dtype=dt)
    mask[:, HEIGHT // 5:4 * HEIGHT // 5, WIDTH // 6:5 * WIDTH // 6] = 1
    isz = models.vision_cfg.image_size
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                ip_pixels=(torch.rand(BATCH, isz, isz, 3, generator=gen,
                                      device=dev) * 2 - 1).to(dt))


def step_readings(pipe, inputs, gen, path):
    """One denoise step with ``impl="cuda"`` and with ``impl="torch"`` on the
    same inputs; returns {"noise_pred" | "latent": (max rel, mean rel)} of
    the cuda result against the torch one: the guided noise prediction
    (read from the TryonNet's output as the step runs) and the stepped
    latent."""
    import torch
    from idmvton_tpu_torch.diffusion.scheduler import classifier_free_guidance
    dev = inputs["person"].device
    cond = pipe.staged_encoder()(gen, inputs)
    b, h, w, _ = inputs["person"].shape
    ds = pipe.models.vae_cfg.downscale
    lat_shape = (b, h // ds, w // ds, pipe.models.vae_cfg.latent_channels)
    lat = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    ts, prev_ts = pipe.scheduler.timesteps_and_prev(STEPS)
    out = {"noise_pred": {}, "latent": {}}
    # the TryonNet's output (uncond | cond halves), read as the step runs
    hook = pipe.models.unet.register_forward_hook(
        lambda mod, args, res: out.update(unet=res[0]))
    try:
        for impl in ("cuda", "torch"):
            t0 = time.perf_counter()
            out["latent"][impl] = pipe.denoise_step(
                cond, lat, int(ts[0]), int(prev_ts[0]),
                guidance_scale=GUIDANCE, step_noise=noise, impl=impl)
            torch.cuda.synchronize()
            out["noise_pred"][impl] = classifier_free_guidance(
                *out.pop("unet").chunk(2), GUIDANCE)
            log(f"{path} denoise step impl={impl}: "
                f"{time.perf_counter() - t0:.3f} s")
    finally:
        hook.remove()
    readings = {}
    for what, by_impl in out.items():
        got, want = by_impl["cuda"].float(), by_impl["torch"].float()
        readings[what] = (errors(got, want)[1],
                          float((got - want).abs().mean() / want.abs().mean()))
    del cond, out
    torch.cuda.empty_cache()
    return readings


def check_step(pipe, inputs, gen, path, tols=None):
    """``step_readings``, gated: fails where the guided noise prediction or
    the stepped latent differs by more than its bounds in ``tols``
    (``STEP_TOLS``)."""
    tols = STEP_TOLS if tols is None else tols
    readings = step_readings(pipe, inputs, gen, path)
    for what, (max_tol, mean_tol) in tols.items():
        err, mean_rel = readings[what]
        log(f"{path} denoise step {what} cuda vs torch: max rel err "
            f"{err:.3e} (tol {max_tol:g}), mean rel err {mean_rel:.3e} "
            f"(tol {mean_tol if mean_tol is not None else 'none'})")
        if not err <= max_tol or (mean_tol is not None
                                  and not mean_rel <= mean_tol):
            fail(f"{path} denoise step: {what} cuda vs torch "
                 f"max rel error {err}, mean rel error {mean_rel}")


def check_online_softmax_step(pipe, inputs, gen):
    """``check_step`` with ``IDMVTON_FLASH_FIXED_SHIFT=0``: every
    flash_attention_gemm launch of the cuda impl must take the online-max
    softmax (the site's ``fixed_shift`` argument, recorded as it runs)."""
    from idmvton_tpu_torch.models import attention as site
    real = site.flash_attention_gemm
    modes = []

    def spy(*args, **kw):
        modes.append(kw["fixed_shift"])
        return real(*args, **kw)

    os.environ["IDMVTON_FLASH_FIXED_SHIFT"] = "0"
    site.flash_attention_gemm = spy
    try:
        check_step(pipe, inputs, gen, "bf16 online softmax")
    finally:
        site.flash_attention_gemm = real
        os.environ["IDMVTON_FLASH_FIXED_SHIFT"] = "1"
    log(f"bf16 online softmax step: {len(modes)} flash_attention_gemm "
        f"launches, fixed_shift {sorted(set(modes))}")
    if not modes or any(modes):
        fail(f"online softmax step: flash_attention_gemm modes {set(modes)}"
             f" over {len(modes)} launches, expected only False")


def check_decode_fp32(models, wrappers, gen):
    """One full-width latent (BATCH, 128, 96, 4) decoded in bf16, then in
    fp32 (``VAEConfig.force_upcast``): the fp32 decode must launch the conv
    and GroupNorm statistics kernels at every site the bf16 decode does
    (conv3x3 and conv3x3_hblock together: the fp32 activations' size moves
    sites between them) and no other kernel, give finite fp32 images of
    (BATCH, HEIGHT, WIDTH, 3), and stay within DECODE_FP32_MEAN_REL of the
    bf16 decode. Returns the fp32 decode's launch counts."""
    import dataclasses
    import torch
    vae = models.vae
    ds = vae.cfg.downscale
    z = torch.randn(BATCH, HEIGHT // ds, WIDTH // ds, vae.cfg.latent_channels,
                    generator=gen, device=gen.device).to(torch.bfloat16)
    runs = {}
    cfg = vae.cfg
    try:
        for name, upcast in (("bf16", False), ("fp32", True)):
            vae.cfg = dataclasses.replace(cfg, force_upcast=upcast)
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            img = vae.decode(z)
            torch.cuda.synchronize()
            runs[name] = (img, {k: w.launches for k, w in wrappers.items()})
            log(f"decode {name}: {time.perf_counter() - t0:.3f} s, "
                f"{img.dtype} {tuple(img.shape)}")
    finally:
        vae.cfg = cfg
    (img16, c16), (img32, c32) = runs["bf16"], runs["fp32"]
    counts = gate_launches(wrappers, "decode_fp32",
                           {"gn_spatial_stats": c16["gn_spatial_stats"],
                            "gn_apply": c16["gn_apply"]})
    sites = c16["conv3x3"] + c16["conv3x3_hblock"]
    if c32["conv3x3"] + c32["conv3x3_hblock"] != sites:
        fail(f"decode fp32: {c32['conv3x3']} + {c32['conv3x3_hblock']} conv "
             f"launches, not the bf16 decode's {sites} sites")
    if (img32.dtype != torch.float32
            or tuple(img32.shape) != (BATCH, HEIGHT, WIDTH, 3)
            or not bool(torch.isfinite(img32).all())):
        fail(f"decode fp32: {img32.dtype} {tuple(img32.shape)}, finite "
             f"{bool(torch.isfinite(img32).all())}")
    d = (img32 - img16.float()).abs()
    mean_rel = float(d.mean() / img16.float().abs().mean())
    log(f"decode fp32 vs bf16: mean rel {mean_rel:.3e} (bound "
        f"{DECODE_FP32_MEAN_REL:g}), max abs {float(d.max()):.3e}")
    if not mean_rel <= DECODE_FP32_MEAN_REL:
        fail(f"decode fp32: mean rel {mean_rel} to the bf16 decode")
    return counts


def serve_requests(pipe, inputs, gen, wrappers, path, exact=None, keep=None):
    """Serve 2 requests through ``stepwise_generate``; returns the launch
    count of each kernel in that run (counts zeroed just before, read just
    after). Fails unless the run launched every kernel of
    ``PATH_KERNELS[path]``, no other and, for each kernel in ``exact``,
    exactly that many times. ``keep`` (a list): the last request's images
    are appended to it."""
    import torch
    serve = pipe.stepwise_generate(num_steps=STEPS, guidance_scale=GUIDANCE,
                                   garment_cache="every_step")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for req in range(2):
        phases = {}
        t0 = time.perf_counter()
        images = serve(gen, phase_seconds=phases, **inputs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if tuple(images.shape) != (BATCH, HEIGHT, WIDTH, 3):
            fail(f"{path} request {req}: images {tuple(images.shape)}")
        if not bool(torch.isfinite(images).all()):
            fail(f"{path} request {req}: non-finite images")
        log(f"{path} request {req}: {secs:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
            + f"); images {tuple(images.shape)} finite, range "
            f"[{float(images.min()):.3f}, {float(images.max()):.3f}], "
            f"std {float(images.float().std()):.4f}")
    log(f"{path} peak memory during serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if keep is not None:
        keep.append(images.float())
    return gate_launches(wrappers, path, exact)


def gate_launches(wrappers, path, exact=None):
    """Reads the launch counts of a run (zeroed just before it); fails
    unless the run launched every kernel of ``PATH_KERNELS[path]``, no other
    and, for each kernel in ``exact``, exactly that many times."""
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"{path} launches: {counts}")
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        fail(f"{path} path: kernels never launched: {missing}")
    stray = [k for k, n in counts.items()
             if n and k not in PATH_KERNELS[path]]
    if stray:
        fail(f"{path} path: kernels of another path launched: {stray}")
    for k, n in (exact or {}).items():
        if counts[k] != n:
            fail(f"{path} path: {k} launched {counts[k]} times, not {n}")
    return counts


def synthetic_batch(n, seed):
    """n samples of seeded numpy in the ``VitonHDDataset`` layout at
    HEIGHT x WIDTH (person / pose / cloth in [-1, 1], a {0, 1} mask, 224x224
    CLIP-normalized ip_pixels, captions), as an in-memory dataset."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)
    samples = []
    for i in range(n):
        mask = np.zeros((HEIGHT, WIDTH, 1), np.float32)
        mask[HEIGHT // 5:4 * HEIGHT // 5, WIDTH // 6:5 * WIDTH // 6] = 1.0
        samples.append({
            "im_name": f"{i:05d}_00.jpg", "c_name": f"{i:05d}_00.jpg",
            "person": img(), "mask": mask, "pose": img(), "cloth": img(),
            "ip_pixels": rng.standard_normal((224, 224, 3)).astype(
                np.float32),
            "caption": "model is wearing t shirts long ",
            "caption_cloth": "a photo of t shirts long "})
    return samples


def cli_run(args, models, built, wrappers, path, exact=None):
    """One batch of 2 synthetic samples through ``cli.infer.run`` (the CLI's
    per-batch loop and its BatchLoader) with ``built``, the CLI's
    ``cli.infer.build(args, models)``, and the launch counts zeroed just
    before and read just after; fails unless the images are uint8
    (2, HEIGHT, WIDTH, 3) and not constant and the launches pass
    ``gate_launches``. Returns (launch counts, images)."""
    import numpy as np
    from idmvton_tpu_torch.cli import infer
    from idmvton_tpu_torch.data.datasets import BatchLoader
    pipe, tok1, tok2, gen = built
    loader = BatchLoader(synthetic_batch(BATCH, SEED + 2), args.test_batch_size)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = list(infer.run(args, pipe, models, loader, tok1, tok2, gen))
    secs = time.perf_counter() - t0
    counts = gate_launches(wrappers, path, exact)
    if len(out) != 1:
        fail(f"{path}: {len(out)} batches, expected 1")
    names, images = out[0]
    if (images.dtype != np.uint8
            or images.shape != (BATCH, HEIGHT, WIDTH, 3)):
        fail(f"{path}: images {images.dtype} {images.shape}")
    if not images.std() > 0:
        fail(f"{path}: constant images")
    log(f"{path}: cli.infer.run batch of {len(names)} ({names}) in "
        f"{secs:.3f} s: uint8 {images.shape}, mean {images.mean():.2f}, "
        f"std {images.std():.2f}")
    return counts, images


def bit_check(label, got, want, runs):
    """Fails unless ``got`` equals ``want`` bit for bit or, where two eager
    runs (``runs``) differ, by no more than they do."""
    import torch
    diff = float((got.float() - want.float()).abs().max())
    spread = float((runs[0].float() - runs[1].float()).abs().max())
    log(f"{label}: max |replayed - eager| {diff:.3e}, two eager runs "
        f"{spread:.3e}, bit-equal {torch.equal(got, want)}")
    if not (torch.equal(got, want) or (spread > 0 and diff <= spread)):
        fail(f"{label}: replayed differs from eager by {diff} (two eager "
             f"runs by {spread})")


def check_graph(pipe, inputs, gen, wrappers):
    """The captured step (phase 4): (a) one full-width step eager against
    the same step replayed; (b) two requests through ``jit_generate``
    against two through eager ``generate``, from generators of one seed:
    the same images and the same launch counts; (c) the replayed step's wall
    and device time against the eager step's. Returns the jit_generate
    requests' launch counts."""
    import numpy as np
    import torch
    from idmvton_tpu_torch.utils import profiling
    sched = pipe.scheduler
    dev = inputs["person"].device
    cond = pipe.staged_encoder()(gen, inputs)
    b, h, w, _ = inputs["person"].shape
    ds = pipe.models.vae_cfg.downscale
    lat_shape = (b, h // ds, w // ds, pipe.models.vae_cfg.latent_channels)
    lat = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(lat_shape, generator=gen,
                        device=dev).to(torch.bfloat16)
    ts, prev_ts = sched.timesteps_and_prev(STEPS)
    table = torch.from_numpy(sched.step_table(
        ts, prev_ts, np.concatenate([ts[1:], [-1]]))).to(dev)

    def eager(i=0):
        return pipe.denoise_step(cond, lat, int(ts[i]), int(prev_ts[i]),
                                 guidance_scale=GUIDANCE, step_noise=noise)

    # (a) the first step() runs eagerly, then captures; the second replays
    runs = [eager(), eager()]
    steps = pipe.step_graph(cond, lat, guidance_scale=GUIDANCE)
    t0 = time.perf_counter()
    steps.start(table, lat, cond)
    steps.step(noise)
    torch.cuda.synchronize()
    capture = [s for s in profiling.spans() if s.name == "graph.capture"][-1]
    log(f"graph: first step eager + capture {time.perf_counter() - t0:.3f}"
        f" s (capture alone {capture.seconds:.3f} s)")
    bit_check("graph first step (eager, side stream)", steps.lat, runs[0],
              runs)
    steps.start(table, lat, cond)
    steps.step(noise)
    bit_check("graph replayed step", steps.lat, runs[0], runs)

    # (c) wall against device time, 5 steps each way; the device time of a
    # step is that of back-to-back replays (nothing waits for the host)
    def timed(step_fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(TIMED_STEPS):
            step_fn()
        end.record()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / TIMED_STEPS,
                start.elapsed_time(end) / TIMED_STEPS)

    steps.start(table, lat, cond)
    r_wall, r_dev = timed(lambda: steps.step(noise))
    e_wall, e_dev = timed(eager)
    for mode, wall, span in (("replayed", r_wall, r_dev),
                             ("eager", e_wall, e_dev)):
        log(f"graph timing {mode} step: wall {wall:.3f} ms, device span "
            f"{span:.3f} ms (events), idle share {1 - r_dev / wall:.4f} "
            f"(1 - replayed device ms / wall ms)")
    del runs, steps
    torch.cuda.empty_cache()

    # (b) two requests each way, same seed
    counts, images = {}, {}
    serve = pipe.jit_generate(num_steps=STEPS, guidance_scale=GUIDANCE)
    eager_gen = lambda g, **kw: pipe.generate(
        g, num_steps=STEPS, guidance_scale=GUIDANCE, **kw)
    for mode, fn in (("jit_generate", serve), ("generate", eager_gen)):
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        images[mode] = []
        for req in range(2):
            phases = {}
            t0 = time.perf_counter()
            img = fn(g, phase_seconds=phases, **inputs)
            torch.cuda.synchronize()
            images[mode].append(img)
            log(f"graph {mode} request {req}: "
                f"{time.perf_counter() - t0:.3f} s ("
                + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
                + ")")
        log(f"graph {mode} peak memory: allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
            f"(the graph's pool included) "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
        counts[mode] = {k: w.launches for k, w in wrappers.items()}
    for req in range(2):
        got, want = images["jit_generate"][req], images["generate"][req]
        if (tuple(got.shape) != (BATCH, HEIGHT, WIDTH, 3)
                or not bool(torch.isfinite(got).all())):
            fail(f"graph request {req}: images {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        bit_check(f"graph request {req} images", got, want, [want, want])
    if counts["jit_generate"] != counts["generate"]:
        fail(f"graph: replayed launches {counts['jit_generate']} != eager "
             f"{counts['generate']}")
    for w, n in zip(wrappers.values(), counts["jit_generate"].values()):
        w.launches = n
    return gate_launches(wrappers, "graph",
                         {k: 2 * n for k, n in CONV_PER_REQUEST.items()})


class RssPeak:
    """The process's peak resident set while in a ``with``, sampled from
    /proc/self/statm every ``period`` seconds on a thread."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _sample(self):
        while not self._done.wait(self.period):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        import threading
        self._done = threading.Event()
        self.start = self.peak = self._rss()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())
        return False


def check_checkpoint(models, wrappers, cli_images, cli_counts, exact):
    """Phase 7: ``models`` exported as a bf16 diffusers tree, loaded back
    through the CLI's ``load_models`` into a second stack (every parameter
    equal to its source), and phase 6's CLI batch served from it: the same
    uint8 images bit for bit and the same launch counts. Returns the
    batch's launch counts."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from idmvton_tpu_torch.cli import infer
    from idmvton_tpu_torch.pipeline.tryon import COMPONENTS
    from idmvton_tpu_torch.weights.checkpoint import save_diffusers
    n_params = sum(p.numel() for m in models.components().values()
                   for p in m.parameters())
    # every exported tensor in bf16; the Resampler rides in the UNet file
    need = 2 * n_params
    tmp = tempfile.mkdtemp(prefix="idmvton_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"checkpoint: bf16 tree of {n_params / 1e9:.3f} B params, "
            f"{need / 1e9:.2f} GB, into {tmp} ({free / 1e9:.2f} GB free)")
        if free < need + 2**30:
            fail(f"checkpoint: {free / 1e9:.2f} GB free in {tmp}, the tree "
                 f"needs {need / 1e9:.2f} GB")
        t0 = time.perf_counter()
        save_diffusers(tmp, models, dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(tmp) for f in files)
        log(f"checkpoint export: {export_s:.3f} s, {size} bytes on disk "
            f"({size / 1e9:.3f} GB)")

        args = infer.parse_args(["--data_dir", "-", "--pretrained", tmp,
                                 "--diffusers", "--device", "cuda"])
        torch.cuda.synchronize()
        base_alloc = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            loaded = infer.load_models(args, torch.bfloat16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        log(f"checkpoint load (cli.infer.load_models, page cache warm from "
            f"the export): {load_s:.3f} s, {size / load_s / 1e9:.3f} GB/s; "
            f"peak host RSS {rss.peak / 2**30:.3f} GiB (before "
            f"{rss.start / 2**30:.3f} GiB, +{(rss.peak - rss.start) / 2**30:.3f}"
            f" GiB); card peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (first "
            f"stack and its pools {base_alloc / 2**30:.2f} GiB), now "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        log(f"checkpoint calibration: {json.dumps(loaded.calibration)}")
        if loaded.calibration is None:
            fail("checkpoint: the load ran no softmax calibration")

        diff, total = [], 0
        for name in COMPONENTS:
            src = dict(getattr(models, name).named_parameters())
            got = dict(getattr(loaded, name).named_parameters())
            if src.keys() != got.keys():
                fail(f"checkpoint: {name} parameters differ in names")
            for k, p in src.items():
                total += 1
                if got[k].dtype != p.dtype or not torch.equal(got[k], p):
                    diff.append(f"{name}.{k}")
        log(f"checkpoint: {total - len(diff)} of {total} parameters equal "
            f"their source")
        if diff:
            fail(f"checkpoint: {len(diff)} parameters differ, e.g. "
                 f"{diff[:5]}")

        counts, images = cli_run(args, loaded, infer.build(args, loaded),
                                 wrappers, "checkpoint", exact=exact)
        log(f"checkpoint: card peak allocated over the load and the batch, "
            f"two stacks resident: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        same = np.array_equal(images, cli_images)
        log(f"checkpoint: images equal phase 6's bit for bit {same}, max "
            f"|diff| {np.abs(images.astype(int) - cli_images).max()}; "
            f"launch counts equal {counts == cli_counts}")
        if not same:
            fail("checkpoint: the loaded stack's images differ from phase 6's")
        if counts != cli_counts:
            fail(f"checkpoint: launches {counts} != phase 6's {cli_counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # a pipeline and its captured steps reference each other: collect the
    # cycle, or the second stack stays resident through the later phases
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    now = torch.cuda.memory_allocated()
    log(f"checkpoint: second stack freed, {now / 2**30:.2f} GiB allocated "
        f"(before the load {base_alloc / 2**30:.2f} GiB)")
    if now > base_alloc + 2**30:
        fail(f"checkpoint: {now / 2**30:.2f} GiB still allocated after "
             f"freeing the second stack")
    return counts


def mean_rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().mean() / want.abs().mean())


def check_demo(models, wrappers):
    """The demo (phase 6b) on the full-width stack: ``cli.demo``'s
    ``TryonService`` built around it (its three fp32 preprocessing nets
    from their seeds on the card), each net with ``impl="cuda"`` against
    ``impl="torch"`` on the demo's arrays at the shapes its host resizes
    give (each cuda run launching the conv kernels exactly at
    ``DEMO_CONV``'s sites and nothing else, the torch run none), then two
    requests through ``TryonService.tryon``: a seeded 768x1024 person and
    garment, the auto mask, 30 steps, seed 42, ``desc="shirt"``; their
    launches gated exactly (the nets' sites plus ``CONV_PER_REQUEST``).
    Returns the requests' launch counts."""
    import gc
    import numpy as np
    import torch
    from PIL import Image
    from idmvton_tpu_torch.cli import demo
    from idmvton_tpu_torch.models.layers import weights_changed_
    from idmvton_tpu_torch.ops.nms import box_iou, nms_topk
    from idmvton_tpu_torch.preprocess.densepose.visualize import extract_iuv
    dev = next(models.unet.parameters()).device
    t0 = time.perf_counter()
    svc = demo.TryonService(demo.parse_args(
        ["--width", str(WIDTH), "--height", str(HEIGHT), "--device",
         str(dev)]), models=models)
    torch.cuda.synchronize()
    log(f"demo: TryonService around the stack, its nets built in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # the R-CNN's stem scaled to mean-subtracted pixels (|x| ~ 50): the
    # init's fan-in scale on them saturates the random heads, whose boxes
    # then collapse onto the image's border (tests/test_torch_preprocess.py
    # scales it the same way)
    stem = svc.densepose.model.backbone.stem.conv.kernel
    stem.div_(50.0)
    weights_changed_(svc.densepose.model)
    rng = np.random.default_rng(SEED + 5)
    person = rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)
    garment = rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)
    small = np.asarray(Image.fromarray(person).resize((384, 512)))

    def both(name, run):
        """run(impl) on both impls (cuda twice: cold, then timed and gated
        warm); returns {impl: outputs}."""
        out = {}
        for impl in ("cuda", "torch", "cuda"):
            for w in wrappers.values():
                w.launches = 0
            t = time.perf_counter()
            out[impl] = run(impl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            counts = {k: w.launches for k, w in wrappers.items() if w.launches}
            want = DEMO_CONV[name] if impl == "cuda" else {}
            log(f"demo {name} impl={impl}: {secs:.4f} s, launches {counts}")
            if counts != want:
                fail(f"demo {name} impl={impl}: launches {counts}, "
                     f"expected {want}")
        return out

    def gate(what, got, want, tols):
        err, rel = errors(got, want)
        mrel = mean_rel(got, want)
        log(f"demo {what} cuda vs torch: max |diff| {err:.4g}, max rel "
            f"{rel:.3e} (tol {tols[0]:g}), mean rel {mrel:.3e} (tol "
            f"{tols[1]:g})")
        if not (rel <= tols[0] and mrel <= tols[1]):
            fail(f"demo {what}: max rel {rel}, mean rel {mrel} above {tols}")

    def agree(what, rate, tol):
        log(f"demo {what} agreement {rate:.4f} (bound {tol:g})")
        if not rate >= tol:
            fail(f"demo {what} agreement {rate} below {tol}")

    # OpenPose at scale 0.5 of boxsize 368 on the 384x512 small image
    x, _ = svc.openpose.prepare(small[:, :, ::-1], 0.5)
    log(f"demo openpose input {x.shape}")
    xt = torch.from_numpy(x).to(dev)
    out = both("openpose", lambda impl: svc.openpose.net(xt, impl=impl))
    for i, what in enumerate(("openpose paf", "openpose heat")):
        gate(what, out["cuda"][i], out["torch"][i], DEMO_TOLS["openpose"])

    # SCHP: ATR at 512, LIP at 473 (the letterboxed small image)
    for name, size in (("atr", 512), ("lip", 473)):
        net = getattr(svc.parsing, name)
        x, _ = svc.parsing.net_input(small, size)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out = both(name, lambda impl: net(xt, impl=impl)[1])
        gate(f"{name} fusion logits", out["cuda"], out["torch"],
             DEMO_TOLS["schp"])
        agree(f"{name} argmax labels", float(
            (out["cuda"].argmax(-1) == out["torch"].argmax(-1)).float()
            .mean()), DEMO_TOLS["labels"])

    # DensePose at short edge 800 of the 768x1024 person
    bgr, _ = svc.densepose._preprocess(person)
    log(f"demo densepose input {bgr.shape}")
    xt = torch.from_numpy(np.ascontiguousarray(bgr[None])).to(dev)
    rec = {"cuda": {}, "torch": {}}
    out = both("densepose", lambda impl: svc.densepose.model(
        xt, impl=impl, record=rec[impl]))
    for lvl, (a, b) in enumerate(zip(rec["cuda"]["fpn"],
                                     rec["torch"]["fpn"])):
        gate(f"densepose FPN P{lvl + 2} {tuple(a.shape)}", a, b,
             DEMO_TOLS["fpn"])
    gate("densepose pre-NMS RPN scores", rec["cuda"]["rpn_scores"],
         rec["torch"]["rpn_scores"], DEMO_TOLS["rpn_scores"])
    t = time.perf_counter()
    keep = nms_topk(rec["cuda"]["rpn_boxes"], rec["cuda"]["rpn_scores"],
                    iou_threshold=0.7, topk=1000)[2]
    torch.cuda.synchronize()
    log(f"demo densepose RPN NMS alone: {rec['cuda']['rpn_boxes'].shape[0]} "
        f"boxes -> {int((keep >= 0).sum())} kept in "
        f"{time.perf_counter() - t:.4f} s")
    c, p = out["cuda"], out["torch"]
    nc, np_ = int(c["valid"].sum()), int(p["valid"].sum())
    if nc == 0 or np_ == 0:
        fail(f"demo densepose: no detections (cuda {nc}, torch {np_})")
    # the random heads score many detections alike, so near-ties order them
    # differently on the two runs: detections match as sets, one to one,
    # by IoU > 0.9 or, for a box clipped to a line on the border (no
    # area), by coordinates within 1% of the input's longer side
    cb, pb = c["boxes"][c["valid"]], p["boxes"][p["valid"]]
    iou = box_iou(cb, pb)
    flat = lambda b: (b[:, 2:] - b[:, :2]).prod(1) <= 0
    line = flat(cb)[:, None] | flat(pb)[None, :]
    near = (cb[:, None] - pb[None]).abs().amax(-1) <= 0.01 * max(bgr.shape)
    close = torch.where(line, near, iou > 0.9).cpu()
    pairs, taken = [], set()
    for i in range(len(cb)):
        for j in torch.nonzero(close[i]).flatten().tolist():
            if j not in taken:
                pairs.append((i, j))
                taken.add(j)
                break
    matched_iou = [float(iou[i, j]) for i, j in pairs if not line[i, j]]
    log(f"demo densepose detections: cuda {nc}, torch {np_}, {len(pairs)} "
        f"matched ({len(matched_iou)} with area, IoU mean "
        f"{np.mean(matched_iou) if matched_iou else float('nan'):.4f} min "
        f"{min(matched_iou) if matched_iou else float('nan'):.4f}; "
        f"{len(pairs) - len(matched_iou)} clipped to a line)")
    agree(f"densepose detections ({len(pairs)} of {max(nc, np_)} matched)",
          len(pairs) / max(nc, np_), DEMO_TOLS["boxes"])
    if not pairs:
        fail("demo densepose: no detection matches between the runs")
    ci, pi = (torch.tensor(v, device=dev) for v in zip(*pairs))
    lab_c = extract_iuv(c["coarse"], c["fine"], c["u"], c["v"])[0]
    lab_p = extract_iuv(p["coarse"], p["fine"], p["u"], p["v"])[0]
    vc = torch.nonzero(c["valid"]).flatten()
    vp = torch.nonzero(p["valid"]).flatten()
    agree(f"densepose fine labels ({len(pairs)} matched detections)",
          float((lab_c[vc[ci]] == lab_p[vp[pi]]).float().mean()),
          DEMO_TOLS["fine_labels"])
    del out, rec, c, p, xt
    torch.cuda.empty_cache()

    # two demo requests
    exact = {k: CONV_PER_REQUEST[k] + sum(n.get(k, 0)
                                          for n in DEMO_CONV.values())
             for k in CONV_PER_REQUEST}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for req in range(2):
        stages = {}
        t0 = time.perf_counter()
        result, masked = svc.tryon(Image.fromarray(person),
                                   Image.fromarray(garment), "shirt",
                                   auto_mask=True, steps=STEPS, seed=42,
                                   stage_seconds=stages)
        secs = time.perf_counter() - t0
        img, mg = np.asarray(result), np.asarray(masked)
        log(f"demo request {req}: {secs:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
            + f"); result {img.dtype} {img.shape} mean {img.mean():.2f} std "
            f"{img.std():.2f}; masked preview {mg.shape}")
        if img.shape != (HEIGHT, WIDTH, 3) or mg.shape != (HEIGHT, WIDTH, 3):
            fail(f"demo request {req}: images {img.shape}, {mg.shape}")
        if not img.std() > 0:
            fail(f"demo request {req}: a constant image")
    log(f"demo peak memory during the requests: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts = gate_launches(wrappers, "demo",
                           {k: 2 * n for k, n in exact.items()})
    # the service's pipeline and its captured steps reference each other
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

# One full-width training step, impl="cuda" against impl="torch" on the
# same masters and batch (the UNets' sites; the frozen VAE encode takes no
# impl, as JAX's vae_encode, so both run its kernels): (max rel, mean rel)
# bounds as STEP_TOLS's, on TryonNet's noise prediction and on the
# gradients of five leaves, and relative bounds on the loss and the global
# gradient norm. The backward is the plain VJP on both sides, so the
# gradients differ only by where the forward rounded. First reading (an
# H100 80GB HBM3 at 700 W, random biases and norm affines): noise
# prediction max rel 1.93e-2, mean rel 7.3e-3 at the first step, 3.70e-2 /
# 2.35e-2 before the second (after Adam's first step, a sign step of lr on
# every weight, the prediction shrinks: the loss falls from 1.91 to 1.11)
# and 1.42e-2 / 4.6e-3 before the third; the five leaves' gradients max
# rel 4.1e-3 to 7.6e-3, mean rel 2.7e-3 to 4.4e-3; loss 6.1e-4 to 1.5e-3;
# gradient norm 1.7e-3. The bounds sit at 1.5x the largest noise-prediction
# reading (the tiny probe's planted ln_linear and LayerNorm faults read
# mean rel 6.95e-2 and 8.64e-2, STEP_TOLS's note) and at 2.5-3x the others.
TRAIN_TOLS = {"noise_pred": (8e-2, 3.5e-2), "loss": 5e-3, "grad_norm": 5e-3,
              "grads": (2e-2, 1e-2)}
TRAIN_LEAVES = (
    "unet.conv_in.kernel",
    "unet.down_blocks.1.attentions.0.blocks.0.attn1.to_qkv.kernel",
    "unet.down_blocks.1.attentions.0.blocks.0.ff.proj_in.kernel",
    "unet.conv_out.kernel",
    "resampler.proj_in.kernel")
TRAIN_STEPS = 3
TRAIN_TIMESTEP = 500
# the micro CLI run (cli/train.py --micro) at this image size: the VAE's
# 128-channel convs take #5, GroupNorm #3, TryonNet's 32-wide level (4
# heads of 8) over 192 own + 192 garment keys #9 (GarmentNet's 192 keys
# stay on the plain formula, as in JAX)
TRAIN_CLI_SIZE = (192, 256)
# adamw8bit steps after phase 10's adamw ones
TRAIN8_STEPS = 2


# adamw8bit's kernel against the plain per-leaf update after one step from
# the same state: codes equal or one apart (a log10 rounding tie between two
# fp32 paths), at least ``codes`` of them equal; each master within fp32
# rounding of the plain one (2 ulp of |p|, and 1e-4 of lr) for at least
# ``masters`` of the elements and within one code level's effect (15% of
# lr) for all; the global norm within ``norm`` relative (fp64 partials
# against fp32 sums). The decay term, lr * wd * |p| = 1e-4 |p|, is then
# some 400 times the rounding allowed: a kernel that drops it or flips its
# sign fails (at lr 1e-5 and wd 1e-2 it would be under one ulp of |p|)
ADAM_TOLS = {"codes": 0.999, "masters": 0.999, "norm": 1e-5}
ADAM_LR = 1e-3
ADAM_WD = 0.1


def adam_int8_bytes(sizes, nblocks_used: int) -> int:
    """The least bytes one fused step moves: each gradient read twice (the
    norm and the update), each master read and written, both int8 moment
    codes read and written, and their fp32 block scales read and written."""
    n = sum(sizes)
    return 8 * n + 8 * n + 4 * n + 16 * nblocks_used


def check_adam_int8(dev, card):
    """Phase 10d: adamw8bit's kernel on the full trainable tree. Returns
    the kernels line's entries of its two launches."""
    import torch
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train import quant_opt
    from idmvton_tpu_torch.train.train_step import (
        flat_params, global_norm, make_optimizer,
    )
    meta = TryonModels.init(None, device="meta", dtype=torch.float32)
    shapes = flat_params({c: dict(getattr(meta, c).named_parameters())
                          for c in ("unet", "resampler")})
    del meta
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    masters = {k: torch.randn(p.shape, generator=gen, device=dev) * 0.02
               for k, p in shapes.items()}
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-4
             for k, p in shapes.items()}
    sizes = [p.numel() for p in masters.values()]
    tx = make_optimizer(learning_rate=ADAM_LR, weight_decay=ADAM_WD,
                        optimizer="adamw8bit")
    state = tx.init(masters)
    tx.update_(grads, state, masters)          # moments away from zero
    torch.cuda.synchronize()
    table = tx._table
    log(f"adam_int8: {len(sizes)} leaves, {sum(sizes) / 1e9:.3f} B "
        f"parameters, {table.used} blocks, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")

    # one step, kernel against the plain update on copies of the state
    p_masters = {k: p.clone() for k, p in masters.items()}
    p_state = {k: v.clone() if torch.is_tensor(v) else v
               for k, v in state.items()}
    norm = tx.global_norm(grads, masters)
    want_norm = global_norm(grads.values())
    norm_rel = abs(float(norm) - float(want_norm)) / float(want_norm)
    before = (quant_opt.fused_global_norm.launches,
              quant_opt.adamw_int8_fused_.launches)
    tx.update_(grads, state, masters, norm=norm)
    launched = (quant_opt.fused_global_norm.launches - before[0],
                quant_opt.adamw_int8_fused_.launches - before[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not bool(want_norm < tx.max_grad_norm):
        for g in grads.values():
            g.div_(want_norm).mul_(tx.max_grad_norm)
    tx._adamw8bit(grads, p_state, p_masters)
    for k, p in p_masters.items():
        p.add_(grads[k])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    equal = worst_code = 0
    rows = 1 << 20                   # 256 MiB of codes at a time
    for m in ("mu", "nu"):
        for i in range(0, state[f"{m}_q"].shape[0], rows):
            d = (state[f"{m}_q"][i:i + rows].short()
                 - p_state[f"{m}_q"][i:i + rows].short()).abs()
            worst_code = max(worst_code, int(d.max()))
            equal += int((d == 0).sum())
    codes_equal = equal / (2 * state["mu_q"].numel())
    close = worst = 0.0
    for k, p in masters.items():
        err = (p - p_masters[k]).abs()
        tol = p_masters[k].abs() * 2.0 ** -22 + 1e-4 * ADAM_LR
        close += int((err <= tol).sum())
        worst = max(worst, float(err.max()))
    masters_close = close / sum(sizes)
    log(f"adam_int8: kernel vs plain after one step: codes equal "
        f"{codes_equal:.6f} (max |diff| {worst_code}), masters within "
        f"rounding {masters_close:.6f} (max |diff| {worst:.3e}, lr "
        f"{ADAM_LR:g}, wd {ADAM_WD:g}), norm rel {norm_rel:.2e}; launches "
        f"norm / update {launched}")
    if (worst_code > 1 or codes_equal < ADAM_TOLS["codes"]
            or masters_close < ADAM_TOLS["masters"]
            or worst > 0.15 * ADAM_LR or norm_rel > ADAM_TOLS["norm"]
            or launched != (0, 1)):
        fail("adam_int8: the kernel departs from the plain update")
    del p_masters, p_state
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-4
             for k, p in masters.items()}
    torch.cuda.empty_cache()

    # times: the norm, the update (clip on), the whole optimizer phase
    plain_norm_ms = cuda_time_ms(lambda: global_norm(grads.values()))
    norm = quant_opt.fused_global_norm(table, grads)
    hp = dict(b1=tx.b1, b2=tx.b2, eps=tx.eps, weight_decay=tx.wd, lr=tx.lr,
              clip=norm, max_norm=tx.max_grad_norm)
    update = lambda: quant_opt.adamw_int8_fused_(table, grads, masters,
                                                 state, **hp)
    norm_fn = lambda: quant_opt.fused_global_norm(table, grads)
    bound_ms = adam_int8_bytes(sizes, table.used) / 3.35e12 * 1e3
    norm_bound_ms = 4 * sum(sizes) / 3.35e12 * 1e3
    res = {"norm_ms": cuda_time_ms(norm_fn), "update_ms": cuda_time_ms(update),
           "norm_graph_ms": graph_ms(norm_fn), "update_graph_ms":
           graph_ms(update)}
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update_(grads, state, masters, norm=tx.global_norm(grads,
                                                               masters))
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    res.update(bound_ms=bound_ms, norm_bound_ms=norm_bound_ms,
               plain_ms=plain_s * 1e3, phase_host_ms=min(host) * 1e3,
               roofline=bound_ms / (res["norm_graph_ms"]
                                    + res["update_graph_ms"]))
    log(f"adam_int8 ({card}): " + json.dumps(
        {k: round(v, 4) for k, v in res.items()}))
    del masters, grads, state, tx, table
    torch.cuda.empty_cache()
    entry = {"route": "cuda", "source": "idmvton_tpu_torch/ops/csrc/"
             "adam_int8.cu", "replaces": "idmvton_tpu/train/quant_opt.py:117 "
             "(one XLA program, no Pallas kernel)", "bound_by": "bytes",
             "library_ms": None, "library": None, "library_graph_ms": None,
             "shapes": 1}
    return {
        "adam_int8_update": dict(
            entry, name="adam_int8_update", max_abs_err=worst,
            max_rel_err=worst / ADAM_LR, tol_rel=0.15, ms=res["update_ms"],
            plain_ms=res["plain_ms"], bound_ms=bound_ms,
            graph_ms=res["update_graph_ms"]),
        "adam_int8_norm": dict(
            entry, name="adam_int8_norm",
            max_abs_err=norm_rel * float(want_norm), max_rel_err=norm_rel,
            tol_rel=ADAM_TOLS["norm"], ms=res["norm_ms"],
            plain_ms=plain_norm_ms, bound_ms=norm_bound_ms,
            graph_ms=res["norm_graph_ms"])}


def check_kernel_grads(dev):
    """Each kernel with an autograd Function (``ops.autograd``) at its
    phase-3 shapes: the gradient of every differentiable input through the
    Function (the kernel forward, the plain version's VJP) against plain
    autograd's, max |diff| / max |plain|, within BF16_TOL; forward +
    backward timed both ways (CUDA events, 3 runs after 2). Returns
    {kernel: backward readings}."""
    import torch
    out = {}
    for name, _, _, _, cases in kernel_cases(dev):
        worst, ms, plain_ms, n = 0.0, 0.0, 0.0, 0
        for c in cases:
            if "vjp" not in c:
                continue
            entry, ins, kw, plain, *wrt = c["vjp"]
            wrt = [i for i in (wrt[0] if wrt else range(len(ins)))
                   if ins[i] is not None and ins[i].is_floating_point()]
            gen = torch.Generator(device=dev).manual_seed(SEED + 5)

            def run(fn):
                xs = [t if t is None else t.detach().clone()
                      .requires_grad_(i in wrt) for i, t in enumerate(ins)]
                outs = fn(*xs, **kw)
                outs = outs if isinstance(outs, tuple) else (outs,)
                cots = [torch.randn(o.shape, generator=gen.manual_seed(
                    SEED + 5), device=dev).to(o.dtype) for o in outs]
                return torch.autograd.grad(outs, [xs[i] for i in wrt], cots)

            got, want = run(entry), run(plain)
            torch.cuda.synchronize()
            err = max(errors(g, w)[1] for g, w in zip(got, want))
            if not all(g.dtype == w.dtype for g, w in zip(got, want)):
                fail(f"{name} {c['label']}: gradient types differ")
            del got, want
            k_ms = cuda_time_ms(lambda: run(entry), iters=3)
            p_ms = cuda_time_ms(lambda: run(plain), iters=3)
            log(f"kernel {name} {c['label']} backward: gradients max rel "
                f"err {err:.3e} (tol {BF16_TOL:g}) against plain autograd; "
                f"forward + backward {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if not err <= BF16_TOL:
                fail(f"{name} {c['label']}: gradient error {err}")
            worst, ms, plain_ms, n = (max(worst, err), ms + k_ms,
                                      plain_ms + p_ms, n + 1)
            torch.cuda.empty_cache()
        if n:
            out[name] = {"grad_max_rel_err": worst, "grad_tol_rel": BF16_TOL,
                         "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms,
                         "shapes": n}
    return out


def train_batch(models, dev, gen):
    """One full-width training sample (batch 1, HEIGHT x WIDTH) from the
    seed, with the noise and timestep given (both impls then draw
    nothing)."""
    import torch
    ds = models.vae_cfg.downscale
    img = lambda: (torch.rand(1, HEIGHT, WIDTH, 3, generator=gen,
                              device=dev) * 2 - 1)
    ids = lambda: torch.randint(0, models.clip_l_cfg.vocab_size, (1, 77),
                                generator=gen, device=dev)
    mask = torch.zeros(1, HEIGHT, WIDTH, 1, device=dev)
    mask[:, HEIGHT // 5:4 * HEIGHT // 5, WIDTH // 6:5 * WIDTH // 6] = 1
    isz = models.vision_cfg.image_size
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                cloth_ids_g=ids(),
                ip_pixels=torch.rand(1, isz, isz, 3, generator=gen,
                                     device=dev) * 2 - 1,
                noise=torch.randn(1, HEIGHT // ds, WIDTH // ds, 4,
                                  generator=gen, device=dev),
                timesteps=torch.tensor([TRAIN_TIMESTEP], device=dev))


def train_sites(models, state, sched, batch, wrappers):
    """The launches of one training forward: the loss under no_grad (each
    frozen tower once, TryonNet once, nothing recomputed), and of those the
    ones inside TryonNet's resnet blocks and Transformer2Ds (read by
    hooks), which remat runs again in the backward. A train step's exact
    count is their sum: no kernel runs in a backward."""
    import torch
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

    blocks = [m for m in models.unet.modules()
              if isinstance(m, (ResnetBlock, Transformer2D))]
    hooks = [h for m in blocks for h in (m.register_forward_pre_hook(pre),
                                         m.register_forward_hook(post))]
    for w in wrappers.values():
        w.launches = 0
    try:
        with torch.no_grad():
            tryon_loss(state.trainable, models, sched, batch, impl="cuda",
                       vae_sample=False)
    finally:
        for h in hooks:
            h.remove()
    once = {k: w.launches for k, w in wrappers.items()}
    return once, remat, len(blocks)


def train_readings(models, state, sched, batch, impl, grads: bool):
    """The loss, TryonNet's output (read by a hook) and, with ``grads``,
    the global gradient norm and the gradients of TRAIN_LEAVES, of one
    training forward with ``impl``."""
    import torch
    from idmvton_tpu_torch.train.train_step import (
        flat_params, global_norm, tryon_loss,
    )
    out = {}

    def read(mod, args, res):
        out.setdefault("pred", res[0].detach())

    hook = models.unet.register_forward_hook(read)
    try:
        with torch.set_grad_enabled(grads):
            loss = tryon_loss(state.trainable, models, sched, batch,
                              impl=impl, vae_sample=False)
            out["loss"] = float(loss.detach())
            if grads:
                params = flat_params(state.trainable)
                gs = torch.autograd.grad(loss, list(params.values()))
                out["grad_norm"] = float(global_norm(gs))
                out["grads"] = {k: g for k, g in zip(params, gs)
                                if k in TRAIN_LEAVES}
                del gs
    finally:
        hook.remove()
    return out


def gate_train_readings(label, got, want, tols):
    """Fails where ``got`` (impl="cuda") differs from ``want`` ("torch")
    by more than ``tols`` (TRAIN_TOLS's layout); logs every reading."""
    pairs = [("noise_pred", got["pred"], want["pred"], tols["noise_pred"])]
    pairs += [(k, got["grads"][k], want["grads"][k], tols["grads"])
              for k in got.get("grads", {})]
    for what, a, b, (max_tol, mean_tol) in pairs:
        a, b = a.float(), b.float()
        rel = errors(a, b)[1]
        mean_rel = float((a - b).abs().mean() / b.abs().mean())
        log(f"{label} {what} cuda vs torch: max rel {rel:.3e} (tol "
            f"{max_tol:g}), mean rel {mean_rel:.3e} (tol {mean_tol:g})")
        if not (rel <= max_tol and mean_rel <= mean_tol):
            fail(f"{label}: {what} cuda vs torch max rel {rel}, mean rel "
                 f"{mean_rel}")
    for what in ("loss", "grad_norm"):
        if what not in got:
            continue
        rel = abs(got[what] - want[what]) / max(abs(want[what]), 1e-12)
        log(f"{label} {what} cuda {got[what]:.6g} torch {want[what]:.6g}: "
            f"rel {rel:.3e} (tol {tols[what]:g})")
        if not rel <= tols[what]:
            fail(f"{label}: {what} cuda {got[what]} torch {want[what]}")


def check_train(wrappers, dev, card):
    """Phase 10's full-width part: the sdxl_tryon TryonNet and the
    Resampler trained (fp32 masters, bf16 compute, remat, adamw) beside the
    phase-4 stack's frozen towers (random biases and norm affines), batch 1
    at HEIGHT x WIDTH, SchedulerConfig.train(). One step's loss, noise
    prediction and gradients impl="cuda" against impl="torch"; then
    TRAIN_STEPS adamw steps through ``make_train_step`` on the card, each
    finite, moving the parameters and launching exactly the forward's
    kernels plus the rematerialized blocks' again, with the forward before
    steps 2 and 3 held cuda against torch on the updated masters. Then
    TRAIN8_STEPS adamw8bit steps through ``make_train_step``, each finite,
    moving the masters, launching the adamw steps' kernels and adamw8bit's
    norm and update once, and counting every block of the tree in
    ``adamw8bit.fused_blocks``. Returns the launch counts of both paths."""
    import gc
    import torch
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.quant_opt import BLOCK
    from idmvton_tpu_torch.train.train_step import (
        flat_params, init_train_state, make_optimizer, make_train_step,
    )
    from idmvton_tpu_torch.utils.profiling import counters
    t0 = time.perf_counter()
    models = TryonModels.init(SEED, device=dev, dtype=torch.bfloat16)
    for i, module in enumerate(models.components().values()):
        random_affine_(module, SEED + 10 + i)
    tx = make_optimizer()
    state = init_train_state(models, tx)
    n_train = sum(p.numel() for p in flat_params(state.trainable).values())
    torch.cuda.synchronize()
    log(f"train: {n_train / 1e9:.3f} B trainable fp32 masters + adamw "
        f"moments in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    sched = DDPMScheduler(SchedulerConfig.train())
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    batch = train_batch(models, dev, gen)

    once, remat, n_blocks = train_sites(models, state, sched, batch, wrappers)
    exact = {k: once[k] + remat[k] for k in wrappers}
    log(f"train step sites: forward {once}; again in the backward "
        f"({n_blocks} rematerialized TryonNet blocks) {remat}")

    readings = {impl: train_readings(models, state, sched, batch, impl, True)
                for impl in ("cuda", "torch")}
    gate_train_readings("train step", readings["cuda"], readings["torch"],
                        TRAIN_TOLS)
    del readings
    gc.collect()
    torch.cuda.empty_cache()

    step = make_train_step(models, sched, tx, impl="cuda", vae_sample=False)
    watch = "unet.down_blocks.1.attentions.0.blocks.0.attn1.to_qkv.kernel"
    counts = dict.fromkeys(wrappers, 0)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(TRAIN_STEPS):
        if i:
            got, want = (train_readings(models, state, sched, batch, impl,
                                        False) for impl in ("cuda", "torch"))
            gate_train_readings(f"train forward before step {i + 1}", got,
                                want, TRAIN_TOLS)
            del got, want
        before = flat_params(state.trainable)[watch].detach().clone()
        for w in wrappers.values():
            w.launches = 0
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        step_counts = {k: w.launches for k, w in wrappers.items()}
        moved = float((flat_params(state.trainable)[watch].detach()
                       - before).abs().max())
        log(f"train step {i + 1}: {secs[-1]:.3f} s, loss {loss:.6g}, "
            f"grad norm {gnorm:.6g}, {watch} moved by {moved:.3e}; "
            f"launches {step_counts}")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and moved > 0):
            fail(f"train step {i + 1}: loss {loss}, grad norm {gnorm}, "
                 f"moved {moved}")
        if step_counts != exact:
            fail(f"train step {i + 1}: launches {step_counts}, expected "
                 f"{exact}")
        for k, n in step_counts.items():
            counts[k] += n
    for k, w in wrappers.items():
        w.launches = counts[k]
    counts = gate_launches(wrappers, "train")
    warm = secs[1:]
    log(f"train: {card}; seconds a step {', '.join(f'{s:.3f}' for s in secs)}"
        f" (warm mean {sum(warm) / len(warm):.3f} s, "
        f"{len(warm) / sum(warm):.3f} img/s at batch 1); peak memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB "
        f"(adamw, the serving TryonNet's bf16 copy kept)")

    # the benchmark's optimizer through the same step
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    tx = make_optimizer(optimizer="adamw8bit")
    state = init_train_state(models, tx)
    step = make_train_step(models, sched, tx, impl="cuda", vae_sample=False)
    tree_blocks = sum(-(-p.numel() // BLOCK)
                      for p in flat_params(state.trainable).values())
    exact8 = dict(exact, adam_int8_update=1, adam_int8_norm=1)
    counts8 = dict.fromkeys(wrappers, 0)
    for i in range(TRAIN8_STEPS):
        before = flat_params(state.trainable)[watch].detach().clone()
        walked = counters().get("adamw8bit.fused_blocks", 0)
        for w in wrappers.values():
            w.launches = 0
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        walked = counters().get("adamw8bit.fused_blocks", 0) - walked
        step_counts = {k: w.launches for k, w in wrappers.items()}
        moved = float((flat_params(state.trainable)[watch].detach()
                       - before).abs().max())
        log(f"train adamw8bit step {i + 1}: {secs:.3f} s, loss {loss:.6g}, "
            f"grad norm {gnorm:.6g}, {watch} moved by {moved:.3e}; blocks "
            f"updated {walked} of {tree_blocks}; launches {step_counts}")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and moved > 0):
            fail(f"train adamw8bit step {i + 1}: loss {loss}, grad norm "
                 f"{gnorm}, moved {moved}")
        if step_counts != exact8 or walked != tree_blocks:
            fail(f"train adamw8bit step {i + 1}: launches {step_counts}, "
                 f"expected {exact8}; blocks {walked} of {tree_blocks}")
        for k, n in step_counts.items():
            counts8[k] += n
    for k, w in wrappers.items():
        w.launches = counts8[k]
    counts8 = gate_launches(wrappers, "train_adamw8bit")
    del models, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": counts, "train_adamw8bit": counts8}


def write_viton_tree(root, phase, n, size):
    """A synthetic VITON-HD split of n seeded samples (images, DensePose
    images, garments, agnostic masks, pairs, tagged captions) at ``size``
    (width, height)."""
    import numpy as np
    from PIL import Image
    w, h = size
    names = [f"{i:05d}_00.jpg" for i in range(n)]
    for sub in ("image", "cloth", "image-densepose", "agnostic-mask"):
        os.makedirs(os.path.join(root, phase, sub), exist_ok=True)
    rng = np.random.RandomState(SEED)
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


def check_train_cli(wrappers):
    """Phase 10's CLI part: ``cli.train.main --micro`` on the card over a
    synthetic VITON-HD tree in a temporary directory: 2 optimizer steps of
    2 micro-batches (--gradient_accumulation_steps 2), a checkpoint at each
    (``step_{n}``: the trained stack; the train state), eval images at step
    2 (``stepwise_generate``), then ``--resume_from_checkpoint`` on to step
    3. Returns both runs' launch counts."""
    import shutil
    import tempfile
    from idmvton_tpu_torch.cli import train as cli_train
    tmp = tempfile.mkdtemp(prefix="idm_train_cli_")
    try:
        root, out = os.path.join(tmp, "viton"), os.path.join(tmp, "out")
        write_viton_tree(root, "train", 4, TRAIN_CLI_SIZE)
        write_viton_tree(root, "test", 2, TRAIN_CLI_SIZE)
        w, h = TRAIN_CLI_SIZE
        common = ["--data_dir", root, "--output_dir", out, "--micro",
                  "--width", str(w), "--height", str(h),
                  "--train_batch_size", "1",
                  "--gradient_accumulation_steps", "2",
                  "--checkpointing_steps", "1", "--logging_steps", "1",
                  "--device", "cuda"]
        for k in wrappers.values():
            k.launches = 0
        t0 = time.perf_counter()
        state = cli_train.main(common + ["--max_steps", "2", "--eval_steps",
                                         "2", "--num_inference_steps", "2",
                                         "--test_batch_size", "2"])
        first = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        states = sorted(os.listdir(os.path.join(out, "state")))
        log(f"train cli: {first:.1f} s, micro-steps {state.step}; "
            f"{files}; states {states}")
        if (state.step != 4 or states != ["state_2", "state_4"]
                or not {"step_1", "step_2", "2_0_test.jpg",
                        "2_1_test.jpg"} <= set(files)):
            fail(f"train cli: step {state.step}, files {files}, states "
                 f"{states}")
        t0 = time.perf_counter()
        state = cli_train.main(common + ["--max_steps", "3",
                                         "--resume_from_checkpoint",
                                         os.path.join(out, "state")])
        states = sorted(os.listdir(os.path.join(out, "state")))
        log(f"train cli resumed: {time.perf_counter() - t0:.1f} s, "
            f"micro-steps {state.step}; states {states}")
        if state.step != 6 or not os.path.isdir(os.path.join(out, "step_3")):
            fail(f"train cli resume: step {state.step}, states {states}")
        return gate_launches(wrappers, "train_cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



# ---------------------------------------------------------------------------
# phase 11: DensePose detection training; phase 12: Face and Hand; phase 13:
# detection evaluation
# ---------------------------------------------------------------------------

# The R-50-FPN trained at its served config (DensePoseConfig(),
# DetectionTrainConfig(): RPN 256 and ROI 512 an image, 1000 post-NMS
# proposals over every anchor, a 16-slot densepose slab, the 8x512 head at
# heatmap 112), B images of DP_TRAIN_HW with G persons each (P annotated
# points, an M x M mask)
DP_TRAIN_HW = (800, 1088)
DP_TRAIN_B, DP_TRAIN_G, DP_TRAIN_P, DP_TRAIN_M = 2, 3, 128, 56
DP_TRAIN_STEPS = 3
# The conv sites of one train step, read from the code (3x3, stride 1,
# SAME, Cin and Cout >= 128, W >= 8; from 32 MiB an fp32 image conv3x3_hblock):
# res3-res5's conv2 (4 + 6 + 3), the FPN outputs P3-P5 (3), the RPN conv on
# P3-P6 (4), the decoder's 1 + 2 + 3 above P2 and the densepose head's 8
# convs on each image's slab (2 x 8): 42; the FPN output, the RPN conv and
# the decoder conv at P2 (200x272x256, 53 MiB): 3. The forward launches
# them once under autograd; the backward is the plain VJP (no kernel).
DP_TRAIN_CONV = {"conv3x3": 42, "conv3x3_hblock": 3}
# one train step impl="cuda" against impl="torch" (fp32 plain, TF32 off) on
# the same parameters, uniforms and (replayed) proposals: each loss's
# relative difference, and (max rel, mean rel) on the gradients of
# DP_TRAIN_LEAVES (kernel sites: res3's conv2, the FPN output at P2 (#6),
# the RPN conv, the head's last conv). The kernels narrow fp32 x to bf16
# at 45 sites. First reading (an H100 80GB HBM3 at 700 W, twice the same):
# losses rel 3.7e-7 (loss_densepose_I) to 2.4e-3 (loss_cls); gradients max
# rel 1.9e-2 to 2.8e-2, mean rel 7.2e-3 to 3.0e-2 (res3's conv2). The
# bounds sit at about 3-4x those.
DP_TRAIN_TOLS = {"loss": 1e-2, "grads": (1e-1, 1e-1)}
DP_TRAIN_LEAVES = ("backbone.res3.0.conv2.conv.kernel", "fpn.output.0.kernel",
                   "rpn.conv.kernel", "dp_head.convs.7.kernel")
# Face at 384 and Hand at its four scales (184 / 368 / 552 / 736): the
# trunk's conv2_2 .. conv5_3_CPM, 12 sites a net call (read on an H100);
# of Hand's 48, five inputs reach 32 MiB and take conv3x3_hblock: conv2_2
# at 552 (276^2 x 128 fp32) and at 736 (368^2 x 128), conv3_2-3_4 at 736
# (184^2 x 256)
FACE_CONV = {"conv3x3": 12}
HAND_CONV = {"conv3x3": 43, "conv3x3_hblock": 5}
# the heatmaps impl="cuda" against impl="torch": (max rel, mean rel), and
# the share of peaks at the same pixel from below. First reading (an H100
# 80GB HBM3 at 700 W, random biases): Face max rel 2.3e-4, mean rel
# 9.1e-5, 38 of 71 channels above threshold, every peak equal; Hand 2.5e-4
# / 1.0e-4, 8 of 21 parts found, every peak equal. The bounds sit at about
# 4x the continuous readings; a flipped peak of a near-tie costs 1/71 or
# 1/21 of the rate.
FACE_HAND_TOLS = {"face": (1e-3, 4e-4), "hand": (1e-3, 4e-4), "peaks": 0.9}
# DensePose.detect over three seeded images through inference_on_dataset
# (short edge 800 of 480x640: 800x1067 padded to 800x1088): DEMO_CONV's
# R-CNN sites an image
EVAL_IMAGES = 3


def dp_train_batch(dev, seed):
    """DP_TRAIN_B mean-subtracted BGR images and their ground truth, drawn
    on the card: G person boxes an image, P points in each (fine labels
    0-24, U / V in [0, 1)), an elliptic M x M mask each."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    (h, w), b, n, p, m = DP_TRAIN_HW, DP_TRAIN_B, DP_TRAIN_G, DP_TRAIN_P, \
        DP_TRAIN_M
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    mean = torch.tensor([103.530, 116.280, 123.675], device=dev)
    images = u(b, h, w, 3) * 255 - mean
    bw, bh = (0.15 + 0.25 * u(b, n)) * w, (0.3 + 0.4 * u(b, n)) * h
    x1, y1 = u(b, n) * (w - bw), u(b, n) * (h - bh)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, m, device=dev),
                            torch.linspace(-1, 1, m, device=dev),
                            indexing="ij")
    radius = 0.6 + 0.35 * u(b, n, 1, 1)
    gts = {"boxes": torch.stack([x1, y1, x1 + bw, y1 + bh], -1),
           "valid": torch.ones(b, n, dtype=torch.bool, device=dev),
           "dp_x": x1[..., None] + u(b, n, p) * bw[..., None],
           "dp_y": y1[..., None] + u(b, n, p) * bh[..., None],
           "dp_i": torch.randint(0, 25, (b, n, p), generator=g, device=dev),
           "dp_u": u(b, n, p), "dp_v": u(b, n, p),
           "dp_pt_valid": torch.ones(b, n, p, dtype=torch.bool, device=dev),
           "dp_mask": (xx ** 2 + yy ** 2)[None, None] < radius ** 2}
    return images, gts


def check_dp_train(wrappers, dev, card):
    """Phase 11: the DensePose R-CNN (stem scaled to the mean-subtracted
    pixels, as phase 6b) trained at DP_TRAIN_HW, batch DP_TRAIN_B: one
    step's losses and four leaves' gradients impl="cuda" against
    impl="torch" on the same uniforms, the torch run replaying the cuda
    run's proposals (NMS over 217,413 boxes ranks near-equal scores by
    bf16 rounding), the sampled sets identical; nms_topk alone on one
    image's boxes; then DP_TRAIN_STEPS masked SGD steps through
    make_detection_train_step, each finite and launching exactly
    DP_TRAIN_CONV, stem, res2 and every frozen BN bitwise unchanged.
    Returns the steps' launch counts."""
    import gc
    import torch
    from idmvton_tpu_torch.ops.nms import nms_topk
    from idmvton_tpu_torch.preprocess.densepose import rcnn
    from idmvton_tpu_torch.preprocess.densepose import train as dt
    t0 = time.perf_counter()
    cfg, tcfg = rcnn.DensePoseConfig(), dt.DetectionTrainConfig()
    model = rcnn.init_densepose_rcnn(SEED + 60, cfg, device=dev)
    with torch.no_grad():
        model.backbone.stem.conv.kernel.div_(50.0)
    params = dt.detection_params(model)
    tx = dt.make_detection_optimizer(tcfg, params)
    images, gts = dp_train_batch(dev, SEED + 61)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for k, p in params.items() if tx.trains(k))
    log(f"dp train: R-50-FPN {sum(p.numel() for p in params.values()) / 1e6:.2f}"
        f" M parameters ({n_train / 1e6:.2f} M trained), batch "
        f"{tuple(images.shape)}, {DP_TRAIN_G} persons an image, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the uniforms both runs sample with
    with torch.no_grad():
        _, anchors, obj, dl = dt._features(model, images, "cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    n_anchors, n_prop = anchors.shape[0], cfg.rpn_post_nms_topk + DP_TRAIN_G
    uniforms = [[torch.rand(n, generator=g, device=dev)
                 for n in (n_anchors, n_prop, n_prop)]
                for _ in range(DP_TRAIN_B)]
    # nms_topk alone on image 0's boxes: the trainer's NMS over all anchors
    prop = rcnn.clip_boxes(rcnn.apply_deltas(anchors, dl[0],
                                             (1.0,) * 4), DP_TRAIN_HW)
    secs, rec = [], {}
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nms_topk(prop, obj[0], iou_threshold=cfg.rpn_nms_thresh,
                 topk=cfg.rpn_post_nms_topk, record=rec)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    log(f"dp train nms_topk: {n_anchors} boxes, {rec['visited']} visited "
        f"before the {cfg.rpn_post_nms_topk}th kept; "
        + ", ".join(f"{1e3 * s:.2f}" for s in secs) + f" ms; {card}")
    del anchors, obj, dl, prop

    for k, p in params.items():
        p.requires_grad_(tx.trains(k))
    out = {}
    for impl in ("cuda", "torch"):
        for w in wrappers.values():
            w.launches = 0
        rec = []
        total, losses = dt.detection_total_loss(
            model, params, images, gts, tcfg=tcfg, uniforms=uniforms,
            impl=impl, record=rec, proposals=None if impl == "cuda" else
            [r["prop_idx"] for r in out["cuda"]["record"]])
        leaves = [params[k] for k in DP_TRAIN_LEAVES]
        grads = torch.autograd.grad(total, leaves)
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        want = DP_TRAIN_CONV if impl == "cuda" else {}
        log(f"dp train loss impl={impl}: total {float(total.detach()):.6g}, "
            + ", ".join(f"{k} {float(v.detach()):.5g}"
                        for k, v in losses.items())
            + f"; launches {counts}; sampled: "
            + "; ".join(f"anchors {int(r['rpn_w'].sum())}, proposals kept "
                        f"{int((r['prop_idx'] >= 0).sum())}, rois "
                        f"{int(r['roi_w'].sum())} ({int((r['fg'] & (r['roi_w'] > 0)).sum())}"
                        f" fg), slab {int(r['dp_valid'].sum())}" for r in rec))
        if counts != want:
            fail(f"dp train impl={impl}: launches {counts}, expected {want}")
        out[impl] = dict(losses={k: float(v) for k, v in losses.items()},
                         grads=[gr.detach() for gr in grads], record=rec)
        del total, losses, grads
    for rc, rt in zip(out["cuda"]["record"], out["torch"]["record"]):
        for key in ("rpn_w", "prop_idx", "roi_w", "fg", "dp_idx", "dp_valid"):
            if not torch.equal(rc[key], rt[key]):
                fail(f"dp train: sampled set {key} differs between the "
                     f"cuda and torch runs")
    log("dp train: sampled sets identical (anchors, proposals, rois, fg, "
        "slab) between the cuda and torch runs")
    for k, want in out["torch"]["losses"].items():
        got = out["cuda"]["losses"][k]
        rel = abs(got - want) / max(abs(want), 1e-12)
        log(f"dp train {k} cuda {got:.6g} torch {want:.6g}: rel {rel:.3e} "
            f"(tol {DP_TRAIN_TOLS['loss']:g})")
        if not (math.isfinite(got) and rel <= DP_TRAIN_TOLS["loss"]):
            fail(f"dp train {k}: cuda {got}, torch {want}")
    for name, a, b in zip(DP_TRAIN_LEAVES, out["cuda"]["grads"],
                          out["torch"]["grads"]):
        rel, mrel = errors(a, b)[1], mean_rel(a, b)
        log(f"dp train grad {name} cuda vs torch: max rel {rel:.3e} (tol "
            f"{DP_TRAIN_TOLS['grads'][0]:g}), mean rel {mrel:.3e} (tol "
            f"{DP_TRAIN_TOLS['grads'][1]:g})")
        if not (rel <= DP_TRAIN_TOLS["grads"][0]
                and mrel <= DP_TRAIN_TOLS["grads"][1]):
            fail(f"dp train grad {name}: max rel {rel}, mean rel {mrel}")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # the masked SGD steps
    step = dt.make_detection_train_step(tcfg, tx, impl="cuda")
    state = tx.init(params)
    frozen = {k: p.detach().clone() for k, p in params.items()
              if not tx.trains(k)}
    watch = "dp_head.convs.7.kernel"
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    counts = dict.fromkeys(wrappers, 0)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(DP_TRAIN_STEPS):
        before = params[watch].detach().clone()
        for w in wrappers.values():
            w.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        rec = []
        start.record()
        state, metrics = step(model, params, state, images, gts, gen,
                              record=rec)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        step_counts = {k: w.launches for k, w in wrappers.items()
                       if w.launches}
        vals = {k: float(v) for k, v in metrics.items()}
        moved = float((params[watch].detach() - before).abs().max())
        log(f"dp train step {i + 1}: {ms[-1]:.1f} ms, "
            + ", ".join(f"{k} {v:.5g}" for k, v in vals.items())
            + f"; {watch} moved by {moved:.3e}; NMS visited "
            f"{[r['nms_visited'] for r in rec]}; launches {step_counts}")
        if not (all(math.isfinite(v) for v in vals.values()) and moved > 0):
            fail(f"dp train step {i + 1}: losses {vals}, moved {moved}")
        if step_counts != DP_TRAIN_CONV:
            fail(f"dp train step {i + 1}: launches {step_counts}, expected "
                 f"{DP_TRAIN_CONV}")
        for k, n in step_counts.items():
            counts[k] += n
    moved = [k for k, p in frozen.items() if not torch.equal(params[k], p)]
    log(f"dp train: {len(frozen)} frozen leaves (stem, res2, every BN) "
        f"bitwise unchanged after {DP_TRAIN_STEPS} steps: {not moved}")
    if moved:
        fail(f"dp train: frozen leaves moved: {moved[:5]}")
    warm = ms[1:]
    log(f"dp train: {card}; ms a step {', '.join(f'{v:.1f}' for v in ms)} "
        f"(warm mean {sum(warm) / len(warm):.1f} ms, "
        f"{1e3 * DP_TRAIN_B * len(warm) / sum(warm):.3f} img/s at batch "
        f"{DP_TRAIN_B}); peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
    for k, w in wrappers.items():
        w.launches = counts[k]
    counts = gate_launches(wrappers, "densepose_train",
                           {k: DP_TRAIN_STEPS * n
                            for k, n in DP_TRAIN_CONV.items()})
    del model, params, state, step, images, gts
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_face_hand(wrappers, dev, card):
    """Phase 12: ``Face`` at 384 and ``Hand`` at its four scales on seeded
    crops, their nets from seeds with random biases: heatmaps
    impl="cuda" against impl="torch" (FACE_HAND_TOLS), the peaks' agreement,
    each cuda call launching exactly FACE_CONV / HAND_CONV. Returns the
    cuda calls' launch counts."""
    import numpy as np
    import torch
    from idmvton_tpu_torch.preprocess import openpose_extra as ox
    rng = np.random.default_rng(SEED + 70)
    face_img = rng.integers(0, 256, (200, 160, 3), np.uint8)
    hand_img = rng.integers(0, 256, (180, 180, 3), np.uint8)
    nets = {"face": ox.init_facenet(SEED + 71, device=dev),
            "hand": ox.init_handpose(SEED + 72, device=dev)}
    for i, net in enumerate(nets.values()):
        random_affine_(net, SEED + 73 + i)
    counts = dict.fromkeys(wrappers, 0)
    for name, img, want_conv in (("face", face_img, FACE_CONV),
                                 ("hand", hand_img, HAND_CONV)):
        wrap = {impl: (ox.Face if name == "face" else ox.Hand)(
            nets[name], impl=impl) for impl in ("cuda", "torch")}
        hm, secs = {}, {}
        for impl in ("cuda", "torch", "cuda"):
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            hm[impl] = wrap[impl].heatmaps(img)
            secs[impl] = time.perf_counter() - t
            got = {k: w.launches for k, w in wrappers.items() if w.launches}
            if got != (want_conv if impl == "cuda" else {}):
                fail(f"{name} impl={impl}: launches {got}, expected "
                     f"{want_conv if impl == 'cuda' else {}}")
            for k, n in got.items():
                counts[k] += n
        a, b = (torch.from_numpy(hm[i]) for i in ("cuda", "torch"))
        rel, mrel = errors(a, b)[1], mean_rel(a, b)
        tols = FACE_HAND_TOLS[name]
        if name == "face":   # a channel's peak, or none below threshold
            pc, pt = ([wrap["cuda"].peaks(hm[i][:, :, c:c + 1]).tolist()
                       for c in range(hm[i].shape[-1])]
                      for i in ("cuda", "torch"))
            share = float(np.mean([x == y for x, y in zip(pc, pt)]))
            n_peaks = f"{sum(map(bool, pc))} channels above threshold"
        else:
            pc, pt = (wrap[i].peaks(hm[i], img.shape[:2])
                      for i in ("cuda", "torch"))
            share = float((pc == pt).all(-1).mean())
            n_peaks = f"{int((pc != 0).any(-1).sum())} parts found"
        log(f"{name} heatmaps {hm['cuda'].shape} cuda vs torch: max rel "
            f"{rel:.3e} (tol {tols[0]:g}), mean rel {mrel:.3e} (tol "
            f"{tols[1]:g}); peaks at the same pixel {share:.4f} (bound "
            f"{FACE_HAND_TOLS['peaks']:g}; {n_peaks}); warm cuda "
            f"{secs['cuda']:.4f} s, torch {secs['torch']:.4f} s; {card}")
        if not (rel <= tols[0] and mrel <= tols[1]
                and share >= FACE_HAND_TOLS["peaks"]):
            fail(f"{name}: heatmaps max rel {rel}, mean rel {mrel}, peaks "
                 f"{share}")
    for k, w in wrappers.items():
        w.launches = counts[k]
    return gate_launches(wrappers, "face_hand", {
        k: 2 * FACE_CONV.get(k, 0) + 2 * HAND_CONV.get(k, 0)
        for k in ("conv3x3", "conv3x3_hblock")})


def check_evaluate(wrappers, dev):
    """Phase 13: ``inference_on_dataset`` with the port's
    ``DensePose.detect`` (its R-CNN from a seed, stem scaled as phase 6b)
    over EVAL_IMAGES seeded 480x640 images with two gt boxes each, scored
    by the host runtime's COCO evaluator (built here with g++ from the
    checkout's source): 12 finite stats, DEMO_CONV's R-CNN sites an
    image."""
    import numpy as np
    import torch
    from idmvton_tpu_torch.models.layers import weights_changed_
    from idmvton_tpu_torch.preprocess.densepose import evaluate
    from idmvton_tpu_torch.preprocess.densepose.visualize import DensePose
    from idmvton_tpu_torch.runtime import native
    t0 = time.perf_counter()
    lib = native.build()
    native.get_native()
    log(f"evaluate: host runtime {lib.name} built and bound in "
        f"{time.perf_counter() - t0:.2f} s")
    dp = DensePose(device=dev)
    with torch.no_grad():
        dp.model.backbone.stem.conv.kernel.div_(50.0)
    weights_changed_(dp.model)
    rng = np.random.default_rng(SEED + 80)
    data = [(i, rng.integers(0, 256, (480, 640, 3), np.uint8),
             np.asarray([[40, 60, 300, 460], [320, 20, 600, 470]],
                        np.float32)) for i in range(EVAL_IMAGES)]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = evaluate.inference_on_dataset(dp.detect, data)
    secs = time.perf_counter() - t0
    stats = out["stats"]
    log(f"evaluate: {out['n_images']} images in {secs:.3f} s; stats "
        + ", ".join(f"{v:.4f}" for v in stats))
    if stats.shape != (12,) or not np.isfinite(stats).all():
        fail(f"evaluate: stats {stats}")
    return gate_launches(wrappers, "evaluate", {
        k: EVAL_IMAGES * n for k, n in DEMO_CONV["densepose"].items()})


# ---------------------------------------------------------------------------
# phase 14: the parallel paths and the utilities
# ---------------------------------------------------------------------------

# One full-width denoise step (GarmentNet at batch 2, TryonNet over the CFG
# batch of 4, 128x96 latents), per rank, read from the code. Single
# process: ln_linear at TryonNet's to_qkv, to_q and ff proj_in of its 70
# blocks and GarmentNet's to_q and ff (its emit LayerNorm is
# fused_layer_norm): 210 + 140; 70 fused_layer_norm; GroupNorm 46 TryonNet
# (4 + 4 + 2 + 4 + 2 resnets' and Transformer2Ds' down, 4 + 1 mid, 6 + 3 +
# 6 + 3 + 6 up, conv_norm_out) + 39 GarmentNet (no plain up block, no
# conv_norm_out); 3x3 convs with Cin, Cout >= 128: 36 + 30 (conv_in and
# conv_out stay plain); flash_attention_gemm at every self-attention site,
# 70 + 70. TP=2 (``parallel/tp.py``): the 640-wide level keeps 5 heads a
# rank (H*D = 320, not a multiple of 128), so its 10 + 10 self-attention
# sites take flash_attention (over 3072 own [+ 3072 garment] keys) and its
# to_qkv (N = 960) and to_q (N = 320) leave ln_linear (N % 128 != 0): 320
# ln_linear (TryonNet 60 x 3 + 10, GarmentNet 60 x 2 + 10), 120
# flash_attention_gemm, 20 flash_attention; GroupNorm and convs are
# replicated. SP=2 (``parallel/sp.py``): every conv runs on its 64 + 2 (32
# + 2, 16 + 2) rows, GroupNorm on local rows (>= 64 positions everywhere),
# and self-attention gathers K / V and runs flash_attention at all 140
# sites.
PARALLEL_STEP = {
    "single": {"ln_linear": 350, "fused_layer_norm": 70,
               "gn_spatial_stats": 85, "gn_apply": 85, "conv3x3": 66,
               "flash_attention_gemm": 140},
    "tp": {"ln_linear": 320, "fused_layer_norm": 70, "gn_spatial_stats": 85,
           "gn_apply": 85, "conv3x3": 66, "flash_attention_gemm": 120,
           "flash_attention": 20},
    "sp": {"ln_linear": 350, "fused_layer_norm": 70, "gn_spatial_stats": 85,
           "gn_apply": 85, "conv3x3": 66, "flash_attention": 140},
}
# (max rel, mean rel) of the gathered TP=2 / SP=2 guided noise prediction
# against the single-process impl="cuda" step on the same inputs. Both
# sides round in bf16 at ~140 sites, in other places (TP: partial products
# summed over the ranks, #9 for #4 and a plain LayerNorm + GEMM for #1 at
# the 640-wide level; SP: #9 for #4 everywhere, GroupNorm sums in another
# order), so the difference is about sqrt(2) x phase 4's cuda-vs-torch
# one. First reading (an H100 80GB HBM3 at 700 W, gloo between the two
# ranks, random biases and affines): TP max rel 2.94e-2, mean rel
# 2.68e-2; SP 2.84e-2 / 2.71e-2, the same on both ranks. In fp32 on the
# CPU (tests/test_torch_parallel.py) the same steps agree to 2.3e-6. The
# bounds sit at 2x the max and 1.3x the mean: a dropped bias or LayerNorm
# shift (6.95e-2 / 8.64e-2 mean rel in the tiny probe, STEP_TOLS's note)
# or a lost garment K/V (0.42) falls outside.
PARALLEL_TOLS = {"tp": (6e-2, 3.5e-2), "sp": (6e-2, 3.5e-2)}
# the micro stack's dp=2 step (replicated, ZeRO-1) against one rank: the
# loss relative, every master within MICRO_TOL, except where the one-rank
# gradient is under 1e-3 of its leaf's largest: Adam's first step is lr *
# g / |g|, so such an entry may flip its step's sign (2 lr apart)
MICRO_TOL = 1e-5
# LPIPS (VGG16, fp32 x) on two 768x1024 images, read from the code: per
# image, the 3x3 sites with Cin and Cout >= 128 are conv2_2, conv3_1-3_3,
# conv4_1-4_3, conv5_1-5_3; those whose fp32 input image reaches 32 MiB
# take conv3x3_hblock: conv2_2 (512x384x128, 96 MiB), conv3_2 and conv3_3
# (256x192x256, 48 MiB); conv3_1 (256x192x128) is 24 MiB
LPIPS_CONV = {"conv3x3": 2 * 7, "conv3x3_hblock": 2 * 3}
# LPIPS impl="cuda" (bf16 operands at the kernel sites) against
# impl="torch" (fp32, TF32 off): relative difference of the distance.
# First readings (an H100 80GB HBM3 at 700 W, random VGG16 from the seed):
# 9.3e-4 on two random images, 7.4e-4 on phase 5's; the bound at ~3x
LPIPS_TOL = 3e-3
# SSIM / PSNR on the card against the same on the host
METRIC_TOL = 1e-5


def check_dp_nccl(wrappers, dev, card):
    """Phase 14a: phase 10's full-width adamw step (sdxl_tryon TryonNet +
    Resampler, batch 1 at HEIGHT x WIDTH, remat, the VAE sample, noise and
    timestep drawn from a seeded generator) without a process group, then
    through the data-parallel path (``make_train_step(mesh=...)``) on a
    one-rank NCCL group made in this process: loss, gradient norm,
    TRAIN_LEAVES and launch counts equal bit for bit. Returns the DP step's
    launches."""
    import gc
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.parallel.mesh import make_mesh
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        flat_params, init_train_state, make_optimizer, make_train_step,
    )
    models = TryonModels.init(SEED, device=dev, dtype=torch.bfloat16)
    for i, module in enumerate(models.components().values()):
        random_affine_(module, SEED + 10 + i)
    sched = DDPMScheduler(SchedulerConfig.train())
    tx = make_optimizer()
    batch = train_batch(models, dev,
                        torch.Generator(device=dev).manual_seed(SEED + 40))
    del batch["noise"], batch["timesteps"]

    def run(mesh, label):
        state = init_train_state(models, tx)
        step = make_train_step(models, sched, tx, impl="cuda", mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(loss=metrics["loss"].clone(),
                   grad_norm=metrics["grad_norm"].clone(),
                   counts={k: w.launches for k, w in wrappers.items()},
                   leaves={k: flat_params(state.trainable)[k].detach().clone()
                           for k in TRAIN_LEAVES})
        log(f"dp {label}: {secs:.3f} s, loss {float(got['loss']):.6g}, grad "
            f"norm {float(got['grad_norm']):.6g}; launches {got['counts']}")
        del state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
        return got

    torch.cuda.reset_peak_memory_stats()
    plain = run(None, "no process group")
    root = tempfile.mkdtemp(prefix="idmvton_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{root}/store",
                            rank=0, world_size=1, device_id=dev)
    try:
        dp = run(make_mesh(), "one-rank NCCL group")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    same = [torch.equal(plain[k], dp[k]) for k in ("loss", "grad_norm")]
    same += [torch.equal(plain["leaves"][k], dp["leaves"][k])
             for k in TRAIN_LEAVES]
    if not all(same) or plain["counts"] != dp["counts"]:
        fail(f"dp over a one-rank NCCL group differs from the step without "
             f"one: equal {same}, launches {plain['counts']} vs "
             f"{dp['counts']}")
    log(f"dp: the one-rank NCCL step equals the plain step bit for bit "
        f"(loss, gradient norm, {len(TRAIN_LEAVES)} leaves, launches); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; "
        f"{card}")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    for k, w in wrappers.items():
        w.launches = dp["counts"][k]
    return gate_launches(wrappers, "dp_nccl")


def _micro_close(label, got, want):
    """Gates a dp=2 micro step against the one-rank one (MICRO_TOL)."""
    import numpy as np
    if not abs(got["loss"] - want["loss"]) <= MICRO_TOL * abs(want["loss"]):
        fail(f"{label}: loss {got['loss']} vs one rank {want['loss']}")
    worst, flips, total = 0.0, 0, 0
    for k, w in want["params"].items():
        err = np.abs(got["params"][k] - w)
        mu = np.abs(want["mu"][k])
        tiny = mu < 1e-3 * mu.max()
        worst = max(worst, float(err[~tiny].max(initial=0.0)))
        if not (err[~tiny] <= MICRO_TOL).all() or \
                not (err[tiny] <= 3 * MICRO_TOL).all():
            fail(f"{label}: {k} differs by {float(err.max())} from one rank")
        flips += int((err[tiny] > MICRO_TOL).sum())
        total += err.size
    if flips > 1e-3 * total:
        fail(f"{label}: {flips} of {total} entries flipped their step")
    log(f"{label}: loss {got['loss']:.8g} (one rank {want['loss']:.8g}), "
        f"masters within {worst:.2e} ({flips} near-zero-gradient entries "
        f"of {total} flipped Adam's first step), moments "
        f"{got['moment_bytes']} bytes a rank")


def check_two_ranks(dev, card):
    """Phase 14b: two ranks on the one card (``parallel/onecard.py``
    through ``parallel.dryrun.spawn``). NCCL is probed first; where it
    refuses two ranks on one device the ranks take gloo with CUDA tensors.
    Gates the full-width TP=2 and SP=2 denoise steps against the
    single-process one (PARALLEL_TOLS) and each rank's launches
    (PARALLEL_STEP), the micro dp=2 step, adamw replicated and ZeRO-1 and
    adamw8bit ZeRO-1 (its kernel once a rank), against the one-rank step
    here (MICRO_TOL; ZeRO-1's moments at most half a rank), and ViT-H's
    GPipe run bit for bit. Returns each parallel
    step's launches summed over the ranks."""
    import torch
    from torch.multiprocessing import (
        ProcessExitedException, ProcessRaisedException,
    )
    from idmvton_tpu_torch.parallel import onecard
    from idmvton_tpu_torch.parallel.dryrun import spawn
    t0 = time.perf_counter()
    try:
        spawn(onecard.nccl_probe, 2, backend="nccl", timeout=180)
        backend = "nccl"
        log("two ranks, one card: NCCL accepted them")
    except (ProcessRaisedException, ProcessExitedException,
            TimeoutError) as e:
        said = [ln for ln in str(e).splitlines() if ln.strip()] or [repr(e)]
        why = next((ln for ln in said if "Duplicate GPU" in ln), said[-1])
        backend = "gloo"
        log(f"two ranks, one card: NCCL refused them ({why.strip()}); the "
            f"two-rank runs take gloo with CUDA tensors")
    log(f"two ranks: the NCCL probe took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ranks = spawn(onecard.all_ranks, 2, SEED + 50, backend=backend,
                  timeout=900)
    log(f"two ranks ({backend}): spawned, ran and joined in "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    for mode in ("tp", "sp"):
        counts[mode] = dict.fromkeys(onecard.KERNELS, 0)
    for rank, r in enumerate(ranks):
        d = r["denoise"]
        log(f"rank {rank} ({d['backend']}): single-process step "
            f"{d['single_s']:.3f} s, SP=2 {d['sp_s']:.3f} s, TP=2 "
            f"{d['tp_s']:.3f} s (both ranks share the card: no speed-up is "
            f"measurable); peak {d['peak_gib']:.2f} GiB; {card}")
        for mode in ("single", "tp", "sp"):
            want = dict.fromkeys(onecard.KERNELS, 0)
            want.update(PARALLEL_STEP[mode])
            log(f"rank {rank} {mode} step launches {d[mode]}")
            if d[mode] != want:
                fail(f"rank {rank} {mode} step: launches {d[mode]}, "
                     f"expected {want}")
            if mode != "single":
                for k, n in d[mode].items():
                    counts[mode][k] += n
        for mode in ("tp", "sp"):
            (mx, mean), (mx_tol, mean_tol) = d[f"{mode}_err"], \
                PARALLEL_TOLS[mode]
            log(f"rank {rank} {mode.upper()}=2 guided noise prediction vs "
                f"single process: max rel {mx:.3e} (tol {mx_tol:g}), mean "
                f"rel {mean:.3e} (tol {mean_tol:g})")
            if not (mx <= mx_tol and mean <= mean_tol):
                fail(f"rank {rank} {mode}: max rel {mx}, mean rel {mean}")
    from idmvton_tpu_torch.parallel.onecard import _host, micro_step
    one = _host(*micro_step(dev, SEED + 50))
    one8 = dict(_host(*micro_step(dev, SEED + 50, optimizer="adamw8bit")),
                mu=one["mu"])
    for rank, r in enumerate(ranks):
        t = r["train"]
        for mode in ("replicated", "zero1"):
            _micro_close(f"rank {rank} micro dp=2 {mode}", t[mode], one)
        _micro_close(f"rank {rank} micro dp=2 zero1 adamw8bit",
                     t["zero1_adamw8bit"], one8)
        for mode, want in (("zero1", one), ("zero1_adamw8bit", one8)):
            if not t[mode]["moment_bytes"] <= 0.5 * want["moment_bytes"]:
                fail(f"rank {rank}: {mode} holds {t[mode]['moment_bytes']} "
                     f"moment bytes, one rank {want['moment_bytes']}")
        if t["zero1_adamw8bit"]["launches"] != 1:
            fail(f"rank {rank}: adamw8bit's kernel launched "
                 f"{t['zero1_adamw8bit']['launches']} times, not once")
        p = r["pipeline"]
        log(f"rank {rank} GPipe ViT-H ({p['layers']} layers x "
            f"{p['hidden']}, 2 stages x 2 microbatches, activations hopping "
            f"through pinned host memory under gloo): pipeline "
            f"{p['pipeline_s']:.3f} s, sequential {p['sequential_s']:.3f} "
            f"s, equal bit for bit: {p['equal']}")
        if not p["equal"]:
            fail(f"rank {rank}: the GPipe ViT-H differs from the "
                 f"sequential forward over the same microbatches")
    return counts


def check_utilities(wrappers, dev, card, images):
    """Phase 14c: LPIPS (random VGG16 from the seed, fp32) between phase
    5's two 768x1024 images, impl="cuda" against impl="torch", gated on
    LPIPS_TOL and its exact conv launches (LPIPS_CONV); SSIM and PSNR on
    the card against the host; ``PhaseTimer`` and ``trace`` around the cuda
    LPIPS call, whose trace must name the conv kernels. Returns the cuda
    call's launches."""
    import shutil
    import tempfile
    import torch
    from idmvton_tpu_torch.utils import metrics, profiling
    a, b = images[0:1].to(dev), images[1:2].to(dev)
    net = metrics.init_lpips(SEED + 70, device=dev)
    timer = profiling.PhaseTimer()
    logdir = tempfile.mkdtemp(prefix="idmvton_trace_")
    try:
        for w in wrappers.values():
            w.launches = 0
        with profiling.trace(logdir) as prof:
            with timer.phase("lpips_cuda", sync=a):
                d_cuda = metrics.lpips(net, a, b, impl="cuda")
        lp_counts = gate_launches(wrappers, "lpips", LPIPS_CONV)
        names = {e.key for e in prof.key_averages()}
        path = os.path.join(logdir, os.listdir(logdir)[0])
        with open(path) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        trace_mb = os.path.getsize(path) / 2**20
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    hit = sorted({k.split("(")[0] for k in kernels if "conv3x3" in k})
    if not hit or "lpips_cuda" not in names:
        fail(f"trace: no conv3x3 kernel or no lpips_cuda range among "
             f"{len(kernels)} kernel events")
    with timer.phase("lpips_torch", sync=a):
        d_torch = metrics.lpips(net, a, b, impl="torch")
    rel = float((d_cuda - d_torch).abs().max() / d_torch.abs().max())
    log(f"LPIPS of phase 5's two images: cuda {float(d_cuda[0]):.6g}, torch "
        f"{float(d_torch[0]):.6g}, rel {rel:.3e} (tol {LPIPS_TOL:g}); "
        f"launches {lp_counts}")
    if not rel <= LPIPS_TOL:
        fail(f"LPIPS cuda vs torch: rel {rel}")
    s_dev, p_dev = metrics.ssim(a, b), metrics.psnr(a, b)
    s_host, p_host = metrics.ssim(a.cpu(), b.cpu()), metrics.psnr(a.cpu(),
                                                                  b.cpu())
    log(f"SSIM card {float(s_dev):.8f} host {float(s_host):.8f}; PSNR card "
        f"{float(p_dev):.6f} host {float(p_host):.6f} dB")
    if not (abs(float(s_dev) - float(s_host)) <= METRIC_TOL
            and abs(float(p_dev) - float(p_host))
            <= METRIC_TOL * abs(float(p_host))):
        fail("SSIM / PSNR on the card differ from the host's")
    log(f"PhaseTimer ({card}):\n{timer.summary()}")
    log(f"trace: {len(kernels)} kernel events ({trace_mb:.2f} MB), conv "
        f"kernels {hit}")
    return lp_counts


def main():
    if not (ROOT / "idmvton_tpu_torch" / "ops" / "csrc").is_dir():
        fail("idmvton_tpu_torch/ not found beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the bf16 path runs with the variant switches off, whatever the caller's
    # environment holds; the variant phase turns them on
    os.environ["IDMVTON_CROSS_KERNEL"] = "0"
    os.environ["IDMVTON_CONV_PADACC"] = "0"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- phase 2: build ------------------------------------------------------
    from idmvton_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    from idmvton_tpu_torch.parallel.onecard import kernel_wrappers
    from idmvton_tpu_torch.train import quant_opt
    wrappers = kernel_wrappers()
    wrappers.update(adam_int8_update=quant_opt.adamw_int8_fused_,
                    adam_int8_norm=quant_opt.fused_global_norm)
    from idmvton_tpu_torch.cli import infer

    with torch.inference_mode():
        # -- phase 3: each kernel against its plain version ------------------
        results = check_kernels(dev)

        # -- the full-width stack --------------------------------------------
        from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
        t0 = time.perf_counter()
        models = TryonModels.init(SEED, device=dev, dtype=torch.bfloat16)
        for i, module in enumerate(models.components().values()):
            random_affine_(module, SEED + 10 + i)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for m in models.components().values()
                       for p in m.parameters())
        log(f"models: {n_params / 1e9:.3f} B params on {dev} in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        pipe = TryonPipeline(models)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        inputs = make_inputs(models, dev, gen)

        # -- phase 4: one denoise step, kernels vs plain; the captured step --
        check_step(pipe, inputs, gen, "bf16")
        check_online_softmax_step(pipe, inputs, gen)
        counts = {"graph": check_graph(pipe, inputs, gen, wrappers)}

        # -- phase 5: serve 2 requests through the bf16 path -----------------
        served = []
        counts["bf16"] = serve_requests(
            pipe, inputs, gen, wrappers, "bf16",
            exact={k: 2 * n for k, n in CONV_PER_REQUEST.items()},
            keep=served)

        # -- the fp32 decode (VAEConfig.force_upcast) -------------------------
        counts["decode_fp32"] = check_decode_fp32(models, wrappers, gen)

        # -- phase 6: the CLI's batch loop at full width ---------------------
        args = infer.parse_args(["--data_dir", "-"])
        cli_exact = dict(CONV_PER_REQUEST, flash_attention=0)
        counts["cli"], cli_images = cli_run(
            args, models, infer.build(args, models), wrappers, "cli",
            exact=cli_exact)

        # -- phase 6b: the demo server's preprocessing and request ---------
        counts["demo"] = check_demo(models, wrappers)

        # -- phase 7: export the stack as a bf16 tree, load it, serve --------
        counts["checkpoint"] = check_checkpoint(
            models, wrappers, cli_images, counts["cli"], cli_exact)

        # -- phase 8: the opt-in variants of the same path -------------------
        from idmvton_tpu_torch.models.attention import (
            quantize_unet_linears_int8,
        )
        t0 = time.perf_counter()
        quantize_unet_linears_int8(models.unet)
        quantize_unet_linears_int8(models.garm, attn_qkv=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"variant: W8A8 quantization (TryonNet to_qkv + ff.proj_in, "
            f"GarmentNet ff.proj_in) in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        os.environ["IDMVTON_CROSS_KERNEL"] = "1"
        os.environ["IDMVTON_CONV_PADACC"] = "1"
        check_step(pipe, inputs, gen, "variant")
        counts["variant"] = serve_requests(
            pipe, inputs, gen, wrappers, "variant",
            exact={"conv3x3_padacc": 2 * CONV_PER_REQUEST["conv3x3"],
                   "conv3x3_hblock": 2 * CONV_PER_REQUEST["conv3x3_hblock"]})
        del models, pipe, inputs
        torch.cuda.empty_cache()
        os.environ["IDMVTON_CROSS_KERNEL"] = "0"
        os.environ["IDMVTON_CONV_PADACC"] = "0"

        # -- phase 9: the CLI's --tiny mode (kernel #9) ----------------------
        args = infer.parse_args(["--data_dir", "-", "--tiny",
                                 "--device", "cuda"])
        tiny = infer.load_models(args, torch.bfloat16)
        for i, module in enumerate(tiny.components().values()):
            random_affine_(module, SEED + 30 + i)
        built = infer.build(args, tiny)
        check_step(built[0], make_inputs(tiny, dev, gen), gen, "tiny",
                   TINY_STEP_TOLS)
        counts["tiny"], _ = cli_run(
            args, tiny, built, wrappers, "tiny",
            exact=dict(TINY_CONV_PER_BATCH,
                       flash_attention=TINY_FLASH_PER_STEP * STEPS))
        del tiny, built
    torch.cuda.empty_cache()

    # -- phase 10: training (autograd, outside inference mode) ---------------
    backward = check_kernel_grads(dev)
    counts.update(check_train(wrappers, dev, card))
    counts["train_cli"] = check_train_cli(wrappers)
    results.update(check_adam_int8(dev, card))

    # -- phases 11-13: DensePose training, Face / Hand, evaluation ---------
    counts["densepose_train"] = check_dp_train(wrappers, dev, card)
    with torch.inference_mode():
        counts["face_hand"] = check_face_hand(wrappers, dev, card)
        counts["evaluate"] = check_evaluate(wrappers, dev)

    # -- phase 14: the parallel paths and the utilities ----------------------
    counts["dp_nccl"] = check_dp_nccl(wrappers, dev, card)
    counts.update(check_two_ranks(dev, card))
    with torch.inference_mode():
        counts["lpips"] = check_utilities(wrappers, dev, card, served[0])

    kernels = []
    for name in wrappers:
        by_path = {path: c.get(name, 0) for path, c in counts.items()}
        kernels.append(dict(results[name], launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            backward=backward.get(name)))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
