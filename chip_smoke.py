#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch port (idmvton_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for CUDA;
it imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   set the TF32 flags off (fp32 products in full fp32 on both sides);
2. build the kernels from ``idmvton_tpu_torch/ops/csrc`` with nvcc;
3. hold each of the eleven kernel entry points against its plain PyTorch
   version at the shapes its path gives it (bf16; the conv kernels also on
   the fp32 decode's fp32 activations), and time the kernel, the plain
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
   (the init zeroes them, which would hide a bias or scale/shift fault),
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
   latent through the conv and GroupNorm statistics kernels, every conv
   site on a kernel, against the bf16 decode;
6. the inference CLI's batch loop (``cli.infer.run``, with its
   BatchLoader, tokenizers and ip_pixels resize) over one in-memory batch
   of 2 synthetic VITON-HD samples on the same stack: uint8 images, the
   bf16 path's kernels and ``flash_attention`` never;
7. the opt-in variants of the same path: quantize both UNets for W8A8
   serving (``IDMVTON_GEMM_INT8=2`` in the JAX bench: TryonNet's to_qkv and
   ff.proj_in, GarmentNet's ff.proj_in), set ``IDMVTON_CROSS_KERNEL=1`` and
   ``IDMVTON_CONV_PADACC=1``, hold one full-width step with ``impl="cuda"``
   against ``impl="torch"``, and serve 2 more requests (the variant path);
8. the CLI's ``--tiny`` mode (``cli.infer.load_models``, random biases and
   norm affines, then ``run`` at
   768x1024, batch 2, 30 steps): one tiny step with ``impl="cuda"``
   against ``impl="torch"``, then a batch, whose 64-wide level runs
   ``flash_attention`` (kernel #9) 10 times a step;
   the launch counters, zeroed before each serving phase and read after
   it, show that each path launched every kernel it runs and no other, and
   each conv kernel exactly once a conv site of the path;
9. print a JSON line with each kernel's result, then the device line.
"""

from __future__ import annotations

import json
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
# Random biases ~ N(0, AFFINE_STD^2) and norm scales ~ 1 + N(0,
# AFFINE_STD^2), shifts ~ N(0, AFFINE_STD^2) (tests/test_torch_affine.py's
# values), drawn on the card from the seed
AFFINE_STD = 0.1
# the kernels each serving path must launch, and no others
BF16_PATH = ("ln_linear", "fused_layer_norm", "gn_spatial_stats", "conv3x3",
             "conv3x3_hblock", "flash_attention_gemm")
PATH_KERNELS = {
    "bf16": BF16_PATH,
    "cli": BF16_PATH,
    "variant": ("ln_linear", "fused_layer_norm", "gn_spatial_stats",
                "conv3x3_hblock", "flash_attention_gemm", "ln_linear_i8",
                "cross_attention_small_kv", "conv3x3_padacc"),
    # read on an H100: the tiny stack at 768x1024 also reaches all six (the
    # 128-wide level and mid block take ln_linear and flash_attention_gemm,
    # one VAE conv takes conv3x3_hblock) besides flash_attention
    "tiny": BF16_PATH + ("flash_attention",),
    "decode_fp32": ("conv3x3", "conv3x3_hblock", "gn_spatial_stats"),
    # two jit_generate requests, every step replayed from the captured step
    "graph": BF16_PATH,
}
# the replayed step's timing (phase 4): steps a reading
TIMED_STEPS = 5


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
    AFFINE_STD^2) and every norm's scale with 1 + N(0, AFFINE_STD^2), from
    ``seed``, in place (tests/test_torch_affine.py's ``random_affine`` on
    the modules: this script imports nothing of tests/)."""
    import torch
    from idmvton_tpu_torch.models.layers import Norm
    p0 = next(module.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if name not in ("bias", "scale") or p is None:
                    continue
                if name == "scale" and not isinstance(m, Norm):
                    continue
                r = torch.randn(p.shape, generator=gen, device=p.device)
                r.mul_(AFFINE_STD)
                if name == "scale":
                    r.add_(1.0)
                p.copy_(r)


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
    without a gate), ``time`` (one to time beside it) or ``exps`` (the
    exponentials an attention kernel takes: its logits, for the exp
    floor)."""
    import torch
    import torch.nn.functional as F
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
                        F.layer_norm(x2, (c,), g16, b16, 1e-5), w)))

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
                    time=("int_mm", lambda: torch._int_mm(codes, w_i8)))

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
                    exps=b * heads * n * ctx, time=("sdpa_sum", two))

    def lnorm_case(shape):
        x = rn(*shape)
        s, b = rn(shape[-1], dtype=torch.float32), rn(shape[-1], dtype=torch.float32)
        s16, b16 = s.to(x.dtype), b.to(x.dtype)
        return case(f"x{shape}", lambda: N.fused_layer_norm(x, s, b),
                    lambda: N.layer_norm_torch(x, s, b), [x, s, b],
                    8 * x.numel(), rate="fp32",
                    library=lambda: F.layer_norm(x, (shape[-1],), s16, b16,
                                                 1e-5))

    def gn_case(shape):
        x = rn(*shape) + 0.2
        return case(f"x{shape}", lambda: N.gn_spatial_stats(x),
                    lambda: N.gn_spatial_stats_torch(x), [x],
                    3 * x.numel(), rate="fp32", tol="gn")

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
        return case(f"x{(b, h, w, cin)}{fp32} -> {cout}",
                    lambda: fn(x, k, bias),
                    lambda: CV.conv3x3_torch(x, k, bias), [x, k, bias],
                    2 * b * h * w * 9 * cin * cout,
                    library=lambda: F.conv2d(xc, kc, bc, padding=1),
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
                    library=lambda: F.scaled_dot_product_attention(q, k, v))

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
        else:
            kern = lambda: A.flash_attention(q, k, v)
            plain = lambda: A.flash_attention_torch(q, k, v)
            ins, kt, vt = [qkv], bhsd(k), bhsd(v)
        qt = bhsd(q)
        return case(f"q{(b, n, heads, d)} over {n + m} keys"
                    f"{' (concat KV)' if m else ''}", kern, plain, ins,
                    4 * b * heads * n * (n + m) * d,
                    exps=b * heads * n * (n + m),
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
             ln_case((4, 768), 128, 512, True, True)]),
        ("fused_layer_norm", csrc + "ln_linear.cu",
         "idmvton_tpu/ops/pallas_norm.py:26", "F.layer_norm", [
             lnorm_case((2, 3072, 640)), lnorm_case((2, 768, 1280))]),
        ("gn_spatial_stats", csrc + "gn_stats.cu",
         "idmvton_tpu/ops/pallas_norm.py:575",
         "none: no PyTorch call returns GroupNorm's per-channel sums", [
             gn_case((4, 128, 96, 320)), gn_case((4, 32, 24, 2560)),
             gn_case((6, 1024, 768, 128))]),
        ("conv3x3", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:34", "F.conv2d (cuDNN)", [
             conv_case(CV.conv3x3, 4, 128, 96, 320, 320),
             conv_case(CV.conv3x3, 4, 64, 48, 640, 640),
             conv_case(CV.conv3x3, 4, 32, 24, 1280, 1280),
             conv_case(CV.conv3x3, 4, 128, 96, 960, 320),
             # the fp32 decode's 128x96 level
             conv_case(CV.conv3x3, 2, 128, 96, 512, 512, torch.float32)]),
        ("conv3x3_hblock", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:187", "F.conv2d (cuDNN)", [
             conv_case(CV.conv3x3_hblock, 6, 1024, 768, 128, 128),
             conv_case(CV.conv3x3_hblock, 2, 512, 384, 512, 256),
             # the fp32 decode's 512x384 and 1024x768 levels
             conv_case(CV.conv3x3_hblock, 2, 512, 384, 512, 256,
                       torch.float32),
             conv_case(CV.conv3x3_hblock, 2, 1024, 768, 128, 128,
                       torch.float32)]),
        ("flash_attention_gemm", csrc + "flash_attention_gemm.cu",
         "idmvton_tpu/ops/pallas_attention.py:356", sdpa, [
             flash_gemm_case(4, 3072, 10, True, 2),
             flash_gemm_case(4, 768, 20, True, 2),
             flash_gemm_case(2, 3072, 10, False, 0),
             flash_gemm_case(2, 768, 20, False, 0),
             # the tiny UNet's 128-wide level (8 heads of 16), TryonNet
             flash_gemm_case(4, 768, 8, True, 2, d=16)]),
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
             flash_case(4, 3072, 10, 64, 3072)]),  # SDXL width
        ("flash_attention_fused_qkv", csrc + "flash_attention.cu",
         "idmvton_tpu/ops/pallas_attention.py:743", sdpa, [
             fused_case(4, 6144, 4, 16, 3072),
             fused_case(4, 6144, 10, 64, 3072)]),
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
                           {"gn_spatial_stats": c16["gn_spatial_stats"]})
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


def serve_requests(pipe, inputs, gen, wrappers, path, exact=None):
    """Serve 2 requests through ``stepwise_generate``; returns the launch
    count of each kernel in that run (counts zeroed just before, read just
    after). Fails unless the run launched every kernel of
    ``PATH_KERNELS[path]``, no other and, for each kernel in ``exact``,
    exactly that many times."""
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
    ``gate_launches``."""
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
    return counts


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
    log(f"graph: first step eager + capture {time.perf_counter() - t0:.3f}"
        f" s (capture alone {steps.capture_seconds:.3f} s)")
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
    log(smi.stdout.strip().splitlines()[0])
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

    from idmvton_tpu_torch.ops import cuda_attention, cuda_conv, cuda_norm
    wrappers = {
        "ln_linear": cuda_norm.ln_linear,
        "fused_layer_norm": cuda_norm.fused_layer_norm,
        "gn_spatial_stats": cuda_norm.gn_spatial_stats,
        "conv3x3": cuda_conv.conv3x3,
        "conv3x3_hblock": cuda_conv.conv3x3_hblock,
        "flash_attention_gemm": cuda_attention.flash_attention_gemm,
        "ln_linear_i8": cuda_norm.ln_linear_i8,
        "cross_attention_small_kv": cuda_attention.cross_attention_small_kv,
        "conv3x3_padacc": cuda_conv.conv3x3_padacc,
        "flash_attention": cuda_attention.flash_attention,
        "flash_attention_fused_qkv": cuda_attention.flash_attention_fused_qkv,
    }
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
        counts["bf16"] = serve_requests(
            pipe, inputs, gen, wrappers, "bf16",
            exact={k: 2 * n for k, n in CONV_PER_REQUEST.items()})

        # -- the fp32 decode (VAEConfig.force_upcast) -------------------------
        counts["decode_fp32"] = check_decode_fp32(models, wrappers, gen)

        # -- phase 6: the CLI's batch loop at full width ---------------------
        args = infer.parse_args(["--data_dir", "-"])
        counts["cli"] = cli_run(args, models, infer.build(args, models),
                                wrappers, "cli",
                                exact=dict(CONV_PER_REQUEST,
                                           flash_attention=0))

        # -- phase 7: the opt-in variants of the same path -------------------
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

        # -- phase 8: the CLI's --tiny mode (kernel #9) ----------------------
        args = infer.parse_args(["--data_dir", "-", "--tiny",
                                 "--device", "cuda"])
        tiny = infer.load_models(args, torch.bfloat16)
        for i, module in enumerate(tiny.components().values()):
            random_affine_(module, SEED + 30 + i)
        built = infer.build(args, tiny)
        check_step(built[0], make_inputs(tiny, dev, gen), gen, "tiny",
                   TINY_STEP_TOLS)
        counts["tiny"] = cli_run(
            args, tiny, built, wrappers, "tiny",
            exact=dict(TINY_CONV_PER_BATCH,
                       flash_attention=TINY_FLASH_PER_STEP * STEPS))

    kernels = []
    for name in wrappers:
        by_path = {path: c[name] for path, c in counts.items()}
        kernels.append(dict(results[name], launches=sum(by_path.values()),
                            launches_by_path=by_path))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
