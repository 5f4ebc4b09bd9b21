#!/usr/bin/env python3
"""The port (idmvton_tpu_torch) on one NVIDIA card: each hand-written kernel
timed beside its plain PyTorch version, a library call and its bound, then
every path of the port driven through the card tests, with each path's
kernel launches.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (nvcc), PyTorch built for CUDA and
pytest; it imports nothing of JAX or of the JAX package. Each step is fatal
on failure:

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   set the TF32 flags off (fp32 products in full fp32 on both sides);
2. build the kernels from ``idmvton_tpu_torch/ops/csrc`` with nvcc;
3. each kernel entry point at the shapes its path gives it (the TP and SP
   ranks' too; bf16; the conv kernels also on the fp32 decode's and the
   preprocessing nets' fp32 activations): its error against its plain
   version (gated at ``BF16_TOL``, GroupNorm's sums at ``GN_TOL``), its
   time, the plain version's and, where one PyTorch call computes the same
   function, that call's (``library_ms``; the port never makes it), and
   beside #1, #8 and #11 a yardstick that computes part of the function or
   the same in several calls (``layer_norm+mm_ms``, ``int_mm_ms``: the s8
   GEMM alone on the kernel's codes, ``sdpa_sum_ms``: two SDPA calls
   summed), beside the kernel's bound (its bytes over the card's memory
   rate or its operations over the peak rate of their type, the larger)
   and, in the log of the attention kernels, their exp floor (logits over
   ``EXP_RATE``); each kernel and library call is timed eagerly (CUDA
   events over 10 launches, in turns with the plain version) and as 10
   launches in a CUDA graph (``graph_ms``, ``library_graph_ms``: the
   device alone);
4. each kernel with an autograd Function (``ops.autograd``: #1-#9, #11,
   #13) at the same shapes: the gradient of every input through the
   Function against plain autograd's (``backward``: gated at
   ``BF16_TOL``; forward + backward timed both ways);
5. adamw8bit's kernel (#12, ``ops/csrc/adam_int8.cu``) on the full
   trainable tree (TryonNet + Resampler: 2.991 B fp32 masters in 1,591
   leaves, their gradients and 8-bit moments): one step against the plain
   per-leaf update (``ADAM_TOLS`` at ``ADAM_LR`` and ``ADAM_WD``), then the
   norm, the update and the whole optimizer phase timed eagerly and in a
   CUDA graph beside the bound (``adam_int8_bytes``) and the plain
   update's time;
6. the card tests (``CARD_TESTS``) in this process: the kernels against
   their plain versions at small shapes and at the paths' own, and each
   path of the port, each gated on its launches with its counters zeroed
   just before its run (``tests/torch_card.py::record``): a full-width
   bf16 request, the CLI's batch, the demo's nets and requests, the
   checkpoint round trip, the W8A8 variant request, the ``--tiny`` CLI
   batch, the fp32 decode, the full-width adamw and adamw8bit train
   steps, the train CLI with resume, the one-rank NCCL step, DensePose
   training, Face and Hand, the evaluation harness, the two-rank TP and
   SP steps and LPIPS;
7. print a JSON line with each kernel's result and its launches on each
   path of step 6 (``launches_by_path``; ``launches``, their sum), then
   the device line.

A full-width request, demo request and train step against their fp32
references are the benchmark's cells' checks (``benchmark/run.py``).
``fail``, ``log``, ``cuda_time_ms``, ``graph_ms``, ``errors``, ``nbytes``
and the card's peaks are shared with the ``scripts/torch_*`` probes, which
import this module.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_TOL = 2e-2   # max |kernel - plain| / max |plain|: a few bf16 ulps
# GroupNorm sums: fp32 over up to 786432 rows in another order (pass 2 adds
# up to 3072 block partials in sequence): max |err| / max |sum of squares|
GN_TOL = 5e-5

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


def errors(got, want):
    """(max |got - want|, that over max |want|); inf when got is not
    finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-6)


def nbytes(*ts) -> int:
    import torch
    total = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


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
    gradient check of step 4)."""
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
        gam = rn(c, dtype=torch.float32) * 0.1 + 1
        bet = rn(c, dtype=torch.float32) * 0.1
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
        gam = rn(c, dtype=torch.float32) * 0.1 + 1
        bet = rn(c, dtype=torch.float32) * 0.1
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
        s = rn(shape[-1], dtype=torch.float32)
        b = rn(shape[-1], dtype=torch.float32)
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
        (step 1), and cuDNN in fp32 as the library call."""
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
        label = f" garment M={n} uncond_rows={uncond}" if garment else ""
        return case(f"qkv{(b, n, 3 * hd)} heads {heads}{label}",
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
             # parallel paths: a TP=2 rank's TryonNet at the 1280-wide level
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
             # parallel paths: an SP=2 rank's GarmentNet rows
             lnorm_case((2, 1536, 640)), lnorm_case((2, 384, 1280))]),
        ("gn_spatial_stats", csrc + "gn_stats.cu",
         "idmvton_tpu/ops/pallas_norm.py:575",
         "none: no PyTorch call returns GroupNorm's per-channel sums", [
             gn_case((4, 128, 96, 320)), gn_case((4, 32, 24, 2560)),
             gn_case((6, 1024, 768, 128)),
             # parallel paths: an SP=2 rank's 64 of 128 rows
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
             # parallel paths: an SP=2 rank's rows with their two halo
             # rows (the 320- and 1280-wide levels); LPIPS's VGG16 on a
             # 768x1024 image (fp32): conv3_1, conv4_2
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
             # parallel paths: LPIPS's conv2_2 and conv3_2 (fp32, 768x1024)
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
             # parallel paths: a TP=2 rank's TryonNet at the 1280-wide level
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
             # parallel paths: a TP=2 rank's 640-wide level (5 heads of 64); an
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
            # GroupNorm's (sum, sum of squares), scaled by the latter
            if c["tol"] == "gn":
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


def check_kernel_grads(dev):
    """Each kernel with an autograd Function (``ops.autograd``) at its
    step-3 shapes: the gradient of every differentiable input through the
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


def adam_int8_bytes(sizes, nblocks_used: int) -> int:
    """The least bytes one fused step moves: each gradient read twice (the
    norm and the update), each master read and written, both int8 moment
    codes read and written, and their fp32 block scales read and written."""
    n = sum(sizes)
    return 8 * n + 8 * n + 4 * n + 16 * nblocks_used


def check_adam_int8(dev, card):
    """Step 5: adamw8bit's kernel on the full trainable tree. Returns
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


# the card tests of step 6, run from the root of the checkout
CARD_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_cuda_full.py")


def main():
    if not (ROOT / "idmvton_tpu_torch" / "ops" / "csrc").is_dir():
        fail("idmvton_tpu_torch/ not found beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import pytest
    import torch
    import torch_card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")

    # -- 1: the card ---------------------------------------------------------
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2: build ------------------------------------------------------------
    from idmvton_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    # -- 3: each kernel against its plain version, timed ---------------------
    with torch.inference_mode():
        results = check_kernels(dev)
    # -- 4: the kernels' autograd Functions ----------------------------------
    backward = check_kernel_grads(dev)
    # -- 5: adamw8bit on the full trainable tree -----------------------------
    results.update(check_adam_int8(dev, card))
    torch.cuda.empty_cache()

    # -- 6: the card tests: every path, its launches recorded ----------------
    t0 = time.perf_counter()
    code = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider",
                        "--rootdir", str(ROOT),
                        *(str(ROOT / t) for t in CARD_TESTS)])
    log(f"card tests: exit {int(code)} in {time.perf_counter() - t0:.1f} s")
    if code != pytest.ExitCode.OK:
        fail(f"the card tests failed (pytest exit {int(code)})")

    kernels = []
    paths = torch_card.LAUNCHES
    for name in torch_card.counted():
        by_path = {path: c.get(name, 0) for path, c in paths.items()}
        kernels.append(dict(results[name], launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            backward=backward.get(name)))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
