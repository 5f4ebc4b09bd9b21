#!/usr/bin/env python3
"""Every tile and ring depth of the port's wgmma ``ln_linear`` kernel at the
``ln_linear`` shapes of the serving and tiny paths, and the standalone
LayerNorm against ``F.layer_norm``, on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_ln_tiles.py``
(``--quick``: the plan's tile only, on the port's own build; ``--root DIR``:
time the ``idmvton_tpu_torch`` of another checkout, e.g. an older commit
unpacked with ``git archive``, through its own wrappers and plans, which
implies ``--quick``). It needs one CUDA card and nvcc, and imports nothing
of JAX.

The kernel's ring depth is a constant of ``csrc/ln_linear.cu``; this script
builds the kernel library once for each of ``STAGES`` (``-DIDM_LN_STAGES``)
and, for each shape, launches ``ln_linear`` with each BN of
``cuda_norm.LN_TILES`` forced through ``ln_linear_plan(tile=...)``: max
|err| over max |plain| against ``ln_linear_torch``, ms, graph ms and TFLOP/s,
beside the shape's bound (the larger of its bytes over the card's memory
rate and its FLOPs over the bf16 peak) and the two-call yardstick
``F.layer_norm`` then ``torch.mm`` (cuBLAS: a reference, not a gate, as no
one PyTorch call fuses the two); and the host's microseconds a call (50
enqueues, no sync) of the wrapper and of the yardstick. Two times a call:
``ms`` (CUDA events over 10 eager launches after 2, as chip_smoke.py times)
and ``graph ms`` (10 launches captured in a CUDA graph and replayed 3 times:
the device alone). The tile the plan picks in the port's build is marked.
``--probe`` adds measurement builds (``PROBES``, ``-DIDM_LN_PROBE``) that
skip the row statistics and / or the fragments' normalization: the
LayerNorm stage's cost, graph ms at the plan's tile.
Then ``fused_layer_norm`` against ``F.layer_norm`` at GarmentNet's two
shapes, the same way. These readings are the basis of
``cuda_norm.LN_TILE_TFLOPS`` and of the header's ``IDM_LN_STAGES``.

``--i8`` sweeps the W8A8 kernel (``csrc/ln_linear_i8.cu``) instead, at the
variant path's six ``ln_linear_i8`` shapes: builds of 2, 3 and 4 ring
stages (``-DIDM_I8_STAGES``), each BN of ``cuda_norm.I8_TILES``
(``ln_linear_i8_plan(tile=...)``), max |err| over max |plain| against
``ln_linear_i8_torch``, ms, graph ms, TOP/s and host µs a call, the
quantization pre-pass alone (``ln_quant_i8``, graph ms), the bound (its
int8 operations over the int8 peak, or its bytes) and the yardstick
``torch._int_mm`` on the same codes (the s8 GEMM alone, cuBLASLt);
``--probe`` adds measurement builds (``I8_PROBES``, ``-DIDM_I8_PROBE``)
that skip the codes boxes after a block's first tile, the epilogue or the
gelu. Its
readings are ``cuda_norm.I8_TILE_TOPS`` and the header's
``IDM_I8_STAGES``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

# (lead shape, C, N, geglu, bias) of each ln_linear call of the path:
# TryonNet (B = 4) to_qkv / to_q / ff.proj_in at the 640 and 1280 levels,
# GarmentNet's (B = 2) to_q / ff.proj_in, the tiny UNet's 128-wide level
SHAPES = [((4, 3072), 640, 1920, False, False),
          ((4, 3072), 640, 640, False, False),
          ((4, 3072), 640, 2560, True, True),
          ((4, 768), 1280, 3840, False, False),
          ((4, 768), 1280, 1280, False, False),
          ((4, 768), 1280, 5120, True, True),
          ((2, 3072), 640, 640, False, False),
          ((2, 3072), 640, 2560, True, True),
          ((2, 768), 1280, 1280, False, False),
          ((2, 768), 1280, 5120, True, True),
          ((4, 768), 128, 384, False, False),
          ((4, 768), 128, 128, False, False),
          ((4, 768), 128, 512, True, True)]
LN_SHAPES = [(2, 3072, 640), (2, 768, 1280)]
STAGES = (2, 3, 4)
PORT = 4            # csrc/ln_linear.cu's IDM_LN_STAGES
# --i8: (lead shape, C, N, geglu, bias) of each ln_linear_i8 call of the
# variant path -- TryonNet's to_qkv and ff.proj_in at 640 and 1280,
# GarmentNet's ff.proj_in -- and csrc/ln_linear_i8.cu's IDM_I8_STAGES
I8_SHAPES = [((4, 3072), 640, 1920, False, False),
             ((4, 768), 1280, 3840, False, False),
             ((4, 3072), 640, 2560, True, True),
             ((4, 768), 1280, 5120, True, True),
             ((2, 3072), 640, 2560, True, True),
             ((2, 768), 1280, 5120, True, True)]
I8_PORT = 4
# --i8 --probe: measurement builds of the port's ring (-DIDM_I8_PROBE) that
# load the codes boxes only for a block's first tile, skip the epilogue,
# both, or skip the GEGLU's gelu; their results are wrong and not checked
I8_PROBES = {"A once": ("-DIDM_I8_PROBE=1",),
             "no epilogue": ("-DIDM_I8_PROBE=2",),
             "A once, no epilogue": ("-DIDM_I8_PROBE=3",),
             "no gelu": ("-DIDM_I8_PROBE=4",)}
# measurement builds (--probe): the port's ring with the row statistics
# skipped (1), the fragments' normalization skipped (2), or both (3): what
# the LayerNorm stage costs; their results are wrong and not checked
PROBES = (1, 2, 3)


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call: ``calls`` enqueues, no sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def i8_sweep(args, card, N, _build):
    """The --i8 readings: each ring depth's build and BN at each shape."""
    import torch
    from idmvton_tpu_torch.ops.quant import quantize_kernel_int8
    stages = [I8_PORT] if args.quick else list(STAGES)
    builds = {s: () if s == I8_PORT else (f"-DIDM_I8_STAGES={s}",)
              for s in stages}
    probes = I8_PROBES if args.probe else {}
    builds.update({f"probe {p}": d for p, d in probes.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.build(defines=d), builds.values()))
    smoke.log(f"{len(builds)} builds in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    rows = []
    with torch.inference_mode():
        for lead, c, n, geglu, bias in I8_SHAPES:
            x = rn(*lead, c)
            gam = rn(c, dtype=torch.float32) * 0.1 + 1
            bet = rn(c, dtype=torch.float32) * 0.1
            w_i8, w_scale = quantize_kernel_int8(
                rn(c, n * (2 if geglu else 1), scale=c ** -0.5))
            b = rn(w_i8.shape[1]) * 0.1 if bias else None
            m = x.numel() // c
            label = (f"x{tuple(lead) + (c,)} w_i8{tuple(w_i8.shape)}"
                     f"{' geglu' if geglu else ''}")
            ops = 2 * m * c * w_i8.shape[1]
            want = N.ln_linear_i8_torch(x, gam, bet, w_i8, w_scale, b,
                                        geglu=geglu)
            bound = max(1e3 * smoke.nbytes(x, gam, bet, w_i8, w_scale, b,
                                           want) / smoke.HBM_BPS,
                        1e3 * ops / smoke.PEAK["int8"])
            _build.DEFINES = builds[I8_PORT]
            codes, _ = N.ln_quant_i8(x, gam, bet)
            int_mm = lambda: torch._int_mm(codes, w_i8)
            pre = lambda: N.ln_quant_i8(x, gam, bet)
            lib, lib_graph = smoke.cuda_time_ms(int_mm), smoke.graph_ms(int_mm)
            pre_graph = smoke.graph_ms(pre)
            smoke.log(f"{label}: int_mm {lib:.4f} ms (graph {lib_graph:.4f},"
                      f" {ops / lib_graph / 1e9:.0f} TOP/s), pre-pass graph "
                      f"{pre_graph:.4f} ms, bound {bound:.4f} ms")
            pick = N.ln_linear_i8_plan(m, c, n, geglu, sms=sms).bn
            tiles = [pick] if args.quick else list(N.I8_TILES)

            def kern(tile):
                return N.ln_linear_i8(x, gam, bet, w_i8, w_scale, b,
                                      geglu=geglu, tile=tile)
            smoke.log(f"  host us a call {host_us(lambda: kern(pick)):.1f}")
            for st in stages:
                _build.DEFINES = builds[st]
                for tile in tiles:
                    _, err = smoke.errors(kern(tile), want)
                    ms = smoke.cuda_time_ms(lambda: kern(tile))
                    gms = smoke.graph_ms(lambda: kern(tile))
                    mark = " <- plan" if tile == pick and st == I8_PORT else ""
                    smoke.log(f"  bn {tile} stages {st}: rel err {err:.2e}, "
                              f"{ms:.4f} ms, graph {gms:.4f} ms, "
                              f"{ops / gms / 1e9:.0f} TOP/s{mark}")
                    rows.append(dict(kernel="ln_linear_i8", shape=label,
                                     bn=tile, stages=st, ms=ms, graph_ms=gms,
                                     tops=ops / gms / 1e9, rel_err=err,
                                     bound_ms=bound, pre_pass_graph_ms=pre_graph,
                                     int_mm_ms=lib, int_mm_graph_ms=lib_graph))
            for p in probes:
                _build.DEFINES = builds[f"probe {p}"]
                gms = smoke.graph_ms(lambda: kern(pick))
                smoke.log(f"  probe {p} (bn {pick}): graph {gms:.4f} ms, "
                          f"{ops / gms / 1e9:.0f} TOP/s")
                rows.append(dict(kernel="ln_linear_i8", shape=label, bn=pick,
                                 probe=p, graph_ms=gms))
            _build.DEFINES = ()
            del x, w_i8, want, codes
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}), flush=True)


def main():
    import torch
    import torch.nn.functional as F
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="time only the tile the plan picks, on the port's "
                         "own build")
    ap.add_argument("--root", default=None,
                    help="time the idmvton_tpu_torch of this checkout")
    ap.add_argument("--probe", action="store_true",
                    help="also time the plan's tile in the PROBES builds")
    ap.add_argument("--i8", action="store_true",
                    help="sweep the W8A8 ln_linear_i8 kernel instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs "
                   "a card")
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
        args.quick = True
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops import cuda_norm as N
    smoke.log(f"idmvton_tpu_torch from {Path(N.__file__).parents[1]}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smoke.log(smi.stdout.strip())
    if args.i8:     # the port's own kernel (the parent's has no plan)
        return i8_sweep(args, smi.stdout.strip(), N, _build)
    variants = [PORT] if args.quick else list(STAGES)
    builds = {s: () if s == PORT else (f"-DIDM_LN_STAGES={s}",)
              for s in variants}
    probes = {p: (f"-DIDM_LN_PROBE={p}",)
              for p in (PROBES if args.probe and not args.root else ())}
    builds.update({f"probe {p}": d for p, d in probes.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.build(defines=d), builds.values()))
    smoke.log(f"{len(builds)} builds in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    rows = []
    with torch.inference_mode():
        for lead, c, n, geglu, bias in SHAPES:
            x = rn(*lead, c)
            gam = rn(c, dtype=torch.float32) * 0.1 + 1
            bet = rn(c, dtype=torch.float32) * 0.1
            w = rn(c, n * (2 if geglu else 1), scale=c ** -0.5)
            b = rn(w.shape[1]) * 0.1 if bias else None
            m = x.numel() // c
            label = (f"x{tuple(lead) + (c,)} w{tuple(w.shape)}"
                     f"{' geglu' if geglu else ''}")
            flop = 2 * m * c * w.shape[1]
            want = N.ln_linear_torch(x, gam, bet, w, b, geglu=geglu)
            bound = max(1e3 * (smoke.nbytes(x, gam, bet, w, b, want))
                        / smoke.HBM_BPS, 1e3 * flop / smoke.PEAK["bf16"])
            x2, g16, b16 = x.reshape(m, c), gam.to(x.dtype), bet.to(x.dtype)

            def two_call():
                return torch.mm(F.layer_norm(x2, (c,), g16, b16, 1e-5), w)

            lib = smoke.cuda_time_ms(two_call)
            lib_graph = smoke.graph_ms(two_call)
            smoke.log(f"{label}: layer_norm+mm {lib:.4f} ms (graph "
                      f"{lib_graph:.4f}, host {host_us(two_call):.1f} us), "
                      f"bound {bound:.4f} ms")
            if args.root:     # another checkout's wrapper and plan as they are
                pick, tiles = None, [None]

                def kern(tile):
                    return N.ln_linear(x, gam, bet, w, b, geglu=geglu)
            else:
                pick = N.ln_linear_plan(m, c, n, geglu, sms=sms).bn
                tiles = [pick] if args.quick else list(N.LN_TILES)

                def kern(tile):
                    return N.ln_linear(x, gam, bet, w, b, geglu=geglu,
                                       tile=tile)
            _build.DEFINES = builds[PORT]
            smoke.log(f"  host us a call {host_us(lambda: kern(pick)):.1f}")
            for stages in variants:
                _build.DEFINES = builds[stages]
                for tile in tiles:
                    _, err = smoke.errors(kern(tile), want)
                    ms = smoke.cuda_time_ms(lambda: kern(tile))
                    gms = smoke.graph_ms(lambda: kern(tile))
                    mark = " <- plan" if tile == pick and stages == PORT else ""
                    smoke.log(f"  bn {tile} stages {stages}: rel err "
                              f"{err:.2e}, {ms:.4f} ms, graph {gms:.4f} ms, "
                              f"{flop / gms / 1e9:.0f} TFLOP/s{mark}")
                    rows.append(dict(kernel="ln_linear", shape=label, bn=tile,
                                     stages=stages, ms=ms, graph_ms=gms,
                                     tflops=flop / gms / 1e9, rel_err=err,
                                     bound_ms=bound, library_ms=lib,
                                     library_graph_ms=lib_graph))
            for p in probes:
                _build.DEFINES = builds[f"probe {p}"]
                gms = smoke.graph_ms(lambda: kern(pick))
                smoke.log(f"  probe {p} (bn {pick}): graph {gms:.4f} ms, "
                          f"{flop / gms / 1e9:.0f} TFLOP/s")
                rows.append(dict(kernel="ln_linear", shape=label, bn=pick,
                                 probe=p, graph_ms=gms))
            _build.DEFINES = ()
            del x, w, want
            torch.cuda.empty_cache()

        for shape in LN_SHAPES:
            x = rn(*shape)
            s = rn(shape[-1], dtype=torch.float32)
            bb = rn(shape[-1], dtype=torch.float32)
            s16, b16 = s.to(x.dtype), bb.to(x.dtype)
            kern = lambda: N.fused_layer_norm(x, s, bb)
            lib_fn = lambda: F.layer_norm(x, (shape[-1],), s16, b16, 1e-5)
            _, err = smoke.errors(kern(), N.layer_norm_torch(x, s, bb))
            bound = 1e3 * smoke.nbytes(x, s, bb, x) / smoke.HBM_BPS
            row = dict(kernel="fused_layer_norm", shape=f"x{shape}",
                       rel_err=err, bound_ms=bound,
                       ms=smoke.cuda_time_ms(kern),
                       graph_ms=smoke.graph_ms(kern), host_us=host_us(kern),
                       library_ms=smoke.cuda_time_ms(lib_fn),
                       library_graph_ms=smoke.graph_ms(lib_fn),
                       library_host_us=host_us(lib_fn))
            smoke.log(f"fused_layer_norm x{shape}: rel err {err:.2e}, "
                      f"{row['ms']:.4f} ms, graph {row['graph_ms']:.4f} ms, "
                      f"host {row['host_us']:.1f} us; F.layer_norm "
                      f"{row['library_ms']:.4f} ms, graph "
                      f"{row['library_graph_ms']:.4f} ms, host "
                      f"{row['library_host_us']:.1f} us; bound {bound:.4f} ms")
            rows.append(row)
    print(json.dumps({"card": smi.stdout.strip(), "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
