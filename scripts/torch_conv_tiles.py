#!/usr/bin/env python3
"""Every (BM, BN) tile of the port's wgmma conv kernel at the conv shapes
of the serving path, on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_conv_tiles.py``.
It needs one CUDA card and nvcc, and imports nothing of JAX.

For each shape it times ``F.conv2d`` (cuDNN, TF32 off) on channels_last
views of the same tensors, then launches the kernel of both sources
(``conv3x3.cu``, halo boxes; ``conv3x3_padacc.cu``, padded rows, its
``F.pad`` included) with each tile of ``cuda_conv.TILES`` forced through
``conv_plan(tile=...)``: max |err| over max |plain| against
``conv3x3_torch``, ms (CUDA events, 10 launches after 2) and TFLOP/s. The
tile the plan picks is marked. These rates are ``cuda_conv.TILE_TFLOPS``,
the plan's cost model.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

# (B, H, W, Cin, Cout): chip_smoke's conv cases, then two skip-concat convs
SHAPES = [(4, 128, 96, 320, 320), (4, 64, 48, 640, 640),
          (4, 32, 24, 1280, 1280), (4, 128, 96, 960, 320),
          (6, 1024, 768, 128, 128), (2, 512, 384, 512, 256),
          (6, 128, 96, 512, 512), (4, 64, 48, 1920, 640),
          (4, 32, 24, 2560, 1280)]


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs "
                   "a card")
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops import cuda_conv as CV

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smoke.log(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    smoke.log(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)
    st = _build.stream_ptr(dev)

    def launch(x, k, bias, padded, tile):
        b, h, w, cin = x.shape
        cout = k.shape[-1]
        plan = CV.conv_plan(b, h, w, cin, cout, padded=padded, tile=tile)
        out = torch.empty(b, h, w, cout, dtype=x.dtype, device=dev)
        if padded:
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))
            _build.call("idm_conv3x3_padacc", xp.data_ptr(), k.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
                        0, plan.bm, plan.bn, plan.tiles_per_image, st)
        else:
            _build.call("idm_conv3x3", x.data_ptr(), k.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
                        0, plan.bn, plan.tile_h, plan.tile_w, st)
        return out

    with torch.inference_mode():
        for b, h, w, cin, cout in SHAPES:
            x = torch.randn(b, h, w, cin, generator=g, device=dev).bfloat16()
            k = (torch.randn(3, 3, cin, cout, generator=g, device=dev)
                 * (9 * cin) ** -0.5).bfloat16()
            bias = torch.randn(cout, generator=g, device=dev)
            want = CV.conv3x3_torch(x, k, bias)
            xc = x.permute(0, 3, 1, 2)
            kc = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b16 = bias.bfloat16()
            flop = 2 * b * h * w * 9 * cin * cout
            lib = smoke.cuda_time_ms(lambda: F.conv2d(xc, kc, b16, padding=1))
            smoke.log(f"x{(b, h, w, cin)} -> {cout}: F.conv2d {lib:.4f} ms "
                      f"({flop / lib / 1e9:.0f} TFLOP/s)")
            for padded in (False, True):
                if padded and h > 256:   # the variant sends no VAE level here
                    continue
                pick = CV.conv_plan(b, h, w, cin, cout, padded=padded,
                                    sms=sms)
                for tile in CV.TILES:
                    _, err = smoke.errors(launch(x, k, bias, padded, tile),
                                          want)
                    ms = smoke.cuda_time_ms(
                        lambda: launch(x, k, bias, padded, tile))
                    mark = " <- plan" if tile == (pick.bm, pick.bn) else ""
                    smoke.log(f"  {'padded' if padded else 'halo  '} "
                              f"{tile}: rel err {err:.2e}, {ms:.4f} ms, "
                              f"{flop / ms / 1e9:.0f} TFLOP/s{mark}")
            del x, k, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
