#!/usr/bin/env python3
"""Every tile of the port's wgmma attention kernel at the attention shapes
of the serving and tiny paths, on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_attention_tiles.py``
(``--quick``: the plan's tile only, on the port's own build; ``--cross``:
the small-KV cross-attention kernel instead, below). It needs one CUDA card
and nvcc, and imports nothing of JAX.

The kernel's ring depth and turn-taking are constants of
``csrc/flash_attention.cuh``; this script builds the kernel library once for
each of 2, 3 and 4 stages with turn-taking off and on (``-DIDM_ATTN_STAGES``,
``-DIDM_ATTN_PINGPONG``), each with the BKV 64 tiles the port does not build
(``-DIDM_ATTN_SWEEP``: ``SWEEP_INSTANCES``). For each shape it times
``F.scaled_dot_product_attention`` on (B, H, S, D) copies of the same
tensors, then launches the kernel (``flash_attention_gemm`` shapes through
``csrc/flash_attention_gemm.cu`` in both softmax modes, the (B, S, H, D)
views through ``csrc/flash_attention.cu``) with each (BKV, consumer
warpgroups) at its padded head dim in each build, forced through
``attention_plan(tile=...)``: max |err| over max |plain| against the plain
version, ms and TFLOP/s, and the shape's bound and exponential floor; and
the host's microseconds a call (50 enqueues, no sync) of the kernel's
wrapper and of SDPA. Two times a call: ``ms`` (CUDA events over 10 eager
launches after 2, as chip_smoke.py times) and ``graph ms`` (10 launches
captured in a CUDA graph and replayed 3 times: the device alone, without
the host's pace between launches). The tile the plan picks in the port's
build (3 stages, turns on) is marked. These readings are the basis of
``cuda_attention.BKV`` and ``WGS_TFLOPS`` and of the header's constants.

``--cross`` times ``cross_attention_small_kv`` (``csrc/
cross_attention_small_kv.cu``, one tile: 128 queries, a 128-column head
group) at the variant path's four shapes in builds of 2, 3 and 4 ring
stages (``-DIDM_CROSS_STAGES``; ``--quick``: the port's 3): max |err| over
max |plain|, ms, graph ms, GB/s of its bytes and host µs a call, beside
the bound (its bytes over the memory rate) and the two-call yardstick,
``F.scaled_dot_product_attention`` of each branch on head-major copies
summed in fp32 (``--probe``: ``CROSS_PROBES``, measurement builds that
skip the IP branch, the stores or the softmax). Its readings are the
header's ``IDM_CROSS_STAGES``.
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

# ("gemm", B, N, heads, D, garment, uncond): flash_attention_gemm's path
# shapes (the tiny UNet's 128-wide level last); ("heads", B, Sq, heads, D,
# garment M): flash_attention's; ("fused", B, St, heads, D, s_own):
# flash_attention_fused_qkv's
SHAPES = [("gemm", 4, 3072, 10, 64, True, 2), ("gemm", 4, 768, 20, 64, True, 2),
          ("gemm", 2, 3072, 10, 64, False, 0),
          ("gemm", 2, 768, 20, 64, False, 0), ("gemm", 4, 768, 8, 16, True, 2),
          ("heads", 4, 3072, 4, 16, 3072), ("heads", 2, 3072, 4, 16, 0),
          ("heads", 4, 3072, 10, 64, 3072),
          ("fused", 4, 6144, 4, 16, 3072), ("fused", 4, 6144, 10, 64, 3072)]
# (stages, turn-taking) of each build; the port's is PORT
VARIANTS = [(s, pp) for s in (2, 3, 4) for pp in (False, True)]
PORT = (3, True)
# the (DP, BKV, consumer warpgroups) that -DIDM_ATTN_SWEEP adds to
# cuda_attention.INSTANCES (flash_attention.cuh::dispatch)
SWEEP_INSTANCES = frozenset([(16, 64, 2), (64, 64, 2), (64, 64, 3)])
# --cross: (B, N, heads, IP branch) of the variant path's cross-attention
# (64-wide heads, 77 text + 16 IP tokens), the ring depths built and the
# port's (csrc/cross_attention_small_kv.cu's IDM_CROSS_STAGES)
CROSS_SHAPES = [(4, 3072, 10, True), (4, 768, 20, True), (2, 3072, 10, False),
                (2, 768, 20, False)]
CROSS_STAGES = (2, 3, 4)
CROSS_PORT = 3
# --cross --probe: measurement builds of the port's ring that skip the IP
# branch, the output stores or the softmax (-DIDM_CROSS_PROBE); their
# results are wrong and not checked
CROSS_PROBES = {"no IP": ("-DIDM_CROSS_PROBE=1",),
                "no stores": ("-DIDM_CROSS_PROBE=2",),
                "no softmax": ("-DIDM_CROSS_PROBE=4",),
                "none of the three": ("-DIDM_CROSS_PROBE=7",)}


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


def cross_sweep(args, card):
    """The --cross readings: each ring depth's build at each path shape."""
    import torch
    import torch.nn.functional as F
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops import cuda_attention as A
    stages = [CROSS_PORT] if args.quick else list(CROSS_STAGES)
    builds = {s: () if s == CROSS_PORT else (f"-DIDM_CROSS_STAGES={s}",)
              for s in stages}
    probes = CROSS_PROBES if args.probe else {}
    builds.update({f"probe {p}": d for p, d in probes.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.build(defines=d), builds.values()))
    smoke.log(f"{len(builds)} builds in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    with torch.inference_mode():
        for b, n, heads, ip in CROSS_SHAPES:
            hd = heads * 64
            q, kv = rn(b, n, hd), rn(b, 77, 2 * hd)
            kv_ip = rn(b, 16, 2 * hd) if ip else None

            def major(t, i):
                return (t[..., i * hd:(i + 1) * hd]
                        .reshape(b, t.shape[1], heads, 64).transpose(1, 2)
                        .contiguous())

            qt, kt, vt = (q.reshape(b, n, heads, 64).transpose(1, 2)
                          .contiguous(), major(kv, 0), major(kv, 1))
            if ip:
                kit, vit = major(kv_ip, 0), major(kv_ip, 1)

                def two():
                    return (F.scaled_dot_product_attention(qt, kt, vt).float()
                            + F.scaled_dot_product_attention(qt, kit,
                                                             vit).float())
            else:
                def two():
                    return F.scaled_dot_product_attention(qt, kt, vt)

            def kern():
                return A.cross_attention_small_kv(q, kv, kv_ip, heads=heads)

            label = f"q{(b, n, hd)} heads {heads}{' + IP' if ip else ''}"
            want = A.cross_attention_small_kv_torch(q, kv, kv_ip, heads=heads)
            nbytes = smoke.nbytes(q, kv, kv_ip, want)
            bound = 1e3 * nbytes / smoke.HBM_BPS
            lib, lib_graph = smoke.cuda_time_ms(two), smoke.graph_ms(two)
            _build.DEFINES = builds[CROSS_PORT]
            smoke.log(f"{label}: sdpa_sum {lib:.4f} ms (graph "
                      f"{lib_graph:.4f}, host {host_us(two):.1f} us), bound "
                      f"{bound:.4f} ms; kernel host us a call "
                      f"{host_us(kern):.1f}")
            for st in stages:
                _build.DEFINES = builds[st]
                _, err = smoke.errors(kern(), want)
                ms, gms = smoke.cuda_time_ms(kern), smoke.graph_ms(kern)
                mark = " <- port" if st == CROSS_PORT else ""
                smoke.log(f"  stages {st}: rel err {err:.2e}, {ms:.4f} ms, "
                          f"graph {gms:.4f} ms, {nbytes / gms / 1e6:.0f} "
                          f"GB/s{mark}")
                rows.append(dict(kernel="cross_attention_small_kv",
                                 shape=label, stages=st, ms=ms, graph_ms=gms,
                                 rel_err=err, bound_ms=bound,
                                 library_ms=lib, library_graph_ms=lib_graph))
            for p in probes:
                _build.DEFINES = builds[f"probe {p}"]
                gms = smoke.graph_ms(kern)
                smoke.log(f"  probe {p}: graph {gms:.4f} ms")
                rows.append(dict(kernel="cross_attention_small_kv",
                                 shape=label, probe=p, graph_ms=gms))
            _build.DEFINES = ()
            del q, kv, kv_ip, want
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}), flush=True)


def defines(stages, pingpong):
    return ("-DIDM_ATTN_SWEEP", f"-DIDM_ATTN_STAGES={stages}",
            f"-DIDM_ATTN_PINGPONG={int(pingpong)}")


def tiles(dp):
    """Every (BKV, consumer warpgroups) the sweep's builds hold at padded
    head dim dp."""
    from idmvton_tpu_torch.ops import cuda_attention as A
    return [(bkv, wgs) for p, bkv, wgs in sorted(A.INSTANCES | SWEEP_INSTANCES)
            if p == dp]


def cases(dev, g):
    """(label, (b, sq, heads, d), [(mode, kernel(tile), plain)], sdpa,
    logits, flop, ins) of each shape."""
    import torch
    import torch.nn.functional as F
    from idmvton_tpu_torch.ops import cuda_attention as A

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def bhsd(t):
        return t.transpose(1, 2).contiguous()

    for kind, b, n, heads, d, *rest in SHAPES:
        if kind == "gemm":
            garment, uncond = rest
            hd = heads * d
            qkv = rn(b, n, 3 * hd)
            kv = rn(b - uncond, n, 2 * hd) if garment else None
            q, k, v = (bhsd(qkv[..., i * hd:(i + 1) * hd].reshape(
                b, n, heads, d)) for i in range(3))
            logits = b * n * n
            if garment:
                kvz = torch.cat([kv.new_zeros(uncond, n, 2 * hd), kv])
                k = torch.cat([k, bhsd(kvz[..., :hd].reshape(b, n, heads, d))],
                              2)
                v = torch.cat([v, bhsd(kvz[..., hd:].reshape(b, n, heads, d))],
                              2)
                logits += (b - uncond) * n * n
            runs = [(f"fixed_shift={fs}",
                     (lambda tile, fs=fs: A._gemm_launch(
                         qkv, kv, heads, None, 0, uncond, fs, tile)),
                     lambda: A.flash_attention_gemm_torch(
                         qkv, kv, heads=heads, uncond_rows=uncond))
                    for fs in (True, False)]
            label = (f"gemm qkv{(b, n, 3 * hd)} heads {heads}"
                     + (f" garment M={n} uncond={uncond}" if garment else ""))
            ins = [qkv, kv]
        elif kind == "heads":
            (m,) = rest
            hd = heads * d
            qkv = rn(b, n, 3 * hd)
            q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(b, n, heads, d)
                       for i in range(3))
            ins, kg, vg = [qkv], None, None
            if m:   # the garment K/V: the kernel's second key segment
                kg, vg = rn(b, m, heads, d), rn(b, m, heads, d)
                ins += [kg, vg]
            runs = [("online",
                     (lambda tile, q=q, k=k, v=v, kg=kg, vg=vg:
                      A._flash_launch(q, k, v, d ** -0.5, tile, kg, vg)),
                     (lambda q=q, k=k, v=v, kg=kg, vg=vg:
                      A.flash_attention_torch(q, *(
                          (torch.cat([k, kg], 1), torch.cat([v, vg], 1))
                          if m else (k, v)))))]
            if m:
                k, v = torch.cat([k, kg], 1), torch.cat([v, vg], 1)
            q, k, v = bhsd(q), bhsd(k), bhsd(v)
            logits = b * n * (n + m)
            label = f"heads q{(b, n, heads, d)} over {n + m} keys"
        else:
            (s_own,) = rest
            qkv = rn(b, n, 3, heads, d)
            views = (qkv[:, :s_own, 0], qkv[:, :, 1], qkv[:, :, 2])
            runs = [("online",
                     (lambda tile, views=views: A._flash_launch(
                         *views, d ** -0.5, tile)),
                     (lambda qkv=qkv: A.flash_attention_fused_qkv_torch(
                         qkv, s_own)))]
            q, k, v = (bhsd(t) for t in views)
            logits = b * s_own * n
            label = f"fused qkv{(b, n, 3, heads, d)} s_own {s_own}"
            ins = [qkv]
        sq = s_own if kind == "fused" else n
        yield (label, (b, sq, heads, d), runs,
               (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)),
               heads * logits, 4 * heads * logits * d, ins)


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="time only the tile the plan picks, on the port's "
                         "own build")
    ap.add_argument("--cross", action="store_true",
                    help="sweep the small-KV cross-attention kernel instead")
    ap.add_argument("--probe", action="store_true",
                    help="--cross: also time the CROSS_PROBES builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs "
                   "a card")
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops import cuda_attention as A

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smoke.log(smi.stdout.strip())
    if args.cross:
        return cross_sweep(args, smi.stdout.strip())
    variants = [PORT] if args.quick else VARIANTS
    builds = {v: () if args.quick else defines(*v) for v in variants}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.build(defines=d), builds.values()))
    smoke.log(f"{len(builds)} builds in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)
    rows = []
    with torch.inference_mode():
        for label, shape, runs, sdpa, logits, flop, ins in cases(dev, g):
            lib = smoke.cuda_time_ms(sdpa)
            lib_graph = smoke.graph_ms(sdpa)
            out_bytes = smoke.nbytes(sdpa())
            bound = max(1e3 * (smoke.nbytes(ins) + out_bytes) / smoke.HBM_BPS,
                        1e3 * flop / smoke.PEAK["bf16"])
            exp_floor = 1e3 * logits / smoke.EXP_RATE
            smoke.log(f"{label}: SDPA {lib:.4f} ms (graph {lib_graph:.4f}), "
                      f"bound {bound:.4f} ms, exp floor {exp_floor:.4f} ms")
            # the plan's tile: its warpgroups hang on (b, sq, heads) alone
            plan = A.attention_plan(*shape[:2], *shape[1:], sms=sms)
            pick = (plan.bkv, plan.wgs)
            for mode, kern, plain in runs:
                want = plain()
                _build.DEFINES = builds[PORT]
                # host time of an enqueue (50 calls, no sync), kernel and SDPA
                host = []
                for fn in (lambda: kern(pick), sdpa):
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(50):
                        fn()
                    host.append((time.perf_counter() - t0) / 50 * 1e6)
                    torch.cuda.synchronize()
                smoke.log(f"  {mode}: host us a call {host[0]:.1f} (SDPA "
                          f"{host[1]:.1f})")
                for variant in variants:
                    _build.DEFINES = builds[variant]
                    for tile in [pick] if args.quick else tiles(plan.dp):
                        _, err = smoke.errors(kern(tile), want)
                        ms = smoke.cuda_time_ms(lambda: kern(tile))
                        gms = smoke.graph_ms(lambda: kern(tile))
                        mark = (" <- plan" if tile == pick and variant == PORT
                                else "")
                        smoke.log(f"  {mode} bkv {tile[0]} stages "
                                  f"{variant[0]} pingpong {int(variant[1])} "
                                  f"wgs {tile[1]}: rel err {err:.2e}, "
                                  f"{ms:.4f} ms, graph {gms:.4f} ms, "
                                  f"{flop / gms / 1e9:.0f} TFLOP/s{mark}")
                        rows.append(dict(shape=label, mode=mode, dp=plan.dp,
                                         bkv=tile[0], stages=variant[0],
                                         pingpong=variant[1], wgs=tile[1],
                                         ms=ms, graph_ms=gms, rel_err=err,
                                         sdpa_ms=lib, sdpa_graph_ms=lib_graph,
                                         bound_ms=bound,
                                         exp_floor_ms=exp_floor))
                del want
            _build.DEFINES = ()
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi.stdout.strip(), "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
