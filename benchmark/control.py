"""Readings of the comparison that decides ``correct``, for setting its
limits: the program as the cell states it, the controls, or the faults,
on many seeds in one process. Not part of a benchmark run.

    python3 benchmark/control.py --workload serve.vitonhd_b2 \\
        --path program|w8a8|e4m3|faults --seeds 11,12,13

- ``program``: each seed builds the cell's stack from its weights, runs
  its set-up (serving: one request, which captures the step; training:
  the judged step) and judges it against the fp32 reference, as a run
  does.
- ``w8a8`` (serving): the program's own int8 path, the precision below
  bf16 it offers (every transformer block's ``to_qkv`` and ``ff.proj_in``
  of TryonNet and ``ff.proj_in`` of GarmentNet quantized, run by the W8A8
  kernel); its int8 codes fail ``narrow_tensors``.
- ``e4m3``: the reference itself in the program's place with every
  product's operands in float8 e4m3, judged by the same comparison
  (``serve.e4m3_control``, ``train.e4m3_control``).
- ``faults`` (training): the faults planted in the reference put in the
  program's place (``train.fault_readings``).

One JSON line a seed, with ``correct`` as the cell's limits judge the
readings (``common.judge``; for ``faults``, one a fault)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import common  # noqa: E402


def w8a8(models):
    from idmvton_tpu_torch.models.attention import quantize_unet_linears_int8
    quantize_unet_linears_int8(models.unet)
    quantize_unet_linears_int8(models.garm, attn_qkv=False)


PATHS = ("program", "w8a8", "e4m3", "faults")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--path", choices=PATHS, default="program")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = common.cell(args.workload)
    cell["traffic"] = dict(cell["traffic"], warmup_requests=0)
    seconds = 0.0  # the set-up alone: the judged work
    gen = __import__(f"benchmark.harness.{cell['traffic']['generator']}",
                     fromlist=["run"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.path == "e4m3":
            readings, info = gen.e4m3_control(cell, seed, dev)
            res = {"readings": readings, "info": info, "failed": 0}
        elif args.path == "faults":
            res = {"readings": gen.fault_readings(cell, seed, dev),
                   "info": {}, "failed": 0}
        else:
            res = gen.run(cell, seed, seconds, False, dev, t0,
                          prepare=w8a8 if args.path == "w8a8" else None)
        if args.path == "faults":
            correct = {f: common.judge(r, cell["limits"])[0]
                       for f, r in res["readings"].items()}
        else:
            correct = (common.judge(res["readings"], cell["limits"])[0]
                       and res["failed"] == 0)
        print(json.dumps({"seed": seed, "path": args.path,
                          "correct": correct,
                          "readings": res["readings"], "info": res["info"],
                          "failed": res["failed"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
