#!/usr/bin/env python3
"""Concurrent demo requests against a port's step capture, on one NVIDIA
card: ``tests/test_torch_cuda.py``'s
``test_concurrent_demo_requests_keep_exact_launch_counts`` (try-on requests
that each capture their step, beside a thread looping over the
preprocessing nets; both must finish with exact launch counts), run
``--runs`` times against the ``idmvton_tpu_torch`` of this checkout or of
``--root DIR`` (another checkout, e.g. a parent unpacked with ``git
archive``, for an A/B in one call).

Run from the root of a checkout: ``python3 scripts/torch_concurrent_requests.py
[--root DIR] [--runs 3]``. A port whose service has no ``pose_image`` (one
from before the lock covered a request's card work) gets one that calls
its DensePose net as its requests do, outside any lock. Prints each run's
result; exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="test the idmvton_tpu_torch of this checkout")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() if args.root else ROOT))
    sys.path.insert(1, str(ROOT / "tests"))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this check needs a card",
              file=sys.stderr)
        sys.exit(1)
    import idmvton_tpu_torch
    from idmvton_tpu_torch.cli.demo import TryonService
    print(f"port under test: {idmvton_tpu_torch.__file__}", flush=True)
    if not hasattr(TryonService, "pose_image"):
        TryonService.pose_image = lambda self, person: self.densepose(person)
    import test_torch_cuda
    dev = torch.device("cuda", 0)
    failed = 0
    for i in range(args.runs):
        try:
            test_torch_cuda.test_concurrent_demo_requests_keep_exact_launch_counts(
                dev)
            print(f"run {i}: passed", flush=True)
        except Exception:    # a run's failure is the reading
            failed += 1
            print(f"run {i}: FAILED", flush=True)
            traceback.print_exc(limit=2)
    print(f"{args.runs - failed} of {args.runs} runs passed", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
