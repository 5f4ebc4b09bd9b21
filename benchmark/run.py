"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cell's cards. The
cell (``BENCHMARK.json``'s workload) names its configuration file
(``benchmark/configs/``), its traffic file (``benchmark/traffic/``, whose
``generator`` names the general generator in ``benchmark/harness/``) and its
limits (``benchmark/limits/<workload>.json``); each per-layer metric is
read by ``benchmark/metrics/<metric>.py``. With ``--trace 0`` the last line
of standard output holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics and the breakdown of the traced window. Every run
checks what its timed path produced against the fp32 reference and prints
each number compared beside its limit, last on standard error and under
``checks`` in the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import common  # noqa: E402

GIB = 2 ** 30


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metric(value, unit):
    return {"value": value, "unit": unit}


def end_to_end(cell, res) -> dict:
    """The cell's end-to-end metrics from a run's result."""
    vals = dict(res["e2e"], setup_s=res["setup_s"],
                peak_gib=res["peak"] / GIB)
    return {m["name"]: metric(vals[m["name"]], m["unit"])
            for m in cell["end_to_end"] if m["name"] in vals}


def per_layer(cell, res) -> dict:
    out = {}
    for m in cell["per_layer"]:
        v = common.reader(m["name"]).read(cell, res)
        if v is not None:
            out[m["name"]] = metric(v, m["unit"])
    return out


def measure(cell, seed, seconds, trace, device, t_start=T_START) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict."""
    gen = importlib.import_module(
        f"benchmark.harness.{cell['traffic']['generator']}")
    res = gen.run(cell, seed, seconds, bool(trace), device, t_start)
    correct, checks = common.judge(res["readings"], cell["limits"])
    correct = correct and res["failed"] == 0
    out = {"correct": correct, "attempted": len(res["done"]),
           "failed": res["failed"],
           "metrics": per_layer(cell, res) if trace else end_to_end(cell,
                                                                     res),
           "device": common.device_record(device, res["peak"])}
    if trace and res["trace"] is not None:
        tr = res["trace"]
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.wall_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks + [{"name": "failed",
                                         "value": res["failed"],
                                         "limit": 0}]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    out = measure(cell, args.seed, args.seconds, args.trace, device)
    found = common.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
