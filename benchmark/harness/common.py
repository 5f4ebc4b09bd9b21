"""What every cell shares: seeds, the cell's files by name, the seeded
weights, the device record, limits and the result line."""

from __future__ import annotations

import hashlib
import importlib.util
import itertools
import json
import math
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# modules that may not be loaded in a process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "idmvton_tpu")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    key = ":".join(str(t) for t in (seed,) + tags).encode()
    return int(hashlib.sha256(key).hexdigest()[:15], 16)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The workload ``name`` of BENCHMARK.json with its configuration file,
    traffic file, metrics and limits resolved by name."""
    spec = load_json(bench_file)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in {bench_file}")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])

    def reports(m):
        return m.get("workloads") is None or name in m["workloads"]

    return {
        "workload": work,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
        "per_layer": [m for m in spec["per_layer"] if reports(m)],
    }


def reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py`` (a metric's name may
    hold dots, so it is loaded by its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------

AFFINE_STD = 0.1      # biases and norm shifts; norm scales are 1 + that


def leaf_values(raw: torch.Tensor, shape, kind: str) -> torch.Tensor:
    """A leaf's fp32 values from its standard normal draws."""
    x = raw.float().reshape(shape)
    if kind == "kernel":
        return x * (math.prod(shape[:-1]) ** -0.5)
    if kind in ("bias", "shift"):
        return x * AFFINE_STD
    if kind == "scale":
        return x * AFFINE_STD + 1.0
    if kind == "embedding":
        return x * 0.02
    if kind == "latents":
        return x * (shape[-1] ** -0.5)
    raise ValueError(kind)


def make_weights(specs: dict, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """``{"<component>.<name>": tensor}`` in ``dtype``: one standard normal
    draw a component on ``device``, each leaf a slice of it scaled by its
    kind and rounded once to ``dtype``."""
    flat = {}
    for comp, leaves in specs.items():
        total = sum(math.prod(s) for _, s, _ in leaves)
        buf = torch.randn(total, generator=generator(device, seed, "w", comp),
                          device=device, dtype=dtype)
        off = 0
        for name, shape, kind in leaves:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            leaf.copy_(leaf_values(leaf, shape, kind))
            flat[f"{comp}.{name}"] = leaf
            off += n
    return flat


def load_into(modules: dict, flat: dict):
    """Copies the flat weights into the program's modules by name; the
    names and shapes must be exactly the modules' parameters."""
    with torch.no_grad():
        for comp, module in modules.items():
            params = dict(module.named_parameters())
            want = {n[len(comp) + 1:] for n in flat
                    if n.startswith(comp + ".")}
            if set(params) != want:
                raise SystemExit(
                    f"{comp}: the program's parameters differ from the "
                    f"benchmark's: missing {sorted(want - set(params))[:5]}, "
                    f"extra {sorted(set(params) - want)[:5]}")
            for n, p in params.items():
                w = flat[f"{comp}.{n}"]
                if tuple(p.shape) != tuple(w.shape):
                    raise SystemExit(f"{comp}.{n}: program {tuple(p.shape)}"
                                     f" vs benchmark {tuple(w.shape)}")
                p.copy_(w)


# ---------------------------------------------------------------------------
# comparisons, statistics, the result
# ---------------------------------------------------------------------------


def rel(got, want) -> float:
    """||got - want|| / ||want|| in fp64; inf where got is not finite."""
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def device_record(device, peak_bytes: int, count: int = 1) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def narrow_tensors(modules: dict, dtype: str) -> int:
    """The number of parameters and buffers of ``modules`` whose elements
    are narrower than ``dtype``, the precision the configuration states
    (``"bfloat16"``): int8 codes, float8. A program that serves or trains
    from them has lowered the stated precision, whatever its outputs read
    (the port's W8A8 path, ``quantize_unet_linears_int8``, keeps int8
    codes in the UNets' linears)."""
    width = getattr(torch, dtype).itemsize
    return sum(1 for m in modules.values()
               for t in itertools.chain(m.parameters(), m.buffers())
               if t.dtype != torch.bool and t.element_size() < width)


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [{name, value, limit}]): every reading at or under its
    limit; a reading with no limit fails."""
    checks = []
    ok = True
    for name, value in readings.items():
        lim = limits.get(name)
        good = lim is not None and math.isfinite(value) and value <= lim
        ok &= good
        checks.append({"name": name, "value": value, "limit": lim})
    return ok, checks

