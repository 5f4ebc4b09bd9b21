"""Where the time of a checkpoint load goes, stage by stage.

    python3 -m idmvton_tpu_torch.weights.load_profile [--device cuda]
        [--tiny]

Builds the seed-0 random stack (full SDXL widths unless ``--tiny``), writes
it as a bf16 diffusers tree (``save_diffusers``) into a temporary directory
and frees it, then times, each stage alone and synchronised with the card:

- ``read_cold`` / ``from_diffusers_cold``: the port's reader over every
  file to the host, and ``from_diffusers`` (no calibration), each after
  the tree's pages were dropped from the page cache (``fsync``, then
  ``POSIX_FADV_DONTNEED``); the share of the tree's pages still resident
  before each (``mincore``) says how cold the read really was;
- ``read`` / ``read_to_card`` / ``from_diffusers``: the same with the
  cache warm;
- ``build``: the kernel library, compiled unless a build of the same
  sources is already on disk (``library_on_disk`` says which);
- ``calibrate_first`` / ``calibrate_again``: ``calibrate_attention_softmax``
  on the loaded weights, the first call in the process and a second one.

A server's cold start in a fresh checkout waits for ``build`` +
``calibrate_first`` on top of the load; with the library on disk, for
``calibrate_first`` alone. Prints one line a stage, the card's name and
power limit first, and the whole as a JSON object on the last line.
Needs room for the tree (2 bytes a
parameter) in ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import mmap
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch


def _files(root: str) -> list:
    return sorted(os.path.join(d, f) for d, _, names in os.walk(root)
                  for f in names if f.endswith(".safetensors"))


def resident_share(paths) -> float:
    """The share of the files' pages in the page cache (``mincore`` over a
    read-only shared mapping of each)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p]
    page = os.sysconf("SC_PAGE_SIZE")
    total = resident = 0
    for path in paths:
        size = os.path.getsize(path)
        if size == 0:
            continue
        n = (size + page - 1) // page
        vec = (ctypes.c_ubyte * n)()
        with open(path, "rb") as f:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED,
                             f.fileno(), 0)
            if addr in (None, ctypes.c_void_p(-1).value):
                raise OSError(ctypes.get_errno(), f"mmap {path}")
            try:
                if libc.mincore(addr, size, vec) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore {path}")
            finally:
                libc.munmap(addr, size)
        total += n
        resident += sum(b & 1 for b in vec)
    return resident / max(total, 1)


def drop_cache(paths) -> None:
    """Asks the kernel to drop the files' pages from the page cache."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def read_all(paths, device) -> int:
    """Every tensor of every file through the port's reader; the bytes."""
    from idmvton_tpu_torch.weights.safetensors import SafetensorsReader
    nbytes = 0
    for path in paths:
        with SafetensorsReader(path, device) as r:
            for name in r:
                t = r.get_tensor(name)
                nbytes += t.numel() * t.element_size()
    return nbytes


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test configs (a rehearsal on the CPU)")
    args = ap.parse_args(argv)

    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.weights.checkpoint import (
        calibrate_attention_softmax, from_diffusers, save_diffusers,
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA card is visible")
    result = {"card": card_line()}
    print(result["card"], flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(label, fn, nbytes=None):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        entry = {"s": secs}
        if nbytes is not None:
            entry["GB_s"] = nbytes / secs / 1e9
        result[label] = entry
        rate = f", {entry['GB_s']:.3f} GB/s" if nbytes is not None else ""
        print(f"{label}: {secs:.3f} s{rate}", flush=True)
        return out

    def free():
        import gc
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="idmvton_load_profile_")
    try:
        with torch.inference_mode():
            models = timed("stack", lambda: TryonModels.init(
                0, tiny=args.tiny, device=device,
                dtype=torch.bfloat16))
            timed("export", lambda: save_diffusers(tmp, models,
                                                   dtype=torch.bfloat16))
            del models
            free()
            paths = _files(tmp)
            timed("flush", lambda: drop_cache(paths))
            size = sum(os.path.getsize(p) for p in paths)
            result["tree_bytes"] = size
            print(f"tree: {len(paths)} files, {size} bytes", flush=True)

            def cold(label, fn):
                drop_cache(paths)
                share = resident_share(paths)
                result[f"{label}_resident_before"] = share
                print(f"{label}: {share:.4f} of the tree's pages resident "
                      f"before", flush=True)
                return timed(label, fn, size)

            cold("read_cold", lambda: read_all(paths, "cpu"))
            cold("from_diffusers_cold", lambda: from_diffusers(
                tmp, torch.bfloat16, device=device, calibrate=False))
            free()
            result["resident_warm"] = resident_share(paths)
            print(f"warm: {result['resident_warm']:.4f} of the tree's pages "
                  f"resident", flush=True)
            timed("read", lambda: read_all(paths, "cpu"), size)
            timed("read_to_card", lambda: read_all(paths, device), size)
            loaded = timed("from_diffusers", lambda: from_diffusers(
                tmp, torch.bfloat16, device=device, calibrate=False), size)

            result["library_on_disk"] = _build.library_path().exists()
            if device.type == "cuda":
                timed("build", lambda: (_build.build(), _build.lib()))
            report = timed("calibrate_first",
                           lambda: calibrate_attention_softmax(loaded))
            timed("calibrate_again",
                  lambda: calibrate_attention_softmax(loaded))
            result["calibration"] = report
            print(f"library on disk before the build: "
                  f"{result['library_on_disk']}; calibration: "
                  f"{json.dumps(report)}", flush=True)
            del loaded
            free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
