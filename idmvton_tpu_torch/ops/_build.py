"""Build the CUDA kernels at first use and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch
headers), so ``nvcc`` builds them in seconds. They compile in parallel into
one shared library under ``idmvton_tpu_torch/_build/``, named by a hash of
the sources and flags; a library that is already there is reused. Every C
entry point returns ``cudaGetLastError()`` (or the error of a failed
attribute call) and the wrappers raise on a non-zero code.

Nothing here runs at import: ``lib()`` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("ln_linear.cu", "ln_linear_i8.cu", "gn_stats.cu", "conv3x3.cu",
           "conv3x3_padacc.cu", "flash_attention_gemm.cu",
           "cross_attention_small_kv.cu", "flash_attention.cu",
           "adam_int8.cu")
HEADERS = ("common.cuh", "conv3x3.cuh", "flash_attention.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return int, a cudaError_t)
SIGNATURES = {
    # x, gamma, beta, w, bias, bias_bf16, stats scratch, out, M, C, N, eps,
    # then the plan (an int64 array: cuda_norm.LnLinearPlan.c_plan)
    "idm_ln_linear": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _P,
                      _P],
    # x, gamma, beta, w (N, C) storage, w_scale, bias, bias_bf16, codes and
    # rs scratch, out, M, C, N, eps, then the plan (an int64 array:
    # cuda_norm.LnLinearI8Plan.c_plan)
    "idm_ln_linear_i8": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                         _F, _P, _P],
    # x, gamma, beta, codes, rs, M, C, eps: the W8A8 pre-pass alone
    "idm_ln_quant_i8": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "idm_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _P],
    "idm_gn_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, mean_c, mean2_c, scale, bias, out, B, S, C, groups, eps, silu,
    # bf16, the card's SMs
    "idm_gn_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                     _P],
    # ... B, H, W, Cin, Cout, f32, then the plan: bn, tile_h, tile_w
    "idm_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ... B, H, W, Cin, Cout, f32, then the plan: bm, bn, tiles_per_image
    "idm_conv3x3_padacc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    # ... B, N, M, H, D, sink_tokens, scale, fixed_shift, then the plan (an
    # int64 array: cuda_attention.AttentionPlan.c_plan)
    "idm_flash_attention_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                                 _P, _P],
    # q, kv, kv_ip, out, B, N, H, D, S_text, S_ip, scale, ip_scale, then the
    # plan (an int64 array: cuda_attention.CrossPlan.c_plan)
    "idm_cross_attention_small_kv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _F, _P, _P],
    # q, k, v, garment k, v, out, B, Sq, Skv, M, H, D, scale, then the plan
    "idm_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P, _P],
    # leaf table, gradient addresses, leaves, covered blocks, partial
    # scratch and its capacity, out (the norm)
    "idm_adam_int8_norm": [_P, _P, _I, _I, _P, _I, _P, _P],
    # leaf table, gradient addresses, leaves, mu_q, mu_s, nu_q, nu_s, norm,
    # clip, max_norm, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps, wd, -lr,
    # exp2 span, span, then the block range lo, hi
    "idm_adam_int8_update": [_P, _P, _I, _P, _P, _P, _P, _P, _I] + [_F] * 12
    + [_I, _I, _P],
}

# -D flags of the library that ``lib()`` builds and binds: none for the
# port; scripts/torch_attention_tiles.py sets the attention kernels' other
# ring depths, turn-taking and tiles, scripts/torch_ln_tiles.py the
# ln_linear and ln_linear_i8 kernels' ring depths
DEFINES: tuple = ()

_lock = threading.Lock()
_libs = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return found


def _digest(defines=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(defines=()) -> Path:
    return BUILD_DIR / f"libidmvton_kernels_{_digest(defines)}.so"


def build(verbose: bool = False, defines=()) -> Path:
    """Compile the sources (in parallel) with the -D flags ``defines`` and
    link the shared library."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    extra = ["-Xptxas", "-v"] if verbose else []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, *defines, *extra, "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    errors = []
    for name, p in procs:
        log, _ = p.communicate()
        if verbose or p.returncode != 0:
            print(f"--- nvcc {name} (rc={p.returncode})\n{log}", flush=True)
        if p.returncode != 0:
            errors.append(name)
    try:
        if errors:
            raise RuntimeError(f"nvcc failed for {errors}")
        tmp = out.with_suffix(f".{tag}.tmp")
        subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", *map(str, objs),
                        "-o", str(tmp)], check=True)
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library of ``DEFINES``, built on first use."""
    defines = DEFINES
    with _lock:
        if defines not in _libs:
            handle = ctypes.CDLL(str(build(defines=defines)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.idm_error_string.argtypes = [ctypes.c_int]
            handle.idm_error_string.restype = ctypes.c_char_p
            _libs[defines] = handle
        return _libs[defines]


def no_autograd(name: str, *tensors) -> None:
    """Raises where autograd would record a launch of kernel ``name``: grad
    mode on and an input that requires grad. A kernel writes a fresh
    output that autograd cannot see, so every gradient through the call
    would be dropped without a word. The sites differentiate through
    ``ops.autograd``, whose Functions launch with grad mode off."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a kernel launch under autograd with an input that "
            f"requires grad; call it through ops.autograd (its VJP) or "
            f"under torch.no_grad()")


def ptr(t, name: str, dtype, device=None, *, contiguous: bool = True) -> int:
    """Device pointer of ``t`` after the checks every kernel needs: a CUDA
    tensor of ``dtype`` (on ``device`` when given), contiguous unless the
    kernel reads it through strides (``contiguous=False``: the caller checks
    the strides), 16-byte aligned for the kernels' vector loads. ``None``
    passes as NULL."""
    if t is None:
        return None
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    return t.data_ptr()


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def call(name: str, *args) -> None:
    """Launch C entry ``name``; raise if it reports a CUDA error."""
    handle = lib()
    rc = getattr(handle, name)(*args)
    if rc != 0:
        msg = handle.idm_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
