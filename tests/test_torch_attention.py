"""The port's flash attention (kernels #9 and #10) against the JAX package's,
on the CPU.

The plain versions ``flash_attention_torch`` / ``_concat_kv_torch`` /
``_fused_qkv_torch`` (what the CUDA kernel is held to on the card, see
tests/test_torch_cuda.py) and the dispatching ops and modules above them
are compared with the JAX functions run as tests/test_ops.py runs them: the
Pallas kernels in interpret mode above the 256-key cutoff, the XLA einsum
below it. Inputs come from a numpy seed and go to both sides.

Tolerances: in fp32 both sides compute the same softmax (the Pallas kernel
online over KV blocks, the plain version at once) and differ only in
summation order: max |diff| <= 2e-5 at O(1) values. In bf16 the Pallas kernel
casts the unnormalized probabilities to bf16 for the PV product and the
plain version the normalized ones, and both round the output to bf16, so
they agree to a few bf16 ulps: max |diff| <= 2e-2 * max |JAX| (the bound
the card holds the kernel to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.models import attention as jatt
from idmvton_tpu.ops import pallas_attention as jpa
from idmvton_tpu_torch.models.attention import SelfAttention
from idmvton_tpu_torch.ops import attention as tattn
from idmvton_tpu_torch.ops import cuda_attention as A
from idmvton_tpu_torch.weights.from_jax import load_module_params

F32_TOL = 2e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        assert err <= F32_TOL, err
    else:
        assert err <= BF16_TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 64])
@pytest.mark.parametrize("skv", [384, 200])
def test_flash_attention_plain_matches_jax(skv, d, dtype):
    b, sq, h = 2, 300, 2
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np(i, b, s, h, d), dtype)
                                    for i, s in ((0, sq), (1, skv), (2, skv)))
    assert (skv > jpa.XLA_KV_CUTOFF) == (skv > A.XLA_KV_CUTOFF)
    _check(A.flash_attention_torch(tq, tk, tv),
           jpa.flash_attention(jq, jk, jv), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 64])
@pytest.mark.parametrize("m", [150, 90])
def test_flash_attention_concat_kv_plain_matches_jax(m, d, dtype):
    """Own 150 keys + m garment keys: 300 (kernel) or 240 (einsum)."""
    b, n, h = 2, 150, 2
    arrs = [_pair(_np(10 + i, b, s, h, d), dtype)
            for i, s in enumerate((n, n, n, m, m))]
    want = jpa.flash_attention_concat_kv(*(j for j, _ in arrs))
    _check(A.flash_attention_concat_kv_torch(*(t for _, t in arrs)), want,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_flash_attention_fused_qkv_plain_matches_jax(d, dtype):
    jqkv, tqkv = _pair(_np(20, 2, 384, 3, 2, d), dtype)
    want = jpa.flash_attention_fused_qkv(jqkv, 300)
    got = A.flash_attention_fused_qkv_torch(tqkv, 300)
    assert got.shape == (2, 300, 2, d)
    _check(got, want, dtype)


@pytest.mark.parametrize("garment", [False, True])
def test_narrow_head_self_attention_matches_jax_pallas(garment):
    """A head layout flash_attention_gemm does not take (inner 64, 4 heads
    of 16) over > 256 keys: JAX runs _flash_kernel (impl="pallas"); the
    port's module takes sdpa / concat_kv_attention, plain on the CPU. With
    garment KV the uncond half sees zero garment keys."""
    dim, heads, hd, n = 32, 4, 16, 272
    jp = jatt.init_attention(jax.random.PRNGKey(3), dim, heads=heads,
                             head_dim=hd, dtype=jnp.float32)
    x = _np(30, 4, n, dim)
    feat = _np(31, 2, n, dim) if garment else None
    want = jatt.self_attention(
        jp, jnp.asarray(x), heads=heads,
        garment_feat=None if feat is None else jnp.asarray(feat),
        garment_uncond_zero=garment, impl="pallas")
    mod = load_module_params(
        SelfAttention(dim, heads=heads, head_dim=hd, dtype=torch.float32,
                      device="cpu"), jax.tree.map(np.asarray, jp))
    assert not A.flash_attention_gemm_supported(
        torch.zeros(1, 1, 3 * heads * hd), heads)
    got = mod(torch.from_numpy(x),
              garment_feat=None if feat is None else torch.from_numpy(feat),
              garment_uncond_zero=garment)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("op", ["sdpa", "concat_kv_attention"])
def test_cuda_impl_on_a_cpu_tensor(op):
    """impl="cuda" reaches flash_attention: up to 256 keys that computes
    the plain formula (JAX's own routing by shape), above it the kernel,
    which refuses a CPU tensor before anything is built."""
    fn = getattr(tattn, op)

    def call(skv, impl):
        q = torch.from_numpy(_np(40, 1, 20, 2, 16))
        k, v = (torch.from_numpy(_np(41 + i, 1, skv, 2, 16)) for i in (0, 1))
        if op == "sdpa":
            return fn(q, k, v, impl=impl)
        return fn(q, k, v, k[:, :skv // 2], v[:, :skv // 2], impl=impl)

    before = A.flash_attention.launches
    torch.testing.assert_close(call(160, "cuda"), call(160, "torch"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        call(300, "cuda")
    assert A.flash_attention.launches == before


def test_kernel_wrappers_check_layouts():
    """The wrappers raise on what the kernel does not take (head dim, a
    mismatched KV, a strided head axis) before anything is built."""
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 300, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q[..., :12], kv[..., :12], kv[..., :12])
    with pytest.raises(ValueError, match="do not match"):
        A.flash_attention(q, kv, kv[:, :299])
    with pytest.raises(ValueError, match="strides"):
        A.flash_attention(q, kv.transpose(1, 2).contiguous().transpose(1, 2),
                          kv)
    with pytest.raises(ValueError, match="s_own"):
        A.flash_attention_fused_qkv(torch.zeros(1, 8, 3, 2, 16), 9)
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention_fused_qkv(
            torch.zeros(1, 300, 3, 2, 16, dtype=torch.bfloat16), 100)


# ---------------------------------------------------------------------------
# the fixed-shift switch (JAX pallas_attention._fixed_shift and its
# calibration)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,forced,want", [
    (None, False, True), ("1", False, True), ("0", False, False),
    ("1", True, False)])
def test_self_attention_site_reads_the_fixed_shift_switch(
        monkeypatch, env, forced, want):
    """The SelfAttention site passes the switch as it stands at the call
    (IDMVTON_FLASH_FIXED_SHIFT, then the calibration's force-off) to
    flash_attention_gemm, as the JAX function reads ``_fixed_shift()`` at
    every dispatch; recorded through a stand-in for the kernel."""
    from idmvton_tpu_torch.models import attention as tmod
    if env is None:
        monkeypatch.delenv("IDMVTON_FLASH_FIXED_SHIFT", raising=False)
    else:
        monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", env)
    monkeypatch.setattr(A, "_FIXED_SHIFT_FORCED_OFF", forced)
    seen = []

    def fake(qkv, kv, *, heads, uncond_rows, fixed_shift):
        seen.append(fixed_shift)
        return A.flash_attention_gemm_torch(qkv, kv, heads=heads,
                                            uncond_rows=uncond_rows,
                                            fixed_shift=fixed_shift)

    monkeypatch.setattr(tmod, "flash_attention_gemm", fake)
    mod = SelfAttention(128, heads=2, head_dim=64, dtype=torch.float32,
                        device="cpu")
    for p in mod.parameters():
        p.data.copy_(torch.from_numpy(_np(50, *p.shape)) * 0.05)
    x = torch.from_numpy(_np(51, 2, 20, 128))
    out = mod(x, garment_feat=torch.from_numpy(_np(52, 1, 20, 128)),
              garment_uncond_zero=True, impl="cuda")
    assert seen == [want] and out.shape == (2, 20, 128)
    assert A.fixed_shift_enabled() is want


def _hot_qkv(n=128, d=128):
    """Logits far above the clamp with distinct magnitudes (the JAX test's
    input): the fixed shift equalizes them, the online max keeps their
    order."""
    rows = (1.0 + np.arange(n, dtype=np.float32) / n)[None, :, None]
    base = 4.0 * np.ones((1, n, d), np.float32)
    return np.concatenate([base, base * rows, _np(53, 1, n, d)], -1)


@pytest.mark.parametrize("hot", [False, True])
def test_fixed_shift_max_error_matches_jax(hot):
    if hot:
        qkv, kv, heads = _hot_qkv(), None, 1
    else:
        qkv, kv, heads = _np(54, 2, 192, 384), _np(55, 1, 192, 256), 2
    want = jpa.fixed_shift_max_error(
        jnp.asarray(qkv), None if kv is None else jnp.asarray(kv),
        heads=heads, uncond_rows=0 if kv is None else 1)
    got = A.fixed_shift_max_error(
        torch.from_numpy(qkv), None if kv is None else torch.from_numpy(kv),
        heads=heads, uncond_rows=0 if kv is None else 1)
    if hot:
        assert want > 5e-3
        np.testing.assert_allclose(got, want, rtol=1e-3)
    else:
        assert got < 1e-3 and want < 1e-3


def test_calibrate_fixed_shift_forces_and_clears_the_online_softmax(
        monkeypatch):
    """As JAX's: hot logits force the online-max softmax process-wide (the
    site then passes fixed_shift=False), a clean calibration clears it, and
    the environment is left as it was."""
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1")
    monkeypatch.setattr(A, "_FIXED_SHIFT_FORCED_OFF", False)
    hot = _hot_qkv()
    jrep = jpa.calibrate_fixed_shift(jnp.asarray(hot), heads=1)
    try:
        rep = A.calibrate_fixed_shift(torch.from_numpy(hot), heads=1)
        assert not rep["fixed_shift"] and not jrep["fixed_shift"]
        assert not A.fixed_shift_enabled()
        np.testing.assert_allclose(rep["max_error"], jrep["max_error"],
                                   rtol=1e-3)
        clean = torch.from_numpy(_np(56, 1, 128, 384))
        rep = A.calibrate_fixed_shift(clean, heads=2)
        assert rep["fixed_shift"] and rep["max_error"] < 5e-3
        assert A.fixed_shift_enabled()
        assert A.os.environ["IDMVTON_FLASH_FIXED_SHIFT"] == "1"
    finally:
        jpa.calibrate_fixed_shift(jnp.asarray(_np(56, 1, 128, 384)), heads=2)
