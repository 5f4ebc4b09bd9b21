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
