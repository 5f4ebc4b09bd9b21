"""Plain fp32 reference of the SDXL try-on stack (IDM-VTON), in PyTorch.

Written from the published architecture (diffusers' UNet2DConditionModel,
AutoencoderKL, CLIPTextModel / CLIPVisionModel, IP-Adapter-plus's
Resampler, IDM-VTON's TryonNet / GarmentNet wiring) and frozen here as the
benchmark's yardstick: it imports nothing of the program under test and no
kernel, and computes in float32 with TF32 off (``fp32_mode``).

Weights are a flat dict ``{"<component>.<name>": tensor}`` (any dtype; each
use upcasts to fp32). The names and layouts are the ones the program's
modules carry: feature maps NHWC, conv kernels HWIO ``(kh, kw, in, out)``,
linear kernels ``(in, out)``, fused projections ``to_qkv`` ([q | k | v]
columns), ``to_kv`` ([k | v]) and GEGLU's ``proj_in`` ([value | gate]).
``param_specs`` lists them from a configuration alone, so the benchmark can
make the weights from a seed before anything of the program exists.

Departures from the published models, all numerically negligible next to
bf16 rounding: none in the arithmetic; the uncond half of TryonNet's CFG
batch attends to all-zero garment keys and values, as IDM-VTON's pipeline
feeds zero garment features to its uncond rows.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


@contextmanager
def fp32_mode():
    """Float32 matmuls and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _exact(t):
    return t


def _e4m3_values(t):
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _StraightThrough(torch.autograd.Function):
    """The rounding in the forward, the gradient passed through as it is."""

    @staticmethod
    def forward(ctx, t):
        return _e4m3_values(t)

    @staticmethod
    def backward(ctx, g):
        return g


def _e4m3(t):
    """``t`` rounded through float8 e4m3 with one scale for the tensor (its
    absmax at the format's largest value, 448), back in fp32; under
    autograd the gradient passes the rounding unchanged."""
    if t.requires_grad:
        return _StraightThrough.apply(t)
    return _e4m3_values(t.detach())


def _bf16(t):
    return t.bfloat16().float()


# how every product's operands are rounded: exactly (the reference), or
# through a lower precision
_operand = _exact
ROUNDINGS = {"e4m3": _e4m3, "bf16": _bf16}


@contextmanager
def operands(rounding: str):
    """Every matrix product's, convolution's and attention product's
    operands rounded through ``rounding``: "e4m3" (float8, one scale a
    tensor; the precision below bf16, the controls) or "bf16" (the serving
    configuration's precision, the unit of the serving check's step)."""
    global _operand
    saved, _operand = _operand, ROUNDINGS[rounding]
    try:
        yield
    finally:
        _operand = saved


def mm(a, b):
    return _operand(a) @ _operand(b)


class Weights:
    """A view of the flat weight dict under one component prefix; ``w(n)``
    is the fp32 value of ``<prefix>.<n>``, ``has(n)`` whether it exists."""

    def __init__(self, flat: dict, prefix: str, cast=None):
        self.flat, self.prefix = flat, prefix
        self.cast = cast or (lambda t: t.float())

    def sub(self, name: str) -> "Weights":
        return Weights(self.flat, f"{self.prefix}.{name}", self.cast)

    def has(self, name: str) -> bool:
        return f"{self.prefix}.{name}" in self.flat

    def __call__(self, name: str) -> torch.Tensor:
        return self.cast(self.flat[f"{self.prefix}.{name}"])


class Root(Weights):
    """The whole flat dict: ``sub(c)`` is component ``c``."""

    def __init__(self, flat: dict):
        super().__init__(flat, "")

    def sub(self, name: str) -> Weights:
        return Weights(self.flat, name, self.cast)


# ---------------------------------------------------------------------------
# primitives (NHWC, fp32)
# ---------------------------------------------------------------------------


def linear(p: Weights, x, bias=True):
    y = mm(x, p("kernel"))
    if bias and p.has("bias"):
        y = y + p("bias")
    return y


def conv(p: Weights, x, *, stride=1, pad=None):
    """NHWC conv with an HWIO kernel; ``pad`` (top, bottom, left, right),
    by default k // 2 on every side."""
    k = p("kernel")
    r = k.shape[0] // 2
    pt, pb, pl, pr = pad if pad is not None else (r, r, r, r)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(_operand(xc), _operand(k.permute(3, 2, 0, 1)),
                 stride=stride)
    y = y.permute(0, 2, 3, 1)
    if p.has("bias"):
        y = y + p("bias")
    return y


def group_norm(p: Weights, x, groups, eps, silu=False):
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    y = y * p("scale") + p("bias")
    return F.silu(y) if silu else y


def layer_norm(p: Weights, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p("scale"), p("bias"), eps)


def attention(q, k, v, mask=None):
    """q (B, Sq, H, D), k / v (B, Sk, H, D); softmax(q k^T / sqrt(D)) v."""
    s = torch.einsum("bqhd,bkhd->bhqk", _operand(q), _operand(k))
    s = s * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", _operand(s.softmax(-1)),
                        _operand(v))


def heads(x, n):
    return x.reshape(x.shape[0], x.shape[1], n, -1)


def timestep_embedding(t, dim, max_period=10000.0):
    """diffusers Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[..., None] * freqs
    return torch.cat([torch.cos(a), torch.sin(a)], -1)


def resize_nearest(x, hw):
    """Nearest resize with half-pixel centres (diffusers / PIL 'nearest'
    on exact multiples): source index floor((i + 0.5) * in / out)."""
    def idx(n_in, n_out):
        i = torch.arange(n_out, device=x.device, dtype=torch.float64)
        return ((i + 0.5) * (n_in / n_out)).floor().long().clamp_(
            max=n_in - 1)
    return x.index_select(1, idx(x.shape[1], hw[0])).index_select(
        2, idx(x.shape[2], hw[1]))


# ---------------------------------------------------------------------------
# the SDXL UNet (TryonNet: consume; GarmentNet: emit)
# ---------------------------------------------------------------------------


def resnet(p: Weights, x, temb, groups, eps):
    h = conv(p.sub("conv1"), group_norm(p.sub("norm1"), x, groups, eps, True))
    if temb is not None and p.has("time_emb_proj.kernel"):
        h = h + linear(p.sub("time_emb_proj"), F.silu(temb))[:, None, None]
    h = conv(p.sub("conv2"), group_norm(p.sub("norm2"), h, groups, eps, True))
    if p.has("conv_shortcut.kernel"):
        x = conv(p.sub("conv_shortcut"), x)
    return x + h


def transformer_block(p: Weights, x, context, *, n_heads, mode, feat,
                      uncond_zero, ip_tokens, ip_scale):
    """Returns (x, emitted feature or None)."""
    inner = p("attn1.to_out.kernel").shape[0]
    h = layer_norm(p.sub("norm1"), x)
    emitted = h if mode == "emit" else None
    qkv = mm(h, p("attn1.to_qkv.kernel"))
    q, k, v = (heads(t, n_heads) for t in qkv.split(inner, -1))
    if mode == "consume":
        kv = mm(feat, p("attn1.to_qkv.kernel")[:, inner:])
        if uncond_zero:
            kv = torch.cat([torch.zeros_like(kv), kv], 0)
        kg, vg = (heads(t, n_heads) for t in kv.split(inner, -1))
        k, v = torch.cat([k, kg], 1), torch.cat([v, vg], 1)
    a = attention(q, k, v)
    x = x + linear(p.sub("attn1.to_out"), a.flatten(2))

    h = layer_norm(p.sub("norm2"), x)
    q = heads(mm(h, p("attn2.to_q.kernel")), n_heads)

    def kv_of(name, ctx):
        t = mm(ctx, p(f"attn2.{name}.kernel")).reshape(
            ctx.shape[0], ctx.shape[1], 2, n_heads, -1)
        return t[:, :, 0], t[:, :, 1]

    if ip_tokens and p.has("attn2.to_kv_ip.kernel"):
        a = attention(q, *kv_of("to_kv", context[:, :-ip_tokens]))
        a = a + ip_scale * attention(q, *kv_of("to_kv_ip",
                                               context[:, -ip_tokens:]))
    else:
        a = attention(q, *kv_of("to_kv", context))
    x = x + linear(p.sub("attn2.to_out"), a.flatten(2))

    h = linear(p.sub("ff.proj_in"), layer_norm(p.sub("norm3"), x))
    value, gate = h.chunk(2, -1)
    x = x + linear(p.sub("ff.proj_out"), value * F.gelu(gate))
    return x, emitted


def transformer2d(p: Weights, x, context, cfg, *, mode, feats, uncond_zero,
                  ip_tokens):
    """Returns (x, the emitted features of its blocks)."""
    b, hh, ww, c = x.shape
    h = group_norm(p.sub("norm"), x, cfg["norm_num_groups"], 1e-6)
    h = linear(p.sub("proj_in"), h.reshape(b, hh * ww, c))
    n_heads = p("proj_in.kernel").shape[1] // cfg["attention_head_dim"]
    emitted = []
    for i in range(t2d_depth(p)):
        h, em = transformer_block(
            p.sub(f"blocks.{i}"), h, context, n_heads=n_heads, mode=mode,
            feat=feats[i] if mode == "consume" else None,
            uncond_zero=uncond_zero, ip_tokens=ip_tokens,
            ip_scale=cfg["ip_scale"])
        if em is not None:
            emitted.append(em)
    return (linear(p.sub("proj_out"), h).reshape(b, hh, ww, c) + x,
            emitted)


def t2d_depth(p: Weights) -> int:
    i = 0
    while p.has(f"blocks.{i}.norm1.scale"):
        i += 1
    return i


def unet(p: Weights, cfg: dict, sample, t, context, *, added_cond=None,
         garment_features=None, uncond_zero=False, remat=False):
    """SDXL UNet2DCondition. Returns the noise prediction, or for a
    GarmentNet (``garment_mode`` "emit") the tuple of the pre-attention
    hidden states of every transformer block in execution order.
    ``remat``: each resnet block and Transformer2D under
    ``torch.utils.checkpoint`` (memory only; the arithmetic is the same)."""
    mode = cfg["garment_mode"]
    ng = cfg["norm_num_groups"]
    chans = cfg["block_out_channels"]
    n_lv = len(chans)
    t = torch.as_tensor(t, device=sample.device).float()
    if t.dim() == 0:
        t = t.expand(sample.shape[0])

    def call(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def mlp(q, x):
        return linear(q.sub("linear_2"), F.silu(linear(q.sub("linear_1"),
                                                       x)))

    temb = mlp(p.sub("time_embedding"), timestep_embedding(t, chans[0]))
    if cfg["addition_embed"] and added_cond is not None:
        pooled, time_ids = added_cond
        tid = timestep_embedding(time_ids.reshape(-1).float(),
                                 cfg["addition_time_embed_dim"])
        temb = temb + mlp(p.sub("add_embedding"), torch.cat(
            [pooled, tid.reshape(time_ids.shape[0], -1)], -1))
    ip_tokens = cfg["ip_num_tokens"] if cfg["ip_adapter"] else 0
    feats = list(garment_features or ())
    emitted = []
    used = 0

    def t2d(q, h):
        nonlocal used
        depth = t2d_depth(q)
        mine = tuple(feats[used:used + depth]) if mode == "consume" else ()
        used += depth
        h, em = call(lambda h_, *f: transformer2d(
            q, h_, context, cfg, mode=mode, feats=f,
            uncond_zero=uncond_zero, ip_tokens=ip_tokens), h, *mine)
        emitted.extend(em)
        return h

    def res(q, h):
        return call(lambda h_: resnet(q, h_, temb, ng, 1e-5), h)

    h = conv(p.sub("conv_in"), sample)
    skips = [h]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        q = p.sub(f"down_blocks.{lvl}")
        for i in range(cfg["layers_per_block"]):
            h = res(q.sub(f"resnets.{i}"), h)
            if kind == "attn":
                h = t2d(q.sub(f"attentions.{i}"), h)
            skips.append(h)
        if lvl < n_lv - 1:
            h = conv(q.sub("downsample.conv"), h, stride=2, pad=(0, 1, 0, 1))
            skips.append(h)
    q = p.sub("mid_block")
    h = res(q.sub("resnets.0"), h)
    h = t2d(q.sub("attentions.0"), h)
    h = res(q.sub("resnets.1"), h)
    for i, kind in enumerate(cfg["up_block_types"]):
        if mode == "emit" and kind == "plain":
            break
        q = p.sub(f"up_blocks.{i}")
        for j in range(cfg["layers_per_block"] + 1):
            h = torch.cat([h, skips.pop()], -1)
            h = res(q.sub(f"resnets.{j}"), h)
            if kind == "attn":
                h = t2d(q.sub(f"attentions.{j}"), h)
        if i < n_lv - 1 and not (mode == "emit" and
                                 cfg["up_block_types"][i + 1] == "plain"):
            h = conv(q.sub("upsample.conv"),
                     resize_nearest(h, skips[-1].shape[1:3]))
    if mode == "emit":
        return tuple(emitted)
    h = group_norm(p.sub("conv_norm_out"), h, ng, 1e-5, silu=True)
    return conv(p.sub("conv_out"), h)


# ---------------------------------------------------------------------------
# the SDXL VAE
# ---------------------------------------------------------------------------


def _vae_attn(p: Weights, x, groups):
    b, hh, ww, c = x.shape
    h = group_norm(p.sub("norm"), x, groups, 1e-6).reshape(b, hh * ww, c)
    q, k, v = (linear(p.sub(n), h)[:, :, None] for n in ("to_q", "to_k",
                                                         "to_v"))
    a = attention(q, k, v)[:, :, 0]
    return x + linear(p.sub("to_out"), a).reshape(x.shape)


def _vae_mid(p: Weights, h, groups):
    h = resnet(p.sub("resnets.0"), h, None, groups, 1e-6)
    h = _vae_attn(p.sub("attn"), h, groups)
    return resnet(p.sub("resnets.1"), h, None, groups, 1e-6)


def vae_encode_moments(p: Weights, cfg: dict, x):
    ng = cfg["norm_num_groups"]
    e = p.sub("encoder")
    h = conv(e.sub("conv_in"), x)
    n_lv = len(cfg["channel_mults"])
    for lvl in range(n_lv):
        for i in range(cfg["layers_per_block"]):
            h = resnet(e.sub(f"down_blocks.{lvl}.resnets.{i}"), h, None, ng,
                       1e-6)
        if lvl < n_lv - 1:
            h = conv(e.sub(f"down_blocks.{lvl}.downsample.conv"), h,
                     stride=2, pad=(0, 1, 0, 1))
    h = _vae_mid(e.sub("mid"), h, ng)
    h = group_norm(e.sub("norm_out"), h, ng, 1e-6, silu=True)
    h = conv(p.sub("quant_conv"), conv(e.sub("conv_out"), h))
    mean, logvar = h.chunk(2, -1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_encode(p: Weights, cfg: dict, x, noise):
    """Scaled latents of x (B, H, W, 3) in [-1, 1], the posterior sampled
    with the standard normal ``noise`` (or its mean for None)."""
    mean, logvar = vae_encode_moments(p, cfg, x)
    z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise
    return z * cfg["scaling_factor"]


def vae_decode(p: Weights, cfg: dict, z):
    ng = cfg["norm_num_groups"]
    d = p.sub("decoder")
    h = conv(p.sub("post_quant_conv"), z / cfg["scaling_factor"])
    h = _vae_mid(d.sub("mid"), conv(d.sub("conv_in"), h), ng)
    n_lv = len(cfg["channel_mults"])
    for lvl in range(n_lv):
        for i in range(cfg["layers_per_block"] + 1):
            h = resnet(d.sub(f"up_blocks.{lvl}.resnets.{i}"), h, None, ng,
                       1e-6)
        if lvl < n_lv - 1:
            h = conv(d.sub(f"up_blocks.{lvl}.upsample.conv"),
                     resize_nearest(h, (2 * h.shape[1], 2 * h.shape[2])))
    h = group_norm(d.sub("norm_out"), h, ng, 1e-6, silu=True)
    return conv(d.sub("conv_out"), h)


# ---------------------------------------------------------------------------
# CLIP text towers, the ViT-H vision tower, the Resampler
# ---------------------------------------------------------------------------

ACT = {"gelu": F.gelu, "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}


def _encoder_layer(p: Weights, x, n_heads, act, causal):
    h = layer_norm(p.sub("ln1"), x)
    q, k, v = (heads(linear(p.sub(f"attn.{n}"), h), n_heads)
               for n in ("q", "k", "v"))
    s = x.shape[1]
    mask = (torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            if causal else None)
    x = x + linear(p.sub("attn.out"), attention(q, k, v, mask).flatten(2))
    h = ACT[act](linear(p.sub("mlp.fc1"), layer_norm(p.sub("ln2"), x)))
    return x + linear(p.sub("mlp.fc2"), h)


def clip_text(p: Weights, cfg: dict, ids):
    """(hidden_states[-2], pooled projection or None) of a CLIP text tower."""
    x = p("token_embedding.embedding")[ids.clamp(0, cfg["vocab_size"] - 1)]
    x = x + p("position_embedding.embedding")[:ids.shape[1]][None]
    pen = None
    for i in range(cfg["num_layers"]):
        if i == cfg["num_layers"] - 1:
            pen = x
        x = _encoder_layer(p.sub(f"layers.{i}"), x, cfg["num_heads"],
                           cfg["hidden_act"], True)
    pooled = None
    if cfg["use_final_projection"]:
        last = layer_norm(p.sub("final_ln"), x)
        eos = last[torch.arange(ids.shape[0], device=ids.device),
                   ids.argmax(-1)]
        pooled = mm(eos, p("text_projection.kernel"))
    return pen, pooled


def clip_vision_penultimate(p: Weights, cfg: dict, pixels):
    ps = cfg["patch_size"]
    h = F.conv2d(_operand(pixels.permute(0, 3, 1, 2)),
                 _operand(p("patch_embedding.kernel").permute(3, 2, 0, 1)),
                 stride=ps)
    h = h.permute(0, 2, 3, 1).flatten(1, 2)
    cls = p("class_embedding").expand(h.shape[0], 1, -1)
    h = torch.cat([cls, h], 1) + p("position_embedding.embedding")[None]
    h = layer_norm(p.sub("pre_ln"), h)
    for i in range(cfg["num_layers"] - 1):
        h = _encoder_layer(p.sub(f"layers.{i}"), h, cfg["num_heads"],
                           cfg["hidden_act"], False)
    return h


def resampler(p: Weights, cfg: dict, x):
    b = x.shape[0]
    lat = p("latents")[None].expand(b, -1, -1)
    x = linear(p.sub("proj_in"), x)
    for i in range(cfg["depth"]):
        q_ = p.sub(f"layers.{i}")
        xn = layer_norm(q_.sub("ln_x"), x)
        ln = layer_norm(q_.sub("ln_latents"), lat)
        q = heads(mm(ln, q_("to_q.kernel")), cfg["heads"])
        kv = mm(torch.cat([xn, ln], 1), q_("to_kv.kernel")).reshape(
            b, -1, 2, cfg["heads"], cfg["dim_head"])
        a = attention(q, kv[:, :, 0], kv[:, :, 1])
        lat = lat + mm(a.flatten(2), q_("to_out.kernel"))
        h = F.gelu(mm(layer_norm(q_.sub("ff_ln"), lat), q_("ff_in.kernel")))
        lat = lat + mm(h, q_("ff_out.kernel"))
    return layer_norm(p.sub("norm_out"), linear(p.sub("proj_out"), lat))


# ---------------------------------------------------------------------------
# parameter specs: (name, shape, kind) from a configuration
# ---------------------------------------------------------------------------
# kind: "kernel" (fan-in normal), "bias", "scale" (1 + noise), "shift"
# (a norm's bias), "embedding" (std 0.02), "latents" (std dim ** -0.5),
# "zero"

def _lin(out, name, i, o, bias=True):
    out.append((f"{name}.kernel", (i, o), "kernel"))
    if bias:
        out.append((f"{name}.bias", (o,), "bias"))


def _conv(out, name, i, o, k=3, bias=True):
    out.append((f"{name}.kernel", (k, k, i, o), "kernel"))
    if bias:
        out.append((f"{name}.bias", (o,), "bias"))


def _norm(out, name, c):
    out.append((f"{name}.scale", (c,), "scale"))
    out.append((f"{name}.bias", (c,), "shift"))


def _resnet_spec(out, n, i, o, temb):
    _norm(out, f"{n}.norm1", i)
    _conv(out, f"{n}.conv1", i, o)
    _norm(out, f"{n}.norm2", o)
    _conv(out, f"{n}.conv2", o, o)
    if temb:
        _lin(out, f"{n}.time_emb_proj", temb, o)
    if i != o:
        _conv(out, f"{n}.conv_shortcut", i, o, k=1)


def _t2d_spec(out, n, ch, depth, cfg):
    hd = cfg["attention_head_dim"]
    inner = (ch // hd) * hd
    ctx = cfg["cross_attention_dim"]
    _norm(out, f"{n}.norm", ch)
    _lin(out, f"{n}.proj_in", ch, inner)
    for b in range(depth):
        q = f"{n}.blocks.{b}"
        _norm(out, f"{q}.norm1", inner)
        _lin(out, f"{q}.attn1.to_qkv", inner, 3 * inner, bias=False)
        _lin(out, f"{q}.attn1.to_out", inner, inner)
        _norm(out, f"{q}.norm2", inner)
        _lin(out, f"{q}.attn2.to_q", inner, inner, bias=False)
        _lin(out, f"{q}.attn2.to_kv", ctx, 2 * inner, bias=False)
        _lin(out, f"{q}.attn2.to_out", inner, inner)
        if cfg["ip_adapter"]:
            _lin(out, f"{q}.attn2.to_kv_ip", ctx, 2 * inner, bias=False)
        _norm(out, f"{q}.norm3", inner)
        _lin(out, f"{q}.ff.proj_in", inner, 8 * inner)
        _lin(out, f"{q}.ff.proj_out", 4 * inner, inner)
    _lin(out, f"{n}.proj_out", inner, ch)


def unet_spec(cfg: dict):
    out = []
    chans = cfg["block_out_channels"]
    n_lv = len(chans)
    temb = chans[0] * cfg["time_embed_dim_mult"]
    _conv(out, "conv_in", cfg["in_channels"], chans[0])
    _lin(out, "time_embedding.linear_1", chans[0], temb)
    _lin(out, "time_embedding.linear_2", temb, temb)
    if cfg["addition_embed"]:
        _lin(out, "add_embedding.linear_1",
             cfg["projection_class_embeddings_input_dim"], temb)
        _lin(out, "add_embedding.linear_2", temb, temb)
    in_ch = chans[0]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        o = chans[lvl]
        for i in range(cfg["layers_per_block"]):
            _resnet_spec(out, f"down_blocks.{lvl}.resnets.{i}",
                         in_ch if i == 0 else o, o, temb)
        if kind == "attn":
            for i in range(cfg["layers_per_block"]):
                _t2d_spec(out, f"down_blocks.{lvl}.attentions.{i}", o,
                          cfg["transformer_depth"][lvl], cfg)
        if lvl < n_lv - 1:
            _conv(out, f"down_blocks.{lvl}.downsample.conv", o, o)
        in_ch = o
    m = chans[-1]
    for i in range(2):
        _resnet_spec(out, f"mid_block.resnets.{i}", m, m, temb)
    _t2d_spec(out, "mid_block.attentions.0", m, cfg["transformer_depth"][-1],
              cfg)
    rev = list(reversed(chans))
    for i, kind in enumerate(cfg["up_block_types"]):
        if cfg["skip_final_output"] and kind == "plain":
            break
        lvl = n_lv - 1 - i
        o, prev = rev[i], rev[max(i - 1, 0)]
        skip = rev[min(i + 1, n_lv - 1)]
        for j in range(cfg["layers_per_block"] + 1):
            rs = skip if j == cfg["layers_per_block"] else o
            _resnet_spec(out, f"up_blocks.{i}.resnets.{j}",
                         (prev if j == 0 else o) + rs, o, temb)
        if kind == "attn":
            for j in range(cfg["layers_per_block"] + 1):
                _t2d_spec(out, f"up_blocks.{i}.attentions.{j}", o,
                          cfg["transformer_depth"][lvl], cfg)
        if i < n_lv - 1:
            _conv(out, f"up_blocks.{i}.upsample.conv", o, o)
    if not cfg["skip_final_output"]:
        _norm(out, "conv_norm_out", chans[0])
        _conv(out, "conv_out", chans[0], cfg["out_channels"])
    return out


def vae_spec(cfg: dict):
    out = []
    chans = [cfg["base_channels"] * m for m in cfg["channel_mults"]]
    lat = cfg["latent_channels"]
    n_lv = len(chans)

    def mid(n):
        for i in range(2):
            _resnet_spec(out, f"{n}.resnets.{i}", chans[-1], chans[-1], None)
        _norm(out, f"{n}.attn.norm", chans[-1])
        for q in ("to_q", "to_k", "to_v", "to_out"):
            _lin(out, f"{n}.attn.{q}", chans[-1], chans[-1])

    _conv(out, "encoder.conv_in", cfg["in_channels"], chans[0])
    in_ch = chans[0]
    for lvl, o in enumerate(chans):
        for i in range(cfg["layers_per_block"]):
            _resnet_spec(out, f"encoder.down_blocks.{lvl}.resnets.{i}",
                         in_ch if i == 0 else o, o, None)
        if lvl < n_lv - 1:
            _conv(out, f"encoder.down_blocks.{lvl}.downsample.conv", o, o)
        in_ch = o
    mid("encoder.mid")
    _norm(out, "encoder.norm_out", chans[-1])
    _conv(out, "encoder.conv_out", chans[-1], 2 * lat)
    rev = list(reversed(chans))
    _conv(out, "decoder.conv_in", lat, rev[0])
    mid("decoder.mid")
    in_ch = rev[0]
    for lvl, o in enumerate(rev):
        for i in range(cfg["layers_per_block"] + 1):
            _resnet_spec(out, f"decoder.up_blocks.{lvl}.resnets.{i}",
                         in_ch if i == 0 else o, o, None)
        if lvl < n_lv - 1:
            _conv(out, f"decoder.up_blocks.{lvl}.upsample.conv", o, o)
        in_ch = o
    _norm(out, "decoder.norm_out", chans[0])
    _conv(out, "decoder.conv_out", chans[0], cfg["in_channels"])
    _conv(out, "quant_conv", 2 * lat, 2 * lat, k=1)
    _conv(out, "post_quant_conv", lat, lat, k=1)
    return out


def _layers_spec(out, n, hidden, inter):
    _norm(out, f"{n}.ln1", hidden)
    for q in ("q", "k", "v", "out"):
        _lin(out, f"{n}.attn.{q}", hidden, hidden)
    _norm(out, f"{n}.ln2", hidden)
    _lin(out, f"{n}.mlp.fc1", hidden, inter)
    _lin(out, f"{n}.mlp.fc2", inter, hidden)


def clip_text_spec(cfg: dict):
    out = [("token_embedding.embedding",
            (cfg["vocab_size"], cfg["hidden_size"]), "embedding"),
           ("position_embedding.embedding",
            (cfg["max_position_embeddings"], cfg["hidden_size"]),
            "embedding")]
    for i in range(cfg["num_layers"]):
        _layers_spec(out, f"layers.{i}", cfg["hidden_size"],
                     cfg["intermediate_size"])
    _norm(out, "final_ln", cfg["hidden_size"])
    if cfg["use_final_projection"]:
        _lin(out, "text_projection", cfg["hidden_size"],
             cfg["projection_dim"], bias=False)
    return out


def clip_vision_spec(cfg: dict):
    hs, ps = cfg["hidden_size"], cfg["patch_size"]
    n_pos = (cfg["image_size"] // ps) ** 2 + 1
    out = [("patch_embedding.kernel", (ps, ps, 3, hs), "kernel"),
           ("class_embedding", (hs,), "embedding"),
           ("position_embedding.embedding", (n_pos, hs), "embedding")]
    _norm(out, "pre_ln", hs)
    for i in range(cfg["num_layers"]):
        _layers_spec(out, f"layers.{i}", hs, cfg["intermediate_size"])
    _norm(out, "post_ln", hs)
    _lin(out, "visual_projection", hs, cfg["projection_dim"], bias=False)
    return out


def resampler_spec(cfg: dict):
    d, inner = cfg["dim"], cfg["heads"] * cfg["dim_head"]
    out = [("latents", (cfg["num_queries"], d), "latents")]
    _lin(out, "proj_in", cfg["embedding_dim"], d)
    for i in range(cfg["depth"]):
        n = f"layers.{i}"
        _norm(out, f"{n}.ln_x", d)
        _norm(out, f"{n}.ln_latents", d)
        _lin(out, f"{n}.to_q", d, inner, bias=False)
        _lin(out, f"{n}.to_kv", d, 2 * inner, bias=False)
        _lin(out, f"{n}.to_out", inner, d, bias=False)
        _norm(out, f"{n}.ff_ln", d)
        _lin(out, f"{n}.ff_in", d, d * cfg["ff_mult"], bias=False)
        _lin(out, f"{n}.ff_out", d * cfg["ff_mult"], d, bias=False)
    _lin(out, "proj_out", d, cfg["output_dim"])
    _norm(out, "norm_out", cfg["output_dim"])
    return out


SPECS = {"unet": unet_spec, "garm": unet_spec, "vae": vae_spec,
         "clip_l": clip_text_spec, "clip_g": clip_text_spec,
         "vision": clip_vision_spec, "resampler": resampler_spec}


def param_specs(stack: dict):
    """{component: [(name, shape, kind)]} of the stack described by a
    configuration's ``stack`` section, in a fixed order."""
    return {c: SPECS[c](stack[c]) for c in SPECS if c in stack}
