"""Frozen operation and byte counts of the try-on stack, as functions of a
configuration's widths and the traffic's shapes.

Operations are 2 x multiply-accumulates of the matrix products,
convolutions and attention products the published models need (elementwise
work, norms and softmax are not counted). Bytes are each input read once
and the output written once, in the served types (bf16 activations and
weights, fp32 norm affines). A site is one such product at one place of
the model; ``*_sites`` walk a model in the reference's order.
"""

from __future__ import annotations

BF16 = 2
FP32 = 4


# ---------------------------------------------------------------------------
# single sites
# ---------------------------------------------------------------------------


def linear(m, k, n) -> int:
    return 2 * m * k * n


def ln_linear(m, c, n_w, geglu=False, bias=False):
    """LayerNorm + x @ W (W (c, n_w); GEGLU halves the output): (ops,
    bytes)."""
    n_out = n_w // 2 if geglu else n_w
    ops = 2 * m * c * n_w
    nbytes = (BF16 * (m * c + c * n_w + m * n_out) + FP32 * 2 * c
              + (BF16 * n_w if bias else 0))
    return ops, nbytes


def conv(b, h, w, cin, cout, k=3, stride=1, bias=True):
    """A k x k conv over (b, h, w, cin): SAME-padded at stride 1, padded
    (0, 1) below and right at stride 2 (diffusers' downsample): (ops,
    bytes)."""
    ho, wo = h // stride, w // stride
    ops = 2 * b * ho * wo * k * k * cin * cout
    nbytes = BF16 * (b * h * w * cin + k * k * cin * cout + b * ho * wo * cout
                     + (cout if bias else 0))
    return ops, nbytes


def attention(b, heads, sq, skv, d) -> int:
    """QK^T and PV."""
    return 4 * b * heads * sq * skv * d


# ---------------------------------------------------------------------------
# model walks: lists of sites {"kind", "ops", "bytes", ...}
# ---------------------------------------------------------------------------


def _site(kind, ops, nbytes=0, **kw):
    return dict(kind=kind, ops=ops, bytes=nbytes, **kw)


def _conv_site(out, b, h, w, cin, cout, k=3, stride=1, **kw):
    ops, nb = conv(b, h, w, cin, cout, k, stride)
    out.append(_site("conv", ops, nb, k=k, stride=stride, shape=(b, h, w,
                                                                  cin, cout),
                     **kw))


def _lin_site(out, m, k, n, **kw):
    out.append(_site("linear", linear(m, k, n), BF16 * (m * k + k * n + m * n),
                     **kw))


def _resnet_sites(out, b, h, w, cin, cout, temb):
    _conv_site(out, b, h, w, cin, cout)
    if temb:
        _lin_site(out, b, temb, cout)
    _conv_site(out, b, h, w, cout, cout)
    if cin != cout:
        _conv_site(out, b, h, w, cin, cout, k=1)


def _t2d_sites(out, cfg, b, s, ch, depth, *, mode, ctx_len, garment):
    """A Transformer2D over b rows of s tokens. ``garment``: the rows whose
    garment features are projected (consume)."""
    hd = cfg["attention_head_dim"]
    nh = ch // hd
    inner = nh * hd
    ctx = cfg["cross_attention_dim"]
    m = b * s
    ip = cfg["ip_num_tokens"] if cfg["ip_adapter"] else 0
    _lin_site(out, m, ch, inner)
    for _ in range(depth):
        if mode == "emit":
            _lin_site(out, m, inner, 3 * inner, name="to_qkv")
            out.append(_site("attn", attention(b, nh, s, s, hd)))
        else:
            ops, nb = ln_linear(m, inner, 3 * inner)
            out.append(_site("ln_linear", ops, nb, shape=(m, inner,
                                                          3 * inner, False)))
            skv = s
            if mode == "consume":
                _lin_site(out, garment * s, inner, 2 * inner, name="kv_g")
                skv = 2 * s
            out.append(_site("attn", attention(b, nh, s, skv, hd)))
        _lin_site(out, m, inner, inner)
        ops, nb = ln_linear(m, inner, inner)
        out.append(_site("ln_linear", ops, nb, shape=(m, inner, inner,
                                                      False)))
        _lin_site(out, b * (ctx_len - ip), ctx, 2 * inner)
        out.append(_site("attn", attention(b, nh, s, ctx_len - ip, hd)))
        if ip:
            _lin_site(out, b * ip, ctx, 2 * inner)
            out.append(_site("attn", attention(b, nh, s, ip, hd)))
        _lin_site(out, m, inner, inner)
        ops, nb = ln_linear(m, inner, 8 * inner, geglu=True, bias=True)
        out.append(_site("ln_linear", ops, nb, shape=(m, inner, 8 * inner,
                                                      True)))
        _lin_site(out, m, 4 * inner, inner)
    _lin_site(out, m, inner, ch)


def unet_sites(cfg, b, h, w, *, ctx_len, garment=0):
    """The sites of one UNet call over b rows of an (h, w) latent with a
    ctx_len-token context; ``garment``: rows whose garment features a
    consuming UNet projects. A GarmentNet's trailing upsample conv, which
    the program runs and whose output nothing reads, is marked unused."""
    out = []
    mode = cfg["garment_mode"]
    chans = cfg["block_out_channels"]
    n_lv = len(chans)
    temb = chans[0] * cfg["time_embed_dim_mult"]
    _lin_site(out, b, chans[0], temb)
    _lin_site(out, b, temb, temb)
    if cfg["addition_embed"]:
        _lin_site(out, b, cfg["projection_class_embeddings_input_dim"], temb)
        _lin_site(out, b, temb, temb)
    _conv_site(out, b, h, w, cfg["in_channels"], chans[0])
    sizes, skips = [(h, w)], [chans[0]]
    hh, ww, in_ch = h, w, chans[0]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        o = chans[lvl]
        for i in range(cfg["layers_per_block"]):
            _resnet_sites(out, b, hh, ww, in_ch if i == 0 else o, o, temb)
            if kind == "attn":
                _t2d_sites(out, cfg, b, hh * ww, o,
                           cfg["transformer_depth"][lvl], mode=mode,
                           ctx_len=ctx_len, garment=garment)
            skips.append(o)
            sizes.append((hh, ww))
        if lvl < n_lv - 1:
            _conv_site(out, b, hh, ww, o, o, stride=2)
            hh, ww = hh // 2, ww // 2
            skips.append(o)
            sizes.append((hh, ww))
        in_ch = o
    m = chans[-1]
    _resnet_sites(out, b, hh, ww, m, m, temb)
    _t2d_sites(out, cfg, b, hh * ww, m, cfg["transformer_depth"][-1],
               mode=mode, ctx_len=ctx_len, garment=garment)
    _resnet_sites(out, b, hh, ww, m, m, temb)
    ch = m
    for i, kind in enumerate(cfg["up_block_types"]):
        if mode == "emit" and kind == "plain":
            break
        lvl = n_lv - 1 - i
        o = list(reversed(chans))[i]
        for j in range(cfg["layers_per_block"] + 1):
            _resnet_sites(out, b, hh, ww, ch + skips.pop(), o, temb)
            sizes.pop()
            ch = o
            if kind == "attn":
                _t2d_sites(out, cfg, b, hh * ww, o,
                           cfg["transformer_depth"][lvl], mode=mode,
                           ctx_len=ctx_len, garment=garment)
        if i < n_lv - 1:
            hh, ww = sizes[-1]
            unused = (mode == "emit"
                      and cfg["up_block_types"][i + 1] == "plain")
            _conv_site(out, b, hh, ww, o, o, unused=unused)
    if mode != "emit":
        _conv_site(out, b, hh, ww, chans[0], cfg["out_channels"])
    return out


def vae_sites(cfg, b, h, w, *, encode: bool):
    """The VAE encoder over b images of (h, w), or the decoder over b
    latents of (h, w)."""
    out = []
    chans = [cfg["base_channels"] * m for m in cfg["channel_mults"]]
    n_lv = len(chans)
    lat = cfg["latent_channels"]

    def mid(hh, ww):
        c = chans[-1]
        _resnet_sites(out, b, hh, ww, c, c, None)
        for _ in range(4):
            _lin_site(out, b * hh * ww, c, c)
        out.append(_site("attn", attention(b, 1, hh * ww, hh * ww, c)))
        _resnet_sites(out, b, hh, ww, c, c, None)

    if encode:
        hh, ww = h, w
        _conv_site(out, b, hh, ww, cfg["in_channels"], chans[0])
        in_ch = chans[0]
        for lvl, o in enumerate(chans):
            for i in range(cfg["layers_per_block"]):
                _resnet_sites(out, b, hh, ww, in_ch if i == 0 else o, o, None)
            if lvl < n_lv - 1:
                _conv_site(out, b, hh, ww, o, o, stride=2)
                hh, ww = hh // 2, ww // 2
            in_ch = o
        mid(hh, ww)
        _conv_site(out, b, hh, ww, chans[-1], 2 * lat)
        _conv_site(out, b, hh, ww, 2 * lat, 2 * lat, k=1)
        return out
    hh, ww = h, w
    _conv_site(out, b, hh, ww, lat, lat, k=1)
    rev = list(reversed(chans))
    _conv_site(out, b, hh, ww, lat, rev[0])
    mid(hh, ww)
    in_ch = rev[0]
    for lvl, o in enumerate(rev):
        for i in range(cfg["layers_per_block"] + 1):
            _resnet_sites(out, b, hh, ww, in_ch if i == 0 else o, o, None)
        if lvl < n_lv - 1:
            hh, ww = 2 * hh, 2 * ww
            _conv_site(out, b, hh, ww, o, o)
        in_ch = o
    _conv_site(out, b, hh, ww, chans[0], cfg["in_channels"])
    return out


def _encoder_sites(out, b, s, hidden, inter, heads, layers):
    for _ in range(layers):
        for _ in range(4):
            _lin_site(out, b * s, hidden, hidden)
        out.append(_site("attn", attention(b, heads, s, s, hidden // heads)))
        _lin_site(out, b * s, hidden, inter)
        _lin_site(out, b * s, inter, hidden)


def clip_text_sites(cfg, b, s=77):
    out = []
    _encoder_sites(out, b, s, cfg["hidden_size"], cfg["intermediate_size"],
                   cfg["num_heads"], cfg["num_layers"])
    if cfg["use_final_projection"]:
        _lin_site(out, b, cfg["hidden_size"], cfg["projection_dim"])
    return out


def clip_vision_sites(cfg, b):
    """The tower up to its penultimate state, which the pipeline reads (the
    program also runs the last layer and the projection, whose outputs
    nothing reads: they are not counted)."""
    out = []
    ps, hs = cfg["patch_size"], cfg["hidden_size"]
    n = cfg["image_size"] // ps
    ops, nb = conv(b, n, n, 3 * ps * ps, hs, k=1, bias=False)
    out.append(_site("conv", ops, nb, k=ps, stride=ps))
    _encoder_sites(out, b, n * n + 1, hs, cfg["intermediate_size"],
                   cfg["num_heads"], cfg["num_layers"] - 1)
    return out


def resampler_sites(cfg, b, s):
    out = []
    d, inner, q = cfg["dim"], cfg["heads"] * cfg["dim_head"], \
        cfg["num_queries"]
    _lin_site(out, b * s, cfg["embedding_dim"], d)
    for _ in range(cfg["depth"]):
        _lin_site(out, b * q, d, inner)
        _lin_site(out, b * (s + q), d, 2 * inner)
        out.append(_site("attn", attention(b, cfg["heads"], q, s + q,
                                           cfg["dim_head"])))
        _lin_site(out, b * q, inner, d)
        _lin_site(out, b * q, d, d * cfg["ff_mult"])
        _lin_site(out, b * q, d * cfg["ff_mult"], d)
    _lin_site(out, b * q, d, cfg["output_dim"])
    return out


# ---------------------------------------------------------------------------
# a serving step, a request, a train step
# ---------------------------------------------------------------------------


def _ctx_len(stack):
    u = stack["unet"]
    return 77 + (u["ip_num_tokens"] if u["ip_adapter"] else 0)


def vision_tokens(stack):
    v = stack["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def step_sites(stack, traffic):
    """One CFG denoise step: GarmentNet on the B cond rows, TryonNet on the
    2B CFG rows, each tagged with its UNet."""
    b = traffic["batch"]
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    h, w = traffic["height"] // ds, traffic["width"] // ds
    g = [dict(s, unet="garm") for s in
         unet_sites(stack["garm"], b, h, w, ctx_len=77)]
    u = [dict(s, unet="unet") for s in
         unet_sites(stack["unet"], 2 * b, h, w, ctx_len=_ctx_len(stack),
                    garment=b)]
    return g + u


def total_ops(sites) -> int:
    return sum(s["ops"] for s in sites if not s.get("unused"))


def request_ops(stack, traffic) -> int:
    """Model operations of one served request: the staged encode (both
    text towers on the prompt, negative and cloth prompts; ViT-H on the
    zero and the garment image; the Resampler; the VAE on the masked
    person, pose and cloth), the steps and the decode."""
    b = traffic["batch"]
    hh, ww = traffic["height"], traffic["width"]
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    enc = (clip_text_sites(stack["clip_l"], 3 * b)
           + clip_text_sites(stack["clip_g"], 3 * b)
           + clip_vision_sites(stack["vision"], 2 * b)
           + resampler_sites(stack["resampler"], 2 * b, vision_tokens(stack))
           + vae_sites(stack["vae"], 3 * b, hh, ww, encode=True))
    dec = vae_sites(stack["vae"], b, hh // ds, ww // ds, encode=False)
    return (total_ops(enc) + traffic["steps"] * total_ops(
        step_sites(stack, traffic)) + total_ops(dec))


def train_step_ops(stack, traffic) -> int:
    """Model operations of one train step: the frozen forwards (the VAE on
    person, masked person, pose and cloth; both text towers on the prompt
    and the cloth prompt; ViT-H; GarmentNet) and 3x the trained forwards
    (TryonNet and the Resampler, forward plus a backward of twice it).
    Remat's recompute is not counted."""
    b = traffic["batch"]
    hh, ww = traffic["height"], traffic["width"]
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    h, w = hh // ds, ww // ds
    frozen = (vae_sites(stack["vae"], 4 * b, hh, ww, encode=True)
              + clip_text_sites(stack["clip_l"], 2 * b)
              + clip_text_sites(stack["clip_g"], 2 * b)
              + clip_vision_sites(stack["vision"], b)
              + unet_sites(stack["garm"], b, h, w, ctx_len=77))
    trained = (resampler_sites(stack["resampler"], b, vision_tokens(stack))
               + unet_sites(stack["unet"], b, h, w,
                            ctx_len=_ctx_len(stack), garment=b))
    return total_ops(frozen) + 3 * total_ops(trained)


def bound_seconds(ops, nbytes, peak_ops, peak_bps) -> float:
    return max(ops / peak_ops, nbytes / peak_bps)
