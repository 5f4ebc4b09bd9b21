"""diffusers / transformers state dicts <-> the port's modules.

Counterpart of ``idmvton_tpu/weights/converter.py``: the five weight
families the reference loads (inference.py:232-274) -- two UNets (the
try-on one with IP-Adapter processor weights), the VAE, the two CLIP text
towers, CLIP ViT-H and the Perceiver Resampler (ip-adapter-plus
``image_proj``) -- with the same schemas, keys and numerics.

A schema lists ``(kind, our path, reference key)`` for every leaf module
of a family; ``convert_*`` walks it, so every parameter is covered or a
``KeyError`` names the missing key, and returns the nested tree of tensors
that ``weights.from_jax.load_module_params`` fills a module from (the port's
modules keep the JAX layouts and key names). ``export_*`` walk the same
schema over a module, back to the reference keys (fp32, as JAX's
exporters write, unless ``dtype`` says otherwise).

Layouts: conv torch (O, I, kh, kw) <-> ours (kh, kw, I, O); linear (O, I)
<-> (I, O); norm ``weight`` <-> ``scale``; the attention projections fused
(``to_qkv`` = [q | k | v], ``to_kv``, ``to_kv_ip``). Each leaf moves to
the device it is bound for as it is read; the casts, transposes, concats
and the conv_in surgery run there, so the host only moves bytes.

Numerics, as JAX's: each leaf is cast to ``dtype`` before anything else,
so norm scale and bias are rounded through ``dtype`` and then widened to
fp32, and fused projections concatenate parts already in ``dtype``.
``convert_unet`` widens the try-on conv_in to the config's input channels
with zero-initialized extra channels (train_xl.py:359-373), so raw
9-channel SDXL-inpainting weights load as the 13-channel TryonNet.
"""

from __future__ import annotations

import zipfile
from collections.abc import Mapping
from typing import Optional

import torch

from idmvton_tpu_torch.core.config import (
    CLIPTextConfig, CLIPVisionConfig, ResamplerConfig, UNetConfig, VAEConfig,
)
from idmvton_tpu_torch.weights.safetensors import SafetensorsReader


# ---------------------------------------------------------------------------
# state-dict IO
# ---------------------------------------------------------------------------


def load_state_dict(path: str, device="cpu") -> Mapping:
    """A state dict from a .safetensors, .bin, .pth or .pt file. A
    safetensors file gives a lazy ``SafetensorsReader`` (each tensor read
    to ``device`` when it is looked up; close it when done); a pickle file
    (``torch.load``, tensors only) gives a dict of its
    tensors on the CPU, with a top-level ``state_dict`` unwrapped and
    nested dicts flattened with dots. A pickle in torch's legacy (non-zip)
    format cannot be memory-mapped and is read whole."""
    if path.endswith(".safetensors"):
        return SafetensorsReader(path, device)
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    flat = {}

    def walk(prefix, d):
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, torch.Tensor):
                flat[key] = v
            elif isinstance(v, dict):
                walk(key + ".", v)
    walk("", obj)
    return flat


def close_state_dict(sd: Mapping) -> None:
    """Closes what ``load_state_dict`` opened (a reader's mapping)."""
    if isinstance(sd, SafetensorsReader):
        sd.close()


# ---------------------------------------------------------------------------
# leaf transforms
# ---------------------------------------------------------------------------


def _t_conv(w):
    return w.permute(2, 3, 1, 0)


def _t_conv_inv(w):
    return w.permute(3, 2, 0, 1)


def _t_lin(w):
    return w.t()


class _Mapper:
    """Reads reference keys, records each one used."""

    def __init__(self, sd: Mapping, dtype, device):
        self.sd = sd
        self.dtype = dtype
        self.device = torch.device(device)
        self.used = set()

    def take(self, key: str, transform=None):
        if key not in self.sd:
            raise KeyError(f"missing weight: {key}")
        self.used.add(key)
        x = self.sd[key].to(self.device).to(self.dtype)
        return x if transform is None else transform(x)

    def conv(self, key, bias=True):
        p = {"kernel": self.take(key + ".weight", _t_conv)}
        if bias and key + ".bias" in self.sd:
            p["bias"] = self.take(key + ".bias")
        return p

    def linear(self, key, bias=True):
        p = {"kernel": self.take(key + ".weight", _t_lin)}
        if bias:
            p["bias"] = self.take(key + ".bias")
        return p

    def norm(self, key):
        return {"scale": self.take(key + ".weight").float(),
                "bias": self.take(key + ".bias").float()}


def _get_path(module, path):
    """The submodule or parameter of ``module`` at a schema path."""
    for p in path:
        module = module[p] if isinstance(p, int) else getattr(module, p)
    return module


def _set_path(tree, path, value):
    node = tree
    for i, p in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(p, int):
            while len(node) <= p:
                node.append({})
            node = node[p]
        else:
            if p not in node:
                node[p] = [] if isinstance(nxt, int) else {}
            node = node[p]
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# schemas: (kind, our path, reference key)
#
# kinds whose reference is a module prefix: conv (kernel, bias when the
# state dict has it), conv_nobias, linear, linear_nobias, linear_fused
# (a list of prefixes, concatenated along the output axis), norm; kinds
# whose reference is the full key: embedding ({"embedding": leaf}), param
# (the leaf itself), latents (the leaf without its leading axis of 1)
# ---------------------------------------------------------------------------


def _unet_schema(cfg: UNetConfig):
    entries = []

    def resnet(our, ref, has_temb=True, has_shortcut=False):
        entries.append(("norm", our + ("norm1",), ref + ".norm1"))
        entries.append(("conv", our + ("conv1",), ref + ".conv1"))
        entries.append(("norm", our + ("norm2",), ref + ".norm2"))
        entries.append(("conv", our + ("conv2",), ref + ".conv2"))
        if has_temb:
            entries.append(("linear", our + ("time_emb_proj",),
                            ref + ".time_emb_proj"))
        if has_shortcut:
            entries.append(("conv", our + ("conv_shortcut",),
                            ref + ".conv_shortcut"))

    def transformer(our, ref, depth):
        entries.append(("norm", our + ("norm",), ref + ".norm"))
        entries.append(("linear", our + ("proj_in",), ref + ".proj_in"))
        entries.append(("linear", our + ("proj_out",), ref + ".proj_out"))
        for k in range(depth):
            b_our = our + ("blocks", k)
            b_ref = f"{ref}.transformer_blocks.{k}"
            entries.append(("norm", b_our + ("norm1",), b_ref + ".norm1"))
            entries.append(("norm", b_our + ("norm2",), b_ref + ".norm2"))
            entries.append(("norm", b_our + ("norm3",), b_ref + ".norm3"))
            entries.append(("linear_fused", b_our + ("attn1", "to_qkv"),
                            [f"{b_ref}.attn1.to_q", f"{b_ref}.attn1.to_k",
                             f"{b_ref}.attn1.to_v"]))
            entries.append(("linear_nobias", b_our + ("attn2", "to_q"),
                            b_ref + ".attn2.to_q"))
            entries.append(("linear_fused", b_our + ("attn2", "to_kv"),
                            [f"{b_ref}.attn2.to_k", f"{b_ref}.attn2.to_v"]))
            entries.append(("linear", b_our + ("attn1", "to_out"),
                            b_ref + ".attn1.to_out.0"))
            entries.append(("linear", b_our + ("attn2", "to_out"),
                            b_ref + ".attn2.to_out.0"))
            if cfg.ip_adapter:
                entries.append(("linear_fused", b_our + ("attn2", "to_kv_ip"),
                                [f"{b_ref}.attn2.processor.to_k_ip",
                                 f"{b_ref}.attn2.processor.to_v_ip"]))
            entries.append(("linear", b_our + ("ff", "proj_in"),
                            b_ref + ".ff.net.0.proj"))
            entries.append(("linear", b_our + ("ff", "proj_out"),
                            b_ref + ".ff.net.2"))

    entries.append(("conv", ("conv_in",), "conv_in"))
    entries.append(("linear", ("time_embedding", "linear_1"),
                    "time_embedding.linear_1"))
    entries.append(("linear", ("time_embedding", "linear_2"),
                    "time_embedding.linear_2"))
    if cfg.addition_embed:
        entries.append(("linear", ("add_embedding", "linear_1"),
                        "add_embedding.linear_1"))
        entries.append(("linear", ("add_embedding", "linear_2"),
                        "add_embedding.linear_2"))

    chans = cfg.block_out_channels
    in_ch = chans[0]
    for lvl, btype in enumerate(cfg.down_block_types):
        out_ch = chans[lvl]
        for j in range(cfg.layers_per_block):
            resnet(("down_blocks", lvl, "resnets", j),
                   f"down_blocks.{lvl}.resnets.{j}",
                   has_shortcut=(j == 0 and in_ch != out_ch))
            if btype == "attn":
                transformer(("down_blocks", lvl, "attentions", j),
                            f"down_blocks.{lvl}.attentions.{j}",
                            cfg.transformer_depth[lvl])
        if lvl < cfg.num_levels - 1:
            entries.append(("conv", ("down_blocks", lvl, "downsample", "conv"),
                            f"down_blocks.{lvl}.downsamplers.0.conv"))
        in_ch = out_ch

    resnet(("mid_block", "resnets", 0), "mid_block.resnets.0")
    resnet(("mid_block", "resnets", 1), "mid_block.resnets.1")
    transformer(("mid_block", "attentions", 0), "mid_block.attentions.0",
                cfg.transformer_depth[-1])

    for i, btype in enumerate(cfg.up_block_types):
        lvl = cfg.num_levels - 1 - i
        if cfg.skip_final_output and btype == "plain":
            break
        for j in range(cfg.layers_per_block + 1):
            resnet(("up_blocks", i, "resnets", j),
                   f"up_blocks.{i}.resnets.{j}", has_shortcut=True)
            if btype == "attn":
                transformer(("up_blocks", i, "attentions", j),
                            f"up_blocks.{i}.attentions.{j}",
                            cfg.transformer_depth[lvl])
        if i < cfg.num_levels - 1:
            entries.append(("conv", ("up_blocks", i, "upsample", "conv"),
                            f"up_blocks.{i}.upsamplers.0.conv"))

    if not cfg.skip_final_output:
        entries.append(("norm", ("conv_norm_out",), "conv_norm_out"))
        entries.append(("conv", ("conv_out",), "conv_out"))
    return entries


def _vae_schema(cfg: VAEConfig):
    entries = []

    def resnet(our, ref, has_shortcut):
        entries.append(("norm", our + ("norm1",), ref + ".norm1"))
        entries.append(("conv", our + ("conv1",), ref + ".conv1"))
        entries.append(("norm", our + ("norm2",), ref + ".norm2"))
        entries.append(("conv", our + ("conv2",), ref + ".conv2"))
        if has_shortcut:
            entries.append(("conv", our + ("conv_shortcut",),
                            ref + ".conv_shortcut"))

    def attn(our, ref):
        entries.append(("norm", our + ("norm",), ref + ".group_norm"))
        entries.append(("linear", our + ("to_q",), ref + ".to_q"))
        entries.append(("linear", our + ("to_k",), ref + ".to_k"))
        entries.append(("linear", our + ("to_v",), ref + ".to_v"))
        entries.append(("linear", our + ("to_out",), ref + ".to_out.0"))

    chans = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    entries.append(("conv", ("encoder", "conv_in"), "encoder.conv_in"))
    in_ch = chans[0]
    for lvl, out_ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            resnet(("encoder", "down_blocks", lvl, "resnets", j),
                   f"encoder.down_blocks.{lvl}.resnets.{j}",
                   has_shortcut=(j == 0 and in_ch != out_ch))
        if lvl < len(chans) - 1:
            entries.append(("conv",
                            ("encoder", "down_blocks", lvl, "downsample",
                             "conv"),
                            f"encoder.down_blocks.{lvl}.downsamplers.0.conv"))
        in_ch = out_ch
    resnet(("encoder", "mid", "resnets", 0), "encoder.mid_block.resnets.0",
           False)
    resnet(("encoder", "mid", "resnets", 1), "encoder.mid_block.resnets.1",
           False)
    attn(("encoder", "mid", "attn"), "encoder.mid_block.attentions.0")
    entries.append(("norm", ("encoder", "norm_out"), "encoder.conv_norm_out"))
    entries.append(("conv", ("encoder", "conv_out"), "encoder.conv_out"))

    entries.append(("conv", ("decoder", "conv_in"), "decoder.conv_in"))
    resnet(("decoder", "mid", "resnets", 0), "decoder.mid_block.resnets.0",
           False)
    resnet(("decoder", "mid", "resnets", 1), "decoder.mid_block.resnets.1",
           False)
    attn(("decoder", "mid", "attn"), "decoder.mid_block.attentions.0")
    rev = list(reversed(chans))
    in_ch = rev[0]
    for lvl, out_ch in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(("decoder", "up_blocks", lvl, "resnets", j),
                   f"decoder.up_blocks.{lvl}.resnets.{j}",
                   has_shortcut=(j == 0 and in_ch != out_ch))
        if lvl < len(chans) - 1:
            entries.append(("conv",
                            ("decoder", "up_blocks", lvl, "upsample", "conv"),
                            f"decoder.up_blocks.{lvl}.upsamplers.0.conv"))
        in_ch = out_ch
    entries.append(("norm", ("decoder", "norm_out"), "decoder.conv_norm_out"))
    entries.append(("conv", ("decoder", "conv_out"), "decoder.conv_out"))
    entries.append(("conv", ("quant_conv",), "quant_conv"))
    entries.append(("conv", ("post_quant_conv",), "post_quant_conv"))
    return entries


def _clip_layers_schema(n, prefix, our_prefix=()):
    entries = []
    for i in range(n):
        our = our_prefix + ("layers", i)
        ref = f"{prefix}.encoder.layers.{i}"
        entries.append(("norm", our + ("ln1",), ref + ".layer_norm1"))
        entries.append(("norm", our + ("ln2",), ref + ".layer_norm2"))
        for a, b in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("out", "out_proj")):
            entries.append(("linear", our + ("attn", a),
                            f"{ref}.self_attn.{b}"))
        entries.append(("linear", our + ("mlp", "fc1"), ref + ".mlp.fc1"))
        entries.append(("linear", our + ("mlp", "fc2"), ref + ".mlp.fc2"))
    return entries


def _clip_text_schema(cfg: CLIPTextConfig):
    p = "text_model"
    entries = _clip_layers_schema(cfg.num_layers, p)
    entries.append(("embedding", ("token_embedding",),
                    f"{p}.embeddings.token_embedding.weight"))
    entries.append(("embedding", ("position_embedding",),
                    f"{p}.embeddings.position_embedding.weight"))
    entries.append(("norm", ("final_ln",), f"{p}.final_layer_norm"))
    if cfg.use_final_projection:
        entries.append(("linear_nobias", ("text_projection",),
                        "text_projection"))
    return entries


def _clip_vision_schema(cfg: CLIPVisionConfig, pre: str = "pre_layrnorm"):
    """``pre``: the pre-norm's spelling, HF's ``pre_layrnorm`` (what the
    exporter writes) or ``pre_layernorm``."""
    p = "vision_model"
    entries = _clip_layers_schema(cfg.num_layers, p)
    entries.append(("conv_nobias", ("patch_embedding",),
                    f"{p}.embeddings.patch_embedding"))
    entries.append(("param", ("class_embedding",),
                    f"{p}.embeddings.class_embedding"))
    entries.append(("embedding", ("position_embedding",),
                    f"{p}.embeddings.position_embedding.weight"))
    entries.append(("norm", ("pre_ln",), f"{p}.{pre}"))
    entries.append(("norm", ("post_ln",), f"{p}.post_layernorm"))
    entries.append(("linear_nobias", ("visual_projection",),
                    "visual_projection"))
    return entries


def _resampler_schema(cfg: ResamplerConfig, prefix: str = ""):
    t = lambda k: prefix + k
    entries = [("latents", ("latents",), t("latents")),
               ("linear", ("proj_in",), t("proj_in")),
               ("linear", ("proj_out",), t("proj_out")),
               ("norm", ("norm_out",), t("norm_out"))]
    for i in range(cfg.depth):
        our = ("layers", i)
        # layers.{i}.0 = PerceiverAttention (norm1: x, norm2: latents);
        # layers.{i}.1 = Sequential(LayerNorm, Linear, GELU, Linear)
        entries += [
            ("norm", our + ("ln_x",), t(f"layers.{i}.0.norm1")),
            ("norm", our + ("ln_latents",), t(f"layers.{i}.0.norm2")),
            ("linear_nobias", our + ("to_q",), t(f"layers.{i}.0.to_q")),
            ("linear_nobias", our + ("to_kv",), t(f"layers.{i}.0.to_kv")),
            ("linear_nobias", our + ("to_out",), t(f"layers.{i}.0.to_out")),
            ("norm", our + ("ff_ln",), t(f"layers.{i}.1.0")),
            ("linear_nobias", our + ("ff_in",), t(f"layers.{i}.1.1")),
            ("linear_nobias", our + ("ff_out",), t(f"layers.{i}.1.3")),
        ]
    return entries


# ---------------------------------------------------------------------------
# convert / export over a schema
# ---------------------------------------------------------------------------


def _build_tree(entries, m: _Mapper, *,
                conv_in_expand_to: Optional[int] = None) -> dict:
    tree: dict = {}
    for kind, our, ref in entries:
        if kind in ("conv", "conv_nobias"):
            val = m.conv(ref, bias=kind == "conv")
            if our == ("conv_in",) and conv_in_expand_to is not None:
                k = val["kernel"].float()
                cur = k.shape[2]
                if cur < conv_in_expand_to:
                    # zero-init extra input channels (train_xl.py:359-373)
                    pad = k.new_zeros(k.shape[0], k.shape[1],
                                      conv_in_expand_to - cur, k.shape[3])
                    val["kernel"] = torch.cat([k, pad], dim=2).to(m.dtype)
        elif kind == "linear":
            val = m.linear(ref)
        elif kind == "linear_nobias":
            val = m.linear(ref, bias=False)
        elif kind == "linear_fused":
            val = {"kernel": torch.cat([m.take(k + ".weight", _t_lin)
                                        for k in ref], dim=1)}
        elif kind == "norm":
            val = m.norm(ref)
        elif kind == "embedding":
            val = {"embedding": m.take(ref)}
        elif kind == "param":
            val = m.take(ref)
        elif kind == "latents":
            val = m.take(ref)
            if val.ndim == 3:
                val = val[0]
        else:
            raise ValueError(kind)
        _set_path(tree, our, val)
    return tree


def schema_keys(entries, available) -> set:
    """The exact state-dict keys ``_build_tree`` would consume for
    ``entries`` (metadata only: full-size key sets are checked without
    materializing the weights)."""
    keys = set()
    for kind, _our, ref in entries:
        if kind == "conv":
            keys.add(ref + ".weight")
            if ref + ".bias" in available:
                keys.add(ref + ".bias")
        elif kind in ("conv_nobias", "linear_nobias"):
            keys.add(ref + ".weight")
        elif kind in ("linear", "norm"):
            keys.update((ref + ".weight", ref + ".bias"))
        elif kind == "linear_fused":
            keys.update(r + ".weight" for r in ref)
        elif kind in ("embedding", "param", "latents"):
            keys.add(ref)
        else:
            raise ValueError(kind)
    return keys


def check_consumed(sd: Mapping, used, *, ignore_prefixes=(),
                   ignore_suffixes=("num_batches_tracked",)) -> None:
    """Raises if the converter left a state-dict key unconsumed (a misnamed
    key fails at load, not as silently random weights)."""
    leftover = sorted(
        k for k in sd
        if k not in used
        and not any(k.startswith(p) for p in ignore_prefixes)
        and not any(k.endswith(s) for s in ignore_suffixes))
    if leftover:
        raise ValueError(
            f"{len(leftover)} unconsumed weights, e.g. {leftover[:8]}")


def _export(entries, module, dtype) -> dict:
    """The reference state dict of ``module`` over ``entries``, each leaf
    cast to ``dtype`` on its device. Transposed
    leaves are views (``save_file`` writes them by value), and a leaf
    already in ``dtype`` shares the parameter's memory."""
    out = {}

    def put(key, t):
        out[key] = t.detach().to(dtype)

    for kind, our, ref in entries:
        p = _get_path(module, our)
        if kind in ("conv", "conv_nobias"):
            out[ref + ".weight"] = _t_conv_inv(p.kernel.detach().to(dtype))
        elif kind in ("linear", "linear_nobias"):
            out[ref + ".weight"] = _t_lin(p.kernel.detach().to(dtype))
        elif kind == "linear_fused":
            parts = p.kernel.detach().to(dtype).chunk(len(ref), dim=1)
            for key, w in zip(ref, parts):
                out[key + ".weight"] = _t_lin(w)
        elif kind == "norm":
            put(ref + ".weight", p.scale)
        elif kind == "embedding":
            put(ref, p.embedding)
        elif kind == "param":
            put(ref, p)
        elif kind == "latents":
            put(ref, p[None])
        else:
            raise ValueError(kind)
        if kind in ("conv", "linear", "norm") and p.bias is not None:
            put(ref + ".bias", p.bias)
    return out


def convert_unet(sd: Mapping, cfg: UNetConfig, dtype=torch.bfloat16, *,
                 device="cuda", allow_conv_in_expand: bool = True,
                 strict: bool = False) -> dict:
    m = _Mapper(sd, dtype, device)
    expand = cfg.in_channels if allow_conv_in_expand else None
    tree = _build_tree(_unet_schema(cfg), m, conv_in_expand_to=expand)
    if strict:
        # the trained try-on UNet checkpoint embeds the Resampler and the
        # IP-Adapter KV weights: convert_resampler and the fused to_kv_ip
        # take those
        check_consumed(sd, m.used, ignore_prefixes=("encoder_hid_proj.",),
                       ignore_suffixes=("num_batches_tracked",
                                        "to_k_ip.weight", "to_v_ip.weight"))
    return tree


def export_unet(module, cfg: UNetConfig, *, dtype=torch.float32) -> dict:
    return _export(_unet_schema(cfg), module, dtype)


def convert_vae(sd: Mapping, cfg: VAEConfig, dtype=torch.bfloat16, *,
                device="cuda", strict: bool = False) -> dict:
    m = _Mapper(sd, dtype, device)
    tree = _build_tree(_vae_schema(cfg), m)
    if strict:
        check_consumed(sd, m.used)
    return tree


def export_vae(module, cfg: VAEConfig, *, dtype=torch.float32) -> dict:
    return _export(_vae_schema(cfg), module, dtype)


def convert_clip_text(sd: Mapping, cfg: CLIPTextConfig, dtype=torch.bfloat16,
                      *, device="cuda", strict: bool = False) -> dict:
    m = _Mapper(sd, dtype, device)
    tree = _build_tree(_clip_text_schema(cfg), m)
    if strict:
        # position_ids is a constant buffer in HF checkpoints, not a weight
        check_consumed(sd, m.used, ignore_suffixes=("position_ids",))
    return tree


def export_clip_text(module, cfg: CLIPTextConfig, *,
                     dtype=torch.float32) -> dict:
    return _export(_clip_text_schema(cfg), module, dtype)


def convert_clip_vision(sd: Mapping, cfg: CLIPVisionConfig,
                        dtype=torch.bfloat16, *, device="cuda",
                        strict: bool = False) -> dict:
    m = _Mapper(sd, dtype, device)
    # HF ships the misspelled "pre_layrnorm"
    pre = ("pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
           else "pre_layernorm")
    tree = _build_tree(_clip_vision_schema(cfg, pre), m)
    if strict:
        check_consumed(sd, m.used, ignore_prefixes=("logit_scale",))
    return tree


def export_clip_vision(module, cfg: CLIPVisionConfig, *,
                       dtype=torch.float32) -> dict:
    return _export(_clip_vision_schema(cfg), module, dtype)


def convert_resampler(sd: Mapping, cfg: ResamplerConfig, dtype=torch.bfloat16,
                      prefix: str = "", *, device="cuda",
                      strict: bool = False) -> dict:
    """ip-adapter-plus ``image_proj`` weights (reference:
    ip_adapter/resampler.py; loaded at train_xl.py:343-357). ``prefix``:
    e.g. ``"encoder_hid_proj."`` inside the try-on UNet, ``"image_proj."``
    in a raw ip-adapter file."""
    m = _Mapper(sd, dtype, device)
    tree = _build_tree(_resampler_schema(cfg, prefix), m)
    if strict:
        check_consumed(sd, m.used)
    return tree


def export_resampler(module, cfg: ResamplerConfig, prefix: str = "", *,
                     dtype=torch.float32) -> dict:
    return _export(_resampler_schema(cfg, prefix), module, dtype)
