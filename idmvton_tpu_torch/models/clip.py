"""CLIP text towers (CLIP-L, OpenCLIP bigG) and the ViT-H vision tower.

Counterpart of ``idmvton_tpu/models/clip.py``. SDXL consumes the
penultimate hidden state of both text towers and bigG's pooled projection;
IP-Adapter-plus consumes ViT-H's penultimate state. No kernels here: the
JAX package runs these towers through XLA. ``clip_text_apply_pp`` /
``clip_vision_apply_pp`` run the encoder stacks through the GPipe
schedule of ``parallel/pp.py`` (the ``stack_fn`` seam), the embedding and
pooling ends replicated.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from idmvton_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from idmvton_tpu_torch.models.layers import (
    ACTIVATIONS, Conv, Embedding, Linear, Norm, conv2d_torch, layer_norm,
    linear,
)
from idmvton_tpu_torch.ops.attention import attend, sdpa


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer with biased q/k/v."""

    def __init__(self, hidden, intermediate, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = Norm(hidden, device=device)
        self.attn = nn.ModuleDict({n: Linear(hidden, hidden, **kw)
                                   for n in ("q", "k", "v", "out")})
        self.ln2 = Norm(hidden, device=device)
        self.mlp = nn.ModuleDict({"fc1": Linear(hidden, intermediate, **kw),
                                  "fc2": Linear(intermediate, hidden, **kw)})

    def forward(self, x, *, num_heads, act, causal):
        h = layer_norm(self.ln1, x)
        b, s, c = h.shape
        hd = c // num_heads
        q, k, v = (linear(self.attn[n], h).reshape(b, s, num_heads, hd)
                   for n in ("q", "k", "v"))
        if causal:
            mask = torch.ones(s, s, dtype=torch.bool,
                              device=x.device).tril_()
            a = attend(q, k, v, hd ** -0.5, mask=mask)
        else:
            a = sdpa(q, k, v, impl="torch")
        x = x + linear(self.attn["out"], a.reshape(b, s, c))
        h = linear(self.mlp["fc1"], layer_norm(self.ln2, x))
        h = act(h.float()).to(x.dtype)
        return x + linear(self.mlp["fc2"], h)


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embedding = Embedding(cfg.max_position_embeddings,
                                            cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.hidden_size, cfg.intermediate_size, **kw)
            for _ in range(cfg.num_layers))
        self.final_ln = Norm(cfg.hidden_size, device=device)
        self.text_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)
            if cfg.use_final_projection else None)

    def forward(self, input_ids, *, clip_skip: int = None, stack_fn=None):
        """input_ids (B, S) int. Returns {"penultimate" (B, S, hidden),
        "last_hidden", and "pooled" (B, projection_dim) when projected}.
        ``clip_skip=k`` takes hidden_states[-(k + 2)] as "penultimate" (k
        more final layers skipped); None or 0 is the default. The pooled
        output always comes off the whole tower. ``stack_fn(x,
        capture_before) -> (final hidden, hidden before layer
        capture_before)`` replaces the encoder stack (the pipeline-parallel
        form's seam)."""
        cfg = self.cfg
        skip = clip_skip or 0
        if not 0 <= skip < cfg.num_layers:
            raise ValueError(f"clip_skip={clip_skip} out of range for "
                             f"{cfg.num_layers}-layer tower")
        act = ACTIVATIONS[cfg.hidden_act]
        # an id past the table reads its last row, as JAX's gather clamps
        # it (the hash tokenizer's 49406/49407 on the tiny 1000-token vocab)
        x = self.token_embedding.embedding[
            input_ids.clamp(0, cfg.vocab_size - 1)]
        pos = self.position_embedding.embedding[:input_ids.shape[1]]
        x = x + pos[None].to(x.dtype)
        cap_idx = cfg.num_layers - 1 - skip
        if stack_fn is not None:
            x, penultimate = stack_fn(x, cap_idx)
        else:
            penultimate = None
            for i, lyr in enumerate(self.layers):
                if i == cap_idx:
                    penultimate = x
                x = lyr(x, num_heads=cfg.num_heads, act=act, causal=True)
        last = layer_norm(self.final_ln, x)
        out = {"penultimate": penultimate, "last_hidden": last}
        if self.text_projection is not None:
            # pool at the eos token = argmax id (eos is the largest CLIP id)
            eos = input_ids.argmax(-1)
            pooled = last[torch.arange(last.shape[0], device=last.device),
                          eos]
            out["pooled"] = linear(self.text_projection, pooled)
        return out


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        num_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = Conv(3, cfg.hidden_size, cfg.patch_size,
                                    bias=False, **kw)
        self.class_embedding = nn.Parameter(
            torch.empty(cfg.hidden_size, **kw), requires_grad=False)
        self.position_embedding = Embedding(num_patches + 1, cfg.hidden_size,
                                            **kw)
        self.pre_ln = Norm(cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.hidden_size, cfg.intermediate_size, **kw)
            for _ in range(cfg.num_layers))
        self.post_ln = Norm(cfg.hidden_size, device=device)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim,
                                        bias=False, **kw)

    def reset_own_parameters_(self, generator):
        self.class_embedding.zero_()

    def forward(self, pixel_values, *, stack_fn=None):
        """pixel_values (B, H, W, 3), CLIP-normalized. Returns
        {"penultimate" (B, 1+P, hidden), "image_embeds" (B, projection_dim)}.
        ``stack_fn``: as ``CLIPText.forward``'s."""
        cfg = self.cfg
        act = ACTIVATIONS[cfg.hidden_act]
        h = conv2d_torch(pixel_values, self.patch_embedding.kernel,
                         stride=cfg.patch_size, padding="VALID")
        b, ph, pw, c = h.shape
        h = h.reshape(b, ph * pw, c)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, c)
        h = torch.cat([cls, h], dim=1)
        h = h + self.position_embedding.embedding[None, :h.shape[1]].to(
            h.dtype)
        h = layer_norm(self.pre_ln, h)
        if stack_fn is not None:
            h, penultimate = stack_fn(h, cfg.num_layers - 1)
        else:
            penultimate = None
            for i, lyr in enumerate(self.layers):
                if i == cfg.num_layers - 1:
                    penultimate = h
                h = lyr(h, num_heads=cfg.num_heads, act=act, causal=False)
        pooled = layer_norm(self.post_ln, h[:, 0])
        return {"penultimate": penultimate,
                "image_embeds": linear(self.visual_projection, pooled)}


def _pipelined(tower, mesh, n_micro, staged, causal):
    from idmvton_tpu_torch.parallel.pp import gpipe, shard_stages
    cfg = tower.cfg
    if staged is None:
        staged = shard_stages(tower.layers, mesh)
    act = ACTIVATIONS[cfg.hidden_act]

    def layer_fn(lyr, h):
        return lyr(h, num_heads=cfg.num_heads, act=act, causal=causal)

    return lambda x, cap: gpipe(layer_fn, staged, x, mesh=mesh,
                                n_micro=n_micro, capture_before=cap)


def clip_text_apply_pp(tower: CLIPText, input_ids, *, mesh, n_micro: int = 2,
                       clip_skip: int = None, staged=None):
    """``tower(input_ids, clip_skip=...)`` with its L identical layers split
    into the mesh's model-axis stages and microbatches flowing through the
    GPipe schedule (``parallel/pp.py``): the same outputs, the penultimate
    / clip_skip seam taken with gpipe's ``capture_before``, the embedding,
    final LN and eos pooling replicated. Pass ``staged =
    shard_stages(tower.layers, mesh)`` made once at load time to keep only
    this stage's layers (the tower's own ``layers`` may then be dropped)."""
    return tower(input_ids, clip_skip=clip_skip,
                 stack_fn=_pipelined(tower, mesh, n_micro, staged, True))


def clip_vision_apply_pp(tower: CLIPVision, pixel_values, *, mesh,
                         n_micro: int = 2, staged=None):
    """``tower(pixel_values)`` through the same GPipe split as
    ``clip_text_apply_pp`` (ViT-H's 32 non-causal layers, the largest
    frozen stack); patch / class / position embedding and the post-LN
    projection replicated."""
    return tower(pixel_values,
                 stack_fn=_pipelined(tower, mesh, n_micro, staged, False))
