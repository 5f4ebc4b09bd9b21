"""VITON-HD / DressCode batch inference CLI of the PyTorch port.

Counterpart of ``idmvton_tpu/cli/infer.py`` (reference: inference.py
main(), :201-426), with the same flags plus ``--device``:

  python -m idmvton_tpu_torch.cli.infer --data_dir /path/VITON-HD \\
      --output_dir result --unpaired --num_inference_steps 30 \\
      --guidance_scale 2.0 --test_batch_size 2 [--tiny] [--device cpu]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU. ``--pretrained DIR --diffusers`` loads a diffusers-layout tree (the
yisol/IDM-VTON hub layout, ``weights.checkpoint.from_diffusers``),
``--pretrained DIR`` alone the port's pipeline checkpoint
(``load_pipeline``); without ``--pretrained`` the weights are random, from
seed 0 (shape and speed validation only). Every batch goes through
``TryonPipeline.jit_generate``, as in the
JAX package's CLI on every backend but the TPU: on the card each denoise
step is replayed from one captured CUDA graph.

``main`` reads the dataset and writes the images (PIL); ``build`` makes
the pipeline, tokenizers and generator it serves with; ``run`` is the
per-batch loop on batches already in memory, free of image files.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

NEGATIVE_PROMPT = "monochrome, lowres, bad anatomy, worst quality, low quality"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="idmvton_tpu_torch VITON-HD / DressCode inference")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--dataset", default="vitonhd",
                   choices=["vitonhd", "dresscode"])
    p.add_argument("--category", default="upper_body",
                   choices=["upper_body", "lower_body", "dresses"],
                   help="DressCode category (reference: inference_dc.py)")
    p.add_argument("--output_dir", default="result")
    p.add_argument("--pretrained", default=None,
                   help="pipeline checkpoint dir (or diffusers dir with "
                        "--diffusers)")
    p.add_argument("--diffusers", action="store_true")
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with tokenizer/ tokenizer_2/ vocab files")
    p.add_argument("--unpaired", action="store_true")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--strength", type=float, default=1.0,
                   help="denoise strength; <1 starts from noised person-image "
                        "latents (reference prepare_latents semantics)")
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--test_batch_size", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--limit", type=int, default=None, help="max batches")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (smoke tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def load_models(args, dtype):
    """The try-on stack on ``args.device``: from the diffusers tree
    ``--pretrained`` with ``--diffusers``, from the pipeline checkpoint
    ``--pretrained`` without, else random weights from seed 0."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.weights.checkpoint import (
        from_diffusers, load_pipeline,
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is visible; pass "
                           "--device cpu to run on the CPU")
    if args.pretrained and args.diffusers:
        return from_diffusers(args.pretrained, dtype, device=device)
    if args.pretrained:
        return load_pipeline(args.pretrained, dtype, device=device)
    return TryonModels.init(0, tiny=args.tiny, device=device, dtype=dtype)


def build(args, models):
    """The CLI's serving objects for ``models``: the try-on pipeline (the
    SDXL inference scheduler), the two tokenizers (vocab files from
    ``--tokenizer_dir``, else from the ``--pretrained`` tree with
    ``--diffusers``, else the hash tokenizer) and the request generator
    seeded from ``--seed`` on ``args.device``."""
    from idmvton_tpu_torch.data.tokenizer import load_tokenizers
    from idmvton_tpu_torch.pipeline.tryon import TryonPipeline
    tok_dir = args.tokenizer_dir or (args.pretrained if args.diffusers
                                     else None)
    tok1, tok2 = load_tokenizers(
        os.path.join(tok_dir, "tokenizer") if tok_dir else None,
        os.path.join(tok_dir, "tokenizer_2") if tok_dir else None)
    generator = torch.Generator(device=torch.device(args.device))
    generator.manual_seed(args.seed)
    return TryonPipeline(models), tok1, tok2, generator


def resize_ip_pixels(ip, size: int):
    """(B, S, S, 3) -> (B, size, size, 3) bilinear with half-pixel centers,
    antialiased when it shrinks, as ``jax.image.resize(..., "bilinear")``."""
    x = ip.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def run(args, pipe, models, loader, tok1, tok2, generator):
    """Yields (image names, uint8 images (B, H, W, 3)) for each batch of
    ``loader`` (numpy batches in the dataset layout), up to ``args.limit``
    batches, generated on the models' device in their dtype."""
    from idmvton_tpu_torch.data.image import denormalize_to_uint8
    param = next(models.unet.parameters())
    dev, dtype = param.device, param.dtype
    gen = pipe.jit_generate(num_steps=args.num_inference_steps,
                            guidance_scale=args.guidance_scale,
                            strength=args.strength)
    isz = models.vision_cfg.image_size

    def tensor(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    def ids(tok, texts):
        return tensor(tok(texts)).long()

    for bi, batch in enumerate(loader):
        if args.limit is not None and bi >= args.limit:
            break
        b = batch["person"].shape[0]
        negative = [NEGATIVE_PROMPT] * b
        ip = tensor(batch["ip_pixels"])
        if ip.shape[1] != isz:
            ip = resize_ip_pixels(ip, isz)
        inputs = dict(
            person=tensor(batch["person"]).to(dtype),
            mask=tensor(batch["mask"]).to(dtype),
            pose=tensor(batch["pose"]).to(dtype),
            cloth=tensor(batch["cloth"]).to(dtype),
            ip_pixels=ip.to(dtype),
            prompt_ids_l=ids(tok1, batch["caption"]),
            prompt_ids_g=ids(tok2, batch["caption"]),
            neg_ids_l=ids(tok1, negative),
            neg_ids_g=ids(tok2, negative),
            cloth_ids_l=ids(tok1, batch["caption_cloth"]),
            cloth_ids_g=ids(tok2, batch["caption_cloth"]),
        )
        images = gen(generator, **inputs)
        yield list(batch["im_name"]), denormalize_to_uint8(
            images.float().cpu().numpy())


def main(argv=None):
    args = parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    from PIL import Image

    from idmvton_tpu_torch.data.datasets import BatchLoader, VitonHDDataset

    models = load_models(args, dtype)
    pipe, tok1, tok2, generator = build(args, models)

    order = "unpaired" if args.unpaired else "paired"
    if args.dataset == "dresscode":
        from idmvton_tpu_torch.data.dresscode import DressCodeDataset
        ds = DressCodeDataset(args.data_dir, category=args.category,
                              phase="test", order=order,
                              size=(args.height, args.width))
    else:
        ds = VitonHDDataset(args.data_dir, phase="test", order=order,
                            size=(args.height, args.width))
    loader = BatchLoader(ds, args.test_batch_size)
    os.makedirs(args.output_dir, exist_ok=True)

    total, t_start = 0, time.time()
    for bi, (names, images) in enumerate(
            run(args, pipe, models, loader, tok1, tok2, generator)):
        for name, img in zip(names, images):
            Image.fromarray(img).save(os.path.join(args.output_dir, name))
        total += len(names)
        print(f"batch {bi}: {len(names)} images "
              f"({total / (time.time() - t_start):.3f} img/s cumulative)")
    print(f"done: {total} images -> {args.output_dir}")


if __name__ == "__main__":
    main()
