"""VITON-HD datasets (host-side, numpy).

Mirrors the reference datasets' on-disk contract and outputs:
- VitonHDDataset (test): reference VitonHDTestDataset (inference.py:75-196) —
  pairs file, tagged-JSON captions, precomputed agnostic-mask + densepose.
- VitonHDDataset (train): reference train dataset (train_xl.py:31-250) with
  the reference's augmentations (hflip / color jitter / affine scale +
  translate — train_xl.py:152-216, implemented in data/augment.py).

DressCode lives in data/dresscode.py (needs the on-the-fly agnostic-mask
compositor from preprocess/).

Own copy of ``idmvton_tpu/data/datasets.py`` for the PyTorch port, which
imports nothing of the JAX package; tests hold the two bit for bit.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple

import numpy as np

from idmvton_tpu_torch.data.image import (
    clip_preprocess, load_mask, normalize_pm1,
)

ANNOTATION_KEYS = ("sleeveLength", "neckLine", "item")


def load_tagged_annotations(path: str) -> Dict[str, str]:
    """vitonhd_{phase}_tagged.json -> {file_name: caption fragment}
    (reference: inference.py:102-120)."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for _, v in data.items():
        for elem in v:
            s = ""
            for template in ANNOTATION_KEYS:
                for tag in elem["tag_info"]:
                    if tag["tag_name"] == template and tag["tag_category"] is not None:
                        s += tag["tag_category"] + " "
            out[elem["file_name"]] = s
    return out


class VitonHDDataset:
    """Yields dict samples with numpy arrays:
    person/pose/cloth (H, W, 3) in [-1,1]; mask (H, W, 1) {0,1} (1=inpaint);
    ip_pixels (224, 224, 3) CLIP-normalized; caption / caption_cloth strings.
    """

    def __init__(self, dataroot: str, *, phase: str = "test",
                 order: str = "paired", size: Tuple[int, int] = (1024, 768),
                 hflip_prob: float = 0.0, aug_color_jitter: bool = False,
                 aug_affine: bool = False, seed: int = 0):
        self.dataroot = dataroot
        self.phase = phase
        self.height, self.width = size
        self.hflip_prob = hflip_prob
        self.aug_color_jitter = aug_color_jitter
        self.aug_affine = aug_affine
        self._rng = random.Random(seed)

        tagged = os.path.join(dataroot, phase, f"vitonhd_{phase}_tagged.json")
        if not os.path.exists(tagged):
            tagged = os.path.join(dataroot, f"vitonhd_{phase}_tagged.json")
        self.annotation = (load_tagged_annotations(tagged)
                           if os.path.exists(tagged) else {})

        pairs = os.path.join(dataroot, f"{phase}_pairs.txt")
        self.im_names: List[str] = []
        self.c_names: List[str] = []
        with open(pairs) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                im_name = parts[0]
                c_name = (parts[1] if (phase == "test" and order == "unpaired")
                          else im_name)
                self.im_names.append(im_name)
                self.c_names.append(c_name)

    def __len__(self):
        return len(self.im_names)

    def _path(self, kind: str, name: str) -> str:
        return os.path.join(self.dataroot, self.phase, kind, name)

    def _augmentation(self):
        """One sample's random draws, in the reference's order: (flip,
        color jitter parameters or None, affine scale or None, translation
        in pixels or None)."""
        rng = self._rng
        flip = self.hflip_prob > 0 and rng.random() < self.hflip_prob
        jitter = scale = shift = None
        if self.aug_color_jitter and rng.random() < 0.5:
            from idmvton_tpu_torch.data.augment import sample_jitter_params
            jitter = sample_jitter_params(rng)
        if self.aug_affine and rng.random() < 0.5:
            scale = rng.uniform(0.8, 1.2)
        if self.aug_affine and rng.random() < 0.5:
            shift = (rng.uniform(-0.2, 0.2) * self.width,
                     rng.uniform(-0.2, 0.2) * self.height)
        return flip, jitter, scale, shift

    def skip(self, index: int) -> None:
        """Takes sample ``index``'s random draws without loading it, so
        the samples after it are augmented as if it had been loaded."""
        self._augmentation()

    def __getitem__(self, index: int) -> dict:
        from PIL import Image
        im_name = self.im_names[index]
        c_name = self.c_names[index]
        annotation = self.annotation.get(c_name, "shirts")
        size = (self.width, self.height)

        cloth_pil = Image.open(self._path("cloth", c_name))
        person = normalize_pm1(Image.open(self._path("image", im_name)), size)
        mask = load_mask(Image.open(self._path(
            "agnostic-mask", im_name.replace(".jpg", "_mask.png"))), size)
        pose = normalize_pm1(Image.open(self._path("image-densepose", im_name)), size)
        cloth = normalize_pm1(cloth_pil, size)

        flip, jitter, scale, shift = self._augmentation()
        if flip:
            person, mask, pose, cloth = (np.ascontiguousarray(x[:, ::-1])
                                         for x in (person, mask, pose, cloth))
            cloth_pil = cloth_pil.transpose(Image.FLIP_LEFT_RIGHT)

        if jitter is not None:
            # jitter person + cloth with ONE parameter draw; the CLIP image
            # is computed from the jittered cloth (train_xl.py:161-173,222)
            from idmvton_tpu_torch.data.augment import color_jitter
            b, c, s, h = jitter
            person = color_jitter((person + 1.0) / 2.0, b, c, s, h) * 2.0 - 1.0
            cloth01 = np.asarray(cloth_pil.convert("RGB"),
                                 np.float32) / 255.0
            cloth01 = color_jitter(cloth01, b, c, s, h)
            cloth_pil = Image.fromarray(
                (cloth01 * 255.0).round().astype(np.uint8))
            cloth = normalize_pm1(cloth_pil, size)

        if scale is not None:
            # scale about center: image/mask/pose, NOT cloth
            # (train_xl.py:176-188)
            from idmvton_tpu_torch.data.augment import affine_nearest
            person, mask, pose = (affine_nearest(x, scale=scale)
                                  for x in (person, mask, pose))
        if shift is not None:
            # translate: image/mask/pose (train_xl.py:190-216)
            from idmvton_tpu_torch.data.augment import affine_nearest
            person, mask, pose = (affine_nearest(x, translate=shift)
                                  for x in (person, mask, pose))

        ip_pixels = clip_preprocess(cloth_pil)

        return {
            "im_name": im_name,
            "c_name": c_name,
            "person": person.astype(np.float32),
            "mask": mask.astype(np.float32),
            "pose": pose.astype(np.float32),
            "cloth": cloth.astype(np.float32),
            "ip_pixels": ip_pixels.astype(np.float32),
            "caption": "model is wearing " + annotation,
            "caption_cloth": "a photo of " + annotation,
        }


class BatchLoader:
    """Minimal batching iterator with optional background prefetch — the TPU
    feeds from host RAM; one worker thread keeps the next batch ready while
    the device computes (replaces torch DataLoader(num_workers=4),
    inference.py:303-314)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, prefetch: bool = True,
                 shard=(0, 1)):
        """``shard=(rank, ranks)``: yield rank's ``batch_size`` rows of each
        global batch of ``batch_size * ranks`` in the one order every rank
        shares (a data-parallel rank's share); the others' samples go
        through ``dataset.skip``, so a row gets the random draws one
        loader of the global batch would give it."""
        rank, ranks = shard
        if not 0 <= rank < ranks or (ranks > 1 and not drop_last):
            raise ValueError(f"shard {shard}: a rank of ranks, with "
                             f"drop_last above one rank")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard = shard

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed).shuffle(idx)
        return idx

    def __len__(self):
        n, g = len(self.dataset), self.batch_size * self.shard[1]
        return n // g if self.drop_last else -(-n // g)

    def _collate(self, samples):
        batch = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                batch[k] = np.stack(vals)
            else:
                batch[k] = vals
        return batch

    def _iter_batches(self):
        idx = self._indices()
        rank, ranks = self.shard
        g, lo = self.batch_size * ranks, self.batch_size * rank
        for i in range(0, len(idx), g):
            chunk = idx[i:i + g]
            if self.drop_last and len(chunk) < g:
                return
            for j in chunk[:lo]:
                self.dataset.skip(j)
            mine = [self.dataset[j] for j in chunk[lo:lo + self.batch_size]]
            for j in chunk[lo + self.batch_size:]:
                self.dataset.skip(j)
            yield self._collate(mine)

    def __iter__(self):
        if not self.prefetch:
            yield from self._iter_batches()
            return
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()

        def worker():
            try:
                for b in self._iter_batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
