"""The port's inference CLI and its data modules against the JAX package's,
on the CPU.

The port keeps its own copies of ``idmvton_tpu/data/*`` (it imports nothing
of the JAX package); on the synthetic VITON-HD and DressCode trees of
tests/test_data_cli.py and tests/test_dresscode.py every sample, batch,
token id and augmentation is held bit for bit against the JAX package's.
The ``ip_pixels`` resize is held against ``jax.image.resize(...,
"bilinear")``; the CLIs run end to end with ``--tiny --device cpu``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from idmvton_tpu.data import augment as jaug
from idmvton_tpu.data import datasets as jds
from idmvton_tpu.data import dresscode as jdc
from idmvton_tpu.data import image as jimg
from idmvton_tpu.data import tokenizer as jtok
from idmvton_tpu_torch.cli import infer, infer_dc
from idmvton_tpu_torch.data import augment as taug
from idmvton_tpu_torch.data import datasets as tds
from idmvton_tpu_torch.data import dresscode as tdc
from idmvton_tpu_torch.data import image as timg
from idmvton_tpu_torch.data import tokenizer as ttok
from test_data_cli import make_viton_tree
from test_dresscode import _parse, _pose, make_dresscode_tree


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("kw", [
    dict(phase="test", order="unpaired"), dict(phase="test", order="paired"),
    dict(phase="train", hflip_prob=0.5, aug_color_jitter=True,
         aug_affine=True, seed=3)])
def test_vitonhd_dataset_and_loader_match_jax(tmp_path, kw):
    root = str(tmp_path)
    make_viton_tree(root, n=3, phase=kw["phase"])
    jd = jds.VitonHDDataset(root, size=(64, 48), **kw)
    td = tds.VitonHDDataset(root, size=(64, 48), **kw)
    assert len(td) == len(jd) == 3
    for i in range(3):
        _same(td[i], jd[i])
    want = list(jds.BatchLoader(jds.VitonHDDataset(root, size=(64, 48), **kw),
                                2))
    got = list(tds.BatchLoader(tds.VitonHDDataset(root, size=(64, 48), **kw),
                               2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)


def test_dresscode_dataset_and_mask_match_jax(tmp_path):
    make_dresscode_tree(str(tmp_path))
    kw = dict(category="upper_body", size=(128, 96))
    jd = jdc.DressCodeDataset(str(tmp_path), **kw)
    td = tdc.DressCodeDataset(str(tmp_path), **kw)
    for i in range(len(jd)):
        _same(td[i], jd[i])
    for cat in tdc.CATEGORIES:
        np.testing.assert_array_equal(
            tdc.dresscode_keep_mask(_parse(), _pose(), cat, (384, 512)),
            jdc.dresscode_keep_mask(_parse(), _pose(), cat, (384, 512)))


def test_tokenizers_and_image_helpers_match_jax(tmp_path):
    texts = ["model is wearing t shirts long ", "a photo of a red shirt", ""]
    for pad in (None, 0):
        kw = {} if pad is None else {"pad_token_id": pad}
        np.testing.assert_array_equal(ttok.HashTokenizer(**kw)(texts),
                                      jtok.HashTokenizer(**kw)(texts))
    import json
    b2u = ttok._bytes_to_unicode()
    assert b2u == jtok._bytes_to_unicode()
    vocab = {}
    for ch in b2u.values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for tok in ("he", "hello</w>", "<|startoftext|>", "<|endoftext|>"):
        vocab[tok] = len(vocab)
    vp, mp = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    json.dump(vocab, open(vp, "w"))
    open(mp, "w").write("#version\nh e\nhe llo</w>\nl l\nll o</w>\n")
    np.testing.assert_array_equal(ttok.CLIPTokenizer(vp, mp)(texts),
                                  jtok.CLIPTokenizer(vp, mp)(texts))
    img = Image.fromarray(np.random.RandomState(1).randint(
        0, 255, (70, 50, 3), np.uint8))
    np.testing.assert_array_equal(timg.clip_preprocess(img),
                                  jimg.clip_preprocess(img))
    np.testing.assert_array_equal(timg.normalize_pm1(img, (30, 40)),
                                  jimg.normalize_pm1(img, (30, 40)))
    x = np.random.RandomState(2).uniform(-1.2, 1.2, (2, 5, 4, 3))
    np.testing.assert_array_equal(timg.denormalize_to_uint8(x),
                                  jimg.denormalize_to_uint8(x))


def test_augmentations_match_jax():
    x = np.random.RandomState(3).rand(9, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(taug.color_jitter(x, 1.3, 0.8, 0.6, 0.2),
                                  jaug.color_jitter(x, 1.3, 0.8, 0.6, 0.2))
    np.testing.assert_array_equal(
        taug.affine_nearest(x, scale=1.1, translate=(2.0, -1.0)),
        jaug.affine_nearest(x, scale=1.1, translate=(2.0, -1.0)))
    import random
    assert (taug.sample_jitter_params(random.Random(4))
            == jaug.sample_jitter_params(random.Random(4)))


@pytest.mark.parametrize("src,dst", [(224, 28), (20, 28), (64, 64)])
def test_ip_pixels_resize_matches_jax(src, dst):
    """Bilinear with half-pixel centers, antialiased when shrinking (a
    triangle filter widened by the scale), as jax.image.resize: fp32 sums in
    another order, max |diff| <= 1e-5 at O(1) values."""
    x = np.random.default_rng(5).uniform(-2, 2, (2, src, src, 3)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "bilinear")
    got = infer.resize_ip_pixels(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


TINY = ["--tiny", "--device", "cpu", "--width", "48", "--height", "64",
        "--num_inference_steps", "2", "--test_batch_size", "2",
        "--dtype", "float32"]


def test_infer_cli_tiny(tmp_path):
    root = str(tmp_path / "data")
    names = make_viton_tree(root, n=3)
    out = str(tmp_path / "out")
    infer.main(["--data_dir", root, "--output_dir", out, "--unpaired",
                "--strength", "0.6", *TINY])
    assert sorted(os.listdir(out)) == sorted(names)
    img = np.asarray(Image.open(os.path.join(out, names[0])))
    assert img.shape == (64, 48, 3) and img.std() > 0


def test_infer_dc_cli_tiny(tmp_path):
    make_dresscode_tree(str(tmp_path / "dc"))
    out = str(tmp_path / "out")
    infer_dc.main(["--data_dir", str(tmp_path / "dc"), "--output_dir", out,
                   "--category", "upper_body", "--limit", "1", *TINY])
    assert sorted(os.listdir(out)) == ["000000_0.jpg", "000001_0.jpg"]


def test_infer_cli_refuses_checkpoints_and_a_missing_card(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        infer.main(["--data_dir", str(tmp_path), "--pretrained",
                    str(tmp_path), *TINY])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            infer.load_models(infer.parse_args(
                ["--data_dir", str(tmp_path), "--tiny"]), torch.float32)
    args = infer.parse_args(["--data_dir", "d"])
    assert args.device == "cuda" and args.num_inference_steps == 30
