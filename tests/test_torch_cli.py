"""The port's inference CLI and its data modules against the JAX package's,
on the CPU.

The port keeps its own copies of ``idmvton_tpu/data/*`` (it imports nothing
of the JAX package); on the synthetic VITON-HD and DressCode trees of
tests/test_data_cli.py and tests/test_dresscode.py every sample, batch,
token id and augmentation is held bit for bit against the JAX package's.
The ``ip_pixels`` resize is held against ``jax.image.resize(...,
"bilinear")``; the CLIs run end to end with ``--tiny --device cpu``, and
on a diffusers tree JAX wrote (``--pretrained TREE --diffusers``) to the
images of the same parameters carried over by ``load_jax_params``.
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


def write_clip_vocab(d):
    """A small CLIP BPE vocabulary (vocab.json, merges.txt) in ``d``;
    returns their paths."""
    import json
    os.makedirs(d, exist_ok=True)
    vocab = {}
    for ch in ttok._bytes_to_unicode().values():
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for tok in ("he", "hello</w>", "<|startoftext|>", "<|endoftext|>"):
        vocab[tok] = len(vocab)
    vp, mp = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version\nh e\nhe llo</w>\nl l\nll o</w>\n")
    return vp, mp


def test_tokenizers_and_image_helpers_match_jax(tmp_path):
    texts = ["model is wearing t shirts long ", "a photo of a red shirt", ""]
    for pad in (None, 0):
        kw = {} if pad is None else {"pad_token_id": pad}
        np.testing.assert_array_equal(ttok.HashTokenizer(**kw)(texts),
                                      jtok.HashTokenizer(**kw)(texts))
    assert ttok._bytes_to_unicode() == jtok._bytes_to_unicode()
    vp, mp = write_clip_vocab(str(tmp_path))
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


def _images(d):
    return {n: np.asarray(Image.open(os.path.join(d, n)))
            for n in sorted(os.listdir(d))}


def test_infer_cli_diffusers_tree_matches_jax_params(tmp_path, monkeypatch):
    """``--pretrained TREE --diffusers --device cpu`` on a tree JAX's
    save_diffusers wrote (random biases and norm affines) writes the images
    the CLI writes from ``load_jax_params`` of the same parameters, bit for
    bit."""
    from idmvton_tpu.pipeline import tryon as jtryon
    from idmvton_tpu.weights.checkpoint import save_diffusers
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.weights.from_jax import load_jax_params
    from test_torch_affine import random_affine
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    tree = random_affine(jax.tree.map(np.asarray, jm.params()), 13)
    jm = jtryon.TryonModels(**{f: getattr(jm, f) for f in (
        "unet_cfg", "garm_cfg", "vae_cfg", "clip_l_cfg", "clip_g_cfg",
        "vision_cfg", "resampler_cfg")}, **jax.tree.map(jnp.asarray, tree))
    ckpt = str(tmp_path / "tree")
    save_diffusers(ckpt, jm)
    root = str(tmp_path / "data")
    make_viton_tree(root, n=2)
    run = ["--data_dir", root, "--unpaired", *TINY]
    infer.main(run + ["--output_dir", str(tmp_path / "loaded"),
                      "--pretrained", ckpt, "--diffusers"])
    monkeypatch.setattr(infer, "load_models", lambda args, dtype: (
        load_jax_params(TryonModels.init(None, tiny=True, device="cpu",
                                         dtype=dtype), tree)))
    infer.main(run + ["--output_dir", str(tmp_path / "jax_params")])
    got, want = _images(str(tmp_path / "loaded")), _images(
        str(tmp_path / "jax_params"))
    assert got.keys() == want.keys() and len(got) == 2
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_infer_cli_tokenizer_dir_falls_back_to_tree(tmp_path):
    """With ``--diffusers`` the tokenizers come from the tree's
    tokenizer/ and tokenizer_2/ unless ``--tokenizer_dir`` names another
    directory (JAX's CLI); without it, the hash tokenizer."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    tree = str(tmp_path / "tree")
    vp, mp = write_clip_vocab(os.path.join(tree, "tokenizer"))
    write_clip_vocab(os.path.join(tree, "tokenizer_2"))
    models = TryonModels.init(0, tiny=True, device="cpu", dtype=torch.float32)
    texts = ["hello", "he said hello"]

    def toks(*flags):
        args = infer.parse_args(["--data_dir", "d", "--device", "cpu",
                                 *flags])
        return infer.build(args, models)[1:3]

    tok1, tok2 = toks("--pretrained", tree, "--diffusers")
    assert isinstance(tok1, ttok.CLIPTokenizer)
    assert isinstance(tok2, ttok.CLIPTokenizer)
    np.testing.assert_array_equal(tok1(texts),
                                  ttok.CLIPTokenizer(vp, mp)(texts))
    np.testing.assert_array_equal(
        tok2(texts), ttok.CLIPTokenizer(vp, mp, pad_token_id=0)(texts))
    for flags in (("--pretrained", tree),
                  ("--pretrained", tree, "--diffusers", "--tokenizer_dir",
                   str(tmp_path / "elsewhere"))):
        assert all(isinstance(t, ttok.HashTokenizer) for t in toks(*flags))


def test_infer_cli_pipeline_checkpoint(tmp_path):
    """``--pretrained DIR`` alone loads the port's pipeline checkpoint."""
    from idmvton_tpu_torch.pipeline.tryon import COMPONENTS, TryonModels
    from idmvton_tpu_torch.weights.checkpoint import save_pipeline
    src = TryonModels.init(4, tiny=True, device="cpu", dtype=torch.float32)
    save_pipeline(str(tmp_path), src)
    got = infer.load_models(infer.parse_args(
        ["--data_dir", "d", "--pretrained", str(tmp_path), "--device",
         "cpu"]), torch.float32)
    for name in COMPONENTS:
        want = dict(getattr(src, name).named_parameters())
        for k, p in getattr(got, name).named_parameters():
            assert torch.equal(p, want[k]), (name, k)


def test_infer_cli_refuses_checkpoints_and_a_missing_card(tmp_path):
    """A JAX orbax checkpoint (``params/``) is refused with the bridge
    named; ``--device cuda`` without a card asks for ``--device cpu``."""
    os.makedirs(tmp_path / "params")
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(ValueError, match="save_diffusers"):
        infer.main(["--data_dir", str(tmp_path), "--pretrained",
                    str(tmp_path), *TINY])
    if not torch.cuda.is_available():
        for flags in ((), ("--pretrained", str(tmp_path), "--diffusers")):
            with pytest.raises(RuntimeError, match="--device cpu"):
                infer.load_models(infer.parse_args(
                    ["--data_dir", str(tmp_path), "--tiny", *flags]),
                    torch.float32)
    args = infer.parse_args(["--data_dir", "d"])
    assert args.device == "cuda" and args.num_inference_steps == 30
