"""The port's demo server (``cli/demo.py``) against the JAX package's, on
the CPU.

Both services are the tiny ones (``--tiny``: the tiny try-on stack, fp32,
the tiny DensePose config); the port's takes JAX's parameter trees (the
try-on stack with random biases and norm affines, the three preprocessing
nets perturbed as in ``test_torch_preprocess.py``). ``TryonService.tryon``
runs on both with the same photos, both mask branches (the auto mask with
the 3:4 auto-crop, a drawn mask), ``steps=2``, and the same injected
noises with posterior-mode VAE encodes (each service's generator draws
differently). JAX runs its DensePose and try-on op by op
(``jax.disable_jit``, cheaper than compiling them) and its OpenPose and
SCHP nets jitted, as its service does.

What is compared: every tensor the try-on receives (the person, the mask
from OpenPose + SCHP + ``get_mask_location`` or the drawn layer, the
DensePose image, the garment, its CLIP pixels, the token ids), the
generated float images, the masked-gray preview and the returned images.
Tolerances: fp32 on both sides, the same formulas, other summation orders:
1e-4 relative on the inputs (the mask and the DensePose image are
discrete: any flip shows as a step of 1 / 127.5 or more), 1e-5 on the
CLIP pixels' resize (``test_torch_cli.py``), 2e-4 on the images after the
decode (``test_torch_generate.py``); the uint8 images within one level
(their rounding can flip on a 2e-4 difference), the preview equal.

The HTTP layer: the port's handler on a real ``ThreadingHTTPServer`` on
port 0 (multipart POST with a drawn layer taking precedence over a mask
file, JSON / PNG / HTML outputs, the page, the galleries and their 404s).
"""

import argparse
import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from idmvton_tpu.cli import demo as jdemo
from idmvton_tpu_torch.cli import demo as tdemo
from idmvton_tpu_torch.weights.from_jax import (
    load_jax_params, load_module_params, load_preprocess_params,
)
from test_torch_affine import params_for
from test_torch_preprocess import _close, _np_tree, _perturb

STEPS = 2
AUTO_SIZE = (160, 120)   # a 4:3 photo: the 3:4 auto-crop cuts its width


def _args(**kw):
    d = dict(width=48, height=64, pretrained=None, tokenizer_dir=None,
             tiny=True, examples_dir=None)
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service, the JAX try-on tree the generation
    runs on): the port's nets and stack filled from JAX's trees."""
    jsvc = jdemo.TryonService(_args())
    tsvc = tdemo.TryonService(_args(device="cpu"))
    pre = {"openpose": _perturb(_np_tree(jsvc.openpose.params), 20),
           "atr": _perturb(_np_tree(jsvc.parsing.atr), 21),
           "lip": _perturb(_np_tree(jsvc.parsing.lip), 22),
           "densepose": _perturb(_np_tree(jsvc.densepose.params), 23)}
    # the stem scaled to mean-subtracted pixels, so the random box head
    # detects (test_torch_preprocess.py's densepose_pair)
    stem = pre["densepose"]["backbone"]["stem"]["conv"]
    stem["kernel"] = stem["kernel"] / np.float32(50.0)
    j = lambda t: jax.tree.map(jnp.asarray, t)
    jsvc.openpose.params = j(pre["openpose"])
    jsvc.parsing.atr, jsvc.parsing.lip = j(pre["atr"]), j(pre["lip"])
    jsvc.densepose.params = j(pre["densepose"])
    load_preprocess_params(tsvc.openpose, tsvc.parsing, tsvc.densepose, pre)
    stack = params_for("random_affine", jsvc.models.params(), 24)
    load_jax_params(tsvc.models, stack)
    # the random ATR net labels the auto-mask photo with a few classes,
    # none a garment's: its most frequent class and upper_clothes (4) swap
    # their output channels, so the mask has a garment to cover
    small = np.asarray(tdemo.TryonService.auto_crop_3_4(
        _imgs(0, AUTO_SIZE)[0])[0].resize((384, 512)))
    labels, counts = np.unique(tsvc.parsing.labels(small),
                               return_counts=True)
    top = int(labels[np.argmax(counts)])
    out = pre["atr"]["fusion"]["out"]
    for k in ("kernel", "bias"):
        out[k] = np.array(out[k])
        out[k][..., [top, 4]] = out[k][..., [4, top]]
    jsvc.parsing.atr = j(pre["atr"])
    load_module_params(tsvc.parsing.atr, pre["atr"])
    # JAX's DensePose and try-on op by op: cheaper than compiling them
    jsvc.densepose._apply = _eager(jsvc.densepose._apply)
    return jsvc, tsvc, j(stack)


def _eager(fn):
    def call(*args, **kw):
        with jax.disable_jit():
            return fn(*args, **kw)
    return call


def _imgs(seed=0, size=(96, 128)):
    rng = np.random.default_rng(seed)
    w, h = size
    person = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
    garment = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
    return person, garment


def _noises():
    rng = np.random.default_rng(25)
    lat = (1, 8, 6, 4)
    return (rng.standard_normal(lat).astype(np.float32),
            rng.standard_normal((STEPS,) + lat).astype(np.float32))


def _recording_gens(monkeypatch, jsvc, tsvc, jparams):
    """Both services' ``_gen`` with the injected noises and posterior-mode
    encodes, recording the inputs and the float images."""
    init, step = _noises()
    rec = {"jax": {}, "torch": {}}

    def jgen(steps):
        fn = jsvc.pipe.jit_generate(num_steps=steps, guidance_scale=2.0,
                                    vae_sample=False)

        def call(params, key, **inputs):
            out = _eager(fn)(jparams, key, init_noise=jnp.asarray(init),
                             step_noise=jnp.asarray(step), **inputs)
            rec["jax"].update(inputs=inputs, images=np.asarray(out))
            return out
        return call

    def tgen(steps):
        fn = tsvc.pipe.jit_generate(num_steps=steps, guidance_scale=2.0,
                                    vae_sample=False)

        def call(generator, **inputs):
            out = fn(generator, init_noise=torch.from_numpy(init),
                     step_noise=torch.from_numpy(step), **inputs)
            rec["torch"].update(inputs=inputs, images=out.numpy())
            return out
        return call

    monkeypatch.setattr(jsvc, "_gen", jgen)
    monkeypatch.setattr(tsvc, "_gen", tgen)
    return rec


def _assert_same_request(rec, got, want):
    ti, ji = rec["torch"]["inputs"], rec["jax"]["inputs"]
    assert set(ti) == set(ji)
    for k in ji:
        if "ids" in k:
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]))
        else:
            _close(ti[k], ji[k], 1e-5 if k == "ip_pixels" else 1e-4)
    _close(rec["torch"]["images"], rec["jax"]["images"], 2e-4)
    for g, w in zip(got, want):
        assert g.size == w.size and g.mode == w.mode
    diff = np.abs(np.asarray(got[0], np.int16) - np.asarray(want[0],
                                                             np.int16))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_tryon_auto_mask_auto_crop_matches_jax(services, monkeypatch):
    """The auto mask (OpenPose, SCHP ATR + LIP, get_mask_location) on a
    4:3 photo with the 3:4 auto-crop: the result pasted back into the
    uncropped photo."""
    jsvc, tsvc, jparams = services
    rec = _recording_gens(monkeypatch, jsvc, tsvc, jparams)
    person, garment = _imgs(0, AUTO_SIZE)
    kw = dict(auto_mask=True, auto_crop=True, steps=STEPS, seed=3)
    want = jsvc.tryon(person, garment, "shirt", **kw)
    stages = {}
    got = tsvc.tryon(person, garment, "shirt", stage_seconds=stages, **kw)
    assert got[0].size == (160, 120) and got[1].size == (48, 64)
    _assert_same_request(rec, got, want)
    mask = rec["torch"]["inputs"]["mask"].numpy()
    assert 0 < mask.mean() < 1   # the random nets' mask is not trivial
    assert rec["torch"]["inputs"]["pose"].numpy().std() > 0
    assert list(stages) == ["crop", "openpose", "parsing", "mask",
                            "densepose", "tryon"]


def test_tryon_drawn_mask_matches_jax(services, monkeypatch):
    """A drawn mask layer (any non-black pixel is mask), no crop."""
    jsvc, tsvc, jparams = services
    rec = _recording_gens(monkeypatch, jsvc, tsvc, jparams)
    person, garment = _imgs(1)
    layer = np.zeros((128, 96, 3), np.uint8)
    layer[30:80, 20:70] = 255
    layer[90:100, 10:20, 1] = 1
    kw = dict(auto_mask=False, mask_image=Image.fromarray(layer),
              steps=STEPS, seed=4)
    want = jsvc.tryon(person, garment, "a red dress", **kw)
    got = tsvc.tryon(person, garment, "a red dress", **kw)
    assert got[0].size == (48, 64)
    _assert_same_request(rec, got, want)
    mg = np.asarray(got[1])
    assert np.abs(mg[20:38, 12:32].astype(int) - 127).max() <= 1


@pytest.mark.parametrize("size", [(1000, 1000), (2000, 1000), (600, 1000),
                                  (301, 97)])
def test_auto_crop_3_4_matches_jax(size):
    img = Image.fromarray(np.random.default_rng(5).integers(
        0, 255, size[::-1] + (3,), np.uint8))
    crop, box = tdemo.TryonService.auto_crop_3_4(img)
    want_crop, want_box = jdemo.TryonService.auto_crop_3_4(img)
    assert box == want_box
    np.testing.assert_array_equal(np.asarray(crop), np.asarray(want_crop))


def _serve(svc):
    server = ThreadingHTTPServer(("127.0.0.1", 0), tdemo.make_handler(svc))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _png(im):
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _multipart(fields):
    boundary = "XBOUNDARYX"
    parts = []
    for name, payload, is_file in fields:
        head = (f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="{name}"'
                + (f'; filename="{name}.png"\r\nContent-Type: image/png'
                   if is_file else "") + "\r\n\r\n").encode()
        parts.append(head + payload + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("fmt", ["json", "png", "html"])
def test_http_drawn_mask_end_to_end(services, fmt):
    """A multipart POST with a mask file and a canvas-drawn mask_data
    layer: the drawn layer wins (the preview is mid-gray inside it and the
    person outside, where the all-white decoy file would be gray too)."""
    tsvc = services[1]
    server, port = _serve(tsvc)
    try:
        person, garment = _imgs(2)
        layer = np.zeros((128, 96, 3), np.uint8)
        layer[40:90, 24:72] = 255
        decoy = np.full((128, 96, 3), 255, np.uint8)
        mask_data = (b"data:image/png;base64,"
                     + base64.b64encode(_png(Image.fromarray(layer))))
        body, ctype = _multipart([
            ("person", _png(person), True), ("garment", _png(garment), True),
            ("mask", _png(Image.fromarray(decoy)), True),
            ("mask_data", mask_data, False), ("desc", b"shirt", False),
            ("steps", str(STEPS).encode(), False), ("seed", b"7", False),
            ("format", fmt.encode(), False)])
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tryon",
                                     data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.status == 200
            data = resp.read()
        if fmt == "png":
            assert Image.open(io.BytesIO(data)).size == (48, 64)
            return
        if fmt == "html":
            page = data.decode()
            assert page.count("data:image/png;base64,") == 2
            return
        payload = json.loads(data)
        result = Image.open(io.BytesIO(base64.b64decode(payload["result"])))
        masked = Image.open(io.BytesIO(base64.b64decode(payload["masked"])))
        assert result.size == (48, 64) and masked.size == (48, 64)
        mg = np.asarray(masked)
        assert np.abs(mg[25:40, 15:30].astype(int) - 127).max() <= 1
        assert np.abs(mg[:8, :8].astype(int) - 127).max() > 1
    finally:
        server.shutdown()


def test_http_errors_are_json(services):
    """A POST without the photos answers 500 with the error as JSON."""
    server, port = _serve(services[1])
    try:
        body, ctype = _multipart([("desc", b"shirt", False)])
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tryon",
                                     data=body,
                                     headers={"Content-Type": ctype})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500
        assert "person" in json.loads(e.value.read())["error"]
    finally:
        server.shutdown()


def test_page_and_galleries(services, tmp_path, monkeypatch):
    """The page without galleries, then with them: thumbs percent-encoded,
    /example/<kind>/<name> served, unknown names and traversal 404; an
    empty cloth/ falls through to garment/ (JAX's discovery)."""
    tsvc = services[1]
    server, port = _serve(tsvc)
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(url + "/", timeout=60) as resp:
            page = resp.read().decode()
        assert "virtual try-on" in page
        assert "example" not in page.split("<script>")[0].split("</form>")[1]
        (tmp_path / "human").mkdir()
        (tmp_path / "cloth").mkdir()
        (tmp_path / "garment").mkdir()
        blank = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
        blank.save(tmp_path / "human" / "p1.jpg")
        blank.save(tmp_path / "garment" / "blue shirt.png")
        found = tdemo.TryonService._discover_examples(str(tmp_path))
        assert found == jdemo.TryonService._discover_examples(str(tmp_path))
        assert found["cloth"] == (str(tmp_path / "garment"),
                                  ["blue shirt.png"])
        monkeypatch.setattr(tsvc, "examples", found)
        with urllib.request.urlopen(url + "/", timeout=60) as resp:
            page = resp.read().decode()
        assert "/example/human/p1.jpg" in page
        assert "/example/cloth/blue%20shirt.png" in page
        with urllib.request.urlopen(url + "/example/cloth/blue%20shirt.png",
                                    timeout=60) as resp:
            assert Image.open(io.BytesIO(resp.read())).size == (8, 8)
        for bad in ("/example/cloth/nope.png", "/example/x/y",
                    "/example/cloth/..%2F..%2Fetc%2Fpasswd"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + bad, timeout=60)
            assert e.value.code == 404
    finally:
        server.shutdown()


def test_service_runs_on_the_card_unless_asked():
    """Without ``--device`` the service wants the card, and says how to ask
    for the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdemo.TryonService(_args())
