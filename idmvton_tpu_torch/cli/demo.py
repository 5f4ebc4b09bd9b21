"""Interactive try-on demo server of the PyTorch port (reference:
gradio_demo/app.py).

Counterpart of ``idmvton_tpu/cli/demo.py``: a dependency-free HTTP server
(stdlib http.server) with an HTML upload form, implementing the
start_tryon flow: optional 3:4 auto-crop, auto-masking through OpenPose +
SCHP parsing -> ``get_mask_location``, DensePose conditioning, fixed prompt
templates, CFG 2.0 at 768x1024. The same flags, plus ``--device``:

  python -m idmvton_tpu_torch.cli.demo [--port 7860] [--tiny]
      [--pretrained DIR] [--device cuda|cpu]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU: the try-on stack, the three preprocessing nets (fp32, seeded random
weights, as JAX's) and the try-on. On the card the try-on is
``TryonPipeline.stepwise_generate`` (JAX's accelerator branch: the batched
tower calls, then every denoise step replayed from one captured CUDA
graph); on the CPU ``jit_generate`` (JAX's other branch), run eagerly.
``TryonService.tryon`` is the PIL boundary (decode,
convert, crop, resize, paste); ``TryonService.tryon_arrays`` the array
core, uint8 arrays in and out.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import html
import io
import json
import threading
import urllib.parse

import numpy as np
import torch

from idmvton_tpu_torch.utils import profiling

NEGATIVE_PROMPT = "monochrome, lowres, bad anatomy, worst quality, low quality"

_PAGE = """<!doctype html>
<html><head><title>idmvton_tpu_torch try-on</title></head>
<body style="font-family: sans-serif; max-width: 640px; margin: 2em auto;">
<h2>idmvton_tpu_torch — virtual try-on</h2>
<form method="post" action="/tryon" enctype="multipart/form-data">
  <p>Person photo: <input type="file" name="person" id="person" required></p>
  <p>Garment photo: <input type="file" name="garment" id="garment" required></p>
  <p>Mask (white = repaint; used when auto mask is off — the reference's
     hand-drawn mask layer, app.py:156):
     <input type="file" name="mask"></p>
  <p>…or draw it (the reference's ImageEditor brush layer, app.py:244-247;
     takes precedence over an uploaded mask file):</p>
  <p><canvas id="maskcanvas" width="0" height="0"
      style="border:1px solid #999;touch-action:none;cursor:crosshair">
     </canvas></p>
  <p>brush <input type="range" id="brush" min="4" max="80" value="28">
     <button type="button" onclick="clearMask()">clear drawn mask</button></p>
  <input type="hidden" name="mask_data" id="mask_data">
  <p>Garment description: <input type="text" name="desc" value="shirt"></p>
  <p><label><input type="checkbox" name="auto_mask" checked> auto mask</label>
     <label><input type="checkbox" name="auto_crop"> auto crop 3:4</label></p>
  <p>Steps: <input type="number" name="steps" value="30" min="20" max="40">
     Seed: <input type="number" name="seed" value="42"></p>
  <p>Output: <select name="format"><option>html</option><option>json</option>
     <option>png</option></select></p>
  <p><input type="submit" value="Try on"></p>
</form>
{galleries}
<script>
async function pick(kind, enc) {{
  // enc is the percent-encoded filename straight from the thumb URL
  const r = await fetch('/example/' + kind + '/' + enc);
  const blob = await r.blob();
  const dt = new DataTransfer();
  dt.items.add(new File([blob], decodeURIComponent(enc),
                        {{type: blob.type}}));
  document.getElementById(kind === 'human' ? 'person' : 'garment')
          .files = dt.files;
  if (kind === 'human') loadCanvas(blob);
}}

// --- drawable mask layer (reference gradio ImageEditor, app.py:244-247:
// brush strokes over the person image; any non-black pixel of the layer
// becomes mask via pil_to_binary_mask, app.py:31-42) ---------------------
const cv = document.getElementById('maskcanvas'), cx = cv.getContext('2d');
let img = null, strokes = null, sx = null, drawing = false, drawn = false;

function loadCanvas(blob) {{
  img = new Image();
  img.onload = () => {{
    const w = 384, h = Math.round(w * img.height / img.width);
    cv.width = w; cv.height = h;
    strokes = document.createElement('canvas');   // mask-only layer
    strokes.width = w; strokes.height = h;
    sx = strokes.getContext('2d');
    sx.fillStyle = 'black'; sx.fillRect(0, 0, w, h);
    drawn = false; redraw();
  }};
  img.src = URL.createObjectURL(blob);
}}
function redraw() {{
  cx.drawImage(img, 0, 0, cv.width, cv.height);
  cx.globalAlpha = 0.55; cx.drawImage(strokes, 0, 0); cx.globalAlpha = 1;
}}
function dab(e) {{
  const r = cv.getBoundingClientRect();
  const x = (e.clientX - r.left) * cv.width / r.width;
  const y = (e.clientY - r.top) * cv.height / r.height;
  sx.fillStyle = 'white'; sx.beginPath();
  sx.arc(x, y, +document.getElementById('brush').value / 2, 0, 7);
  sx.fill(); drawn = true; redraw();
}}
cv.addEventListener('pointerdown', e => {{
  if (!img) return; drawing = true; cv.setPointerCapture(e.pointerId);
  dab(e);
}});
cv.addEventListener('pointermove', e => {{ if (drawing) dab(e); }});
cv.addEventListener('pointerup', () => {{ drawing = false; }});
function clearMask() {{
  if (!sx) return;
  sx.fillStyle = 'black'; sx.fillRect(0, 0, cv.width, cv.height);
  drawn = false; redraw();
}}
document.getElementById('person').addEventListener('change', e => {{
  if (e.target.files[0]) loadCanvas(e.target.files[0]);
}});
document.querySelector('form').addEventListener('submit', () => {{
  document.getElementById('mask_data').value =
      drawn ? strokes.toDataURL('image/png') : '';
}});
</script>
</body></html>"""

_GALLERY = """<h3>example {title}</h3><p>
{thumbs}
</p>"""

# {enc} = urllib.parse.quote(name, safe="") — quoting covers spaces/%/#/
# non-ASCII in the URL and leaves only [A-Za-z0-9_.~%-], which is also safe
# inside the single-quoted onclick JS string
_THUMB = ('<img src="/example/{kind}/{enc}" width="72" '
          'style="cursor:pointer;margin:2px" title="{title}" '
          'onclick="pick(\'{kind}\', \'{enc}\')">')

_RESULT_PAGE = """<!doctype html>
<html><head><title>idmvton_tpu_torch try-on result</title></head>
<body style="font-family: sans-serif; max-width: 960px; margin: 2em auto;">
<h2>result</h2><img src="data:image/png;base64,{result}" width="384">
<h2>masked preview</h2><img src="data:image/png;base64,{masked}" width="384">
<p><a href="/">back</a></p></body></html>"""


class TryonService:
    """Holds the models and the serving programs; single-flight. ``models``
    (a ``TryonModels``) serves an existing stack instead of building one
    from ``args``.

    All of a request's card work -- the auto mask's OpenPose and SCHP, the
    DensePose R-CNN and the generation -- runs under one re-entrant lock
    (``lock``), as do ``auto_mask`` and ``pose_image`` called alone. A
    first request of a graph key captures its step as a CUDA graph
    (``pipeline/graph.py``) in ``capture_error_mode="global"``, which
    forbids another thread's allocations while it is open, and counts the
    capture's launches from the process-wide counters: a second request's
    preprocessing beside it would break the capture or have its launches
    replayed with every step. JAX's demo locks only the generation; it has
    no capture to break."""

    def __init__(self, args, *, models=None):
        from idmvton_tpu_torch.data.tokenizer import load_tokenizers
        from idmvton_tpu_torch.pipeline.tryon import (
            TryonModels, TryonPipeline,
        )
        from idmvton_tpu_torch.preprocess.densepose.visualize import (
            DensePose,
        )
        from idmvton_tpu_torch.preprocess.openpose import OpenPose
        from idmvton_tpu_torch.preprocess.schp import Parsing

        self.args = args
        device = torch.device(getattr(args, "device", None) or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA card is visible; pass "
                               "--device cpu to run on the CPU")
        self.device = device
        self.size = (args.width, args.height)
        if models is None:
            dtype = torch.float32 if args.tiny else torch.bfloat16
            if args.pretrained:
                from idmvton_tpu_torch.weights.checkpoint import (
                    load_pipeline,
                )
                models = load_pipeline(args.pretrained, dtype, device=device)
            else:
                models = TryonModels.init(0, tiny=args.tiny, device=device,
                                          dtype=dtype)
        self.models = models
        self.dtype = next(models.unet.parameters()).dtype
        self.pipe = TryonPipeline(models)
        self.tok1, self.tok2 = load_tokenizers(args.tokenizer_dir,
                                               args.tokenizer_dir)
        self.openpose = OpenPose(device=device)
        self.parsing = Parsing(device=device)
        if args.tiny:
            # tiny serving mode: the same DensePose code path (resize, BGR
            # mean, R-CNN, painting) at toy capacity
            from idmvton_tpu_torch.preprocess.densepose.rcnn import (
                DensePoseConfig,
            )
            self.densepose = DensePose(
                cfg=DensePoseConfig(rpn_pre_nms_topk=50, rpn_post_nms_topk=20,
                                    num_detections=4, dp_chunk=2),
                short_edge=64, max_size=96, device=device)
        else:
            self.densepose = DensePose(device=device)
        self.lock = threading.RLock()
        self._gens = {}
        self.examples = self._discover_examples(
            getattr(args, "examples_dir", None))

    @staticmethod
    def _discover_examples(root) -> dict:
        """Example galleries (the reference builds them from
        gradio_demo/example/{human,cloth}). Expects <root>/human and
        <root>/cloth (or garment/) image dirs; empty dict when absent."""
        import os
        out = {}
        if not root:
            return out
        for kind, names in (("human", ("human",)),
                            ("cloth", ("cloth", "garment"))):
            for n in names:
                d = os.path.join(root, n)
                if os.path.isdir(d):
                    files = sorted(
                        f for f in os.listdir(d)
                        if f.lower().endswith((".jpg", ".jpeg", ".png")))
                    if files:
                        out[kind] = (d, files)
                        break  # an empty cloth/ still falls through to
                               # garment/: only a populated dir settles it
        return out

    def _gen(self, steps: int):
        """The try-on program of ``steps`` steps, JAX's choice: on the
        accelerator ``stepwise_generate`` (the three prompts in one pass of
        each text tower and both IP images in one vision pass, then the
        replayed steps), elsewhere ``jit_generate``. The same math and the
        same draws in the same order; the batched passes launch a third of
        the text towers' kernels and half of the vision tower's, launches
        the card would otherwise wait on."""
        if steps not in self._gens:
            make = (self.pipe.stepwise_generate
                    if self.device.type == "cuda"
                    else self.pipe.jit_generate)
            self._gens[steps] = make(num_steps=steps, guidance_scale=2.0)
        return self._gens[steps]

    @staticmethod
    def auto_crop_3_4(img):
        """3:4 center crop of BOTH dims (the reference's app.py:136-145).
        Returns (crop, box)."""
        w, h = img.size
        target_w = int(min(w, h * 3 / 4))
        target_h = int(min(h, w * 4 / 3))
        left = (w - target_w) // 2
        top = (h - target_h) // 2
        box = (left, top, left + target_w, top + target_h)
        return img.crop(box), box

    def tryon(self, person, garment, desc: str, *, auto_mask: bool = True,
              auto_crop: bool = False, mask_image=None, steps: int = 30,
              seed: int = 42, stage_seconds=None):
        """PIL person and garment photos -> (result PIL image, masked-gray
        preview PIL image). The PIL half: convert, the optional 3:4 crop,
        the resizes JAX's service makes with PIL (person and garment to the
        service's size, the person to 384x512 for the auto mask, a drawn
        mask layer to the size), CLIP's preprocess of the garment; then
        ``tryon_arrays``; then the crop pasted back. ``stage_seconds``, when
        given, receives each stage's seconds (crop, openpose, parsing,
        mask, densepose, tryon), each stage ending in a device synchronize.
        A request is the span ``demo.request`` (``utils.profiling``), each
        of its stages the span ``demo.<stage>``."""
        from PIL import Image

        from idmvton_tpu_torch.data.image import clip_preprocess

        with profiling.span("demo.request"):
            with self._stage("crop", stage_seconds):
                person = person.convert("RGB")
                garment = garment.convert("RGB")
                crop_box = None
                original = person
                if auto_crop:
                    person, crop_box = self.auto_crop_3_4(person)
                w, h = self.size
                person_resized = np.asarray(person.resize((w, h),
                                                          Image.BICUBIC))
                small = manual = None
                if auto_mask or mask_image is None:
                    small = np.asarray(person.resize((384, 512)))
                else:
                    # hand-drawn layer: any non-black pixel is mask (the
                    # reference's pil_to_binary_mask, threshold 0)
                    manual = np.asarray(mask_image.convert("RGB").resize(
                        (w, h)).convert("L")) > 0
                cloth = np.asarray(garment.resize((w, h), Image.BICUBIC))
                ip = clip_preprocess(garment)
            out, mask_gray = self.tryon_arrays(
                person_resized, cloth, ip, desc, small=small, mask=manual,
                steps=steps, seed=seed, stage_seconds=stage_seconds)
            out, mask_gray = Image.fromarray(out), Image.fromarray(mask_gray)
            if crop_box is not None:
                out = out.resize((crop_box[2] - crop_box[0],
                                  crop_box[3] - crop_box[1]))
                full = original.copy()
                full.paste(out, (crop_box[0], crop_box[1]))
                return full, mask_gray
            return out, mask_gray

    def _stage(self, name: str, stage_seconds):
        """The span ``demo.<name>``; with a ``stage_seconds`` dict it ends
        in a device synchronize and its seconds go into the dict."""
        return profiling.timed(f"demo.{name}", stage_seconds, name,
                               self.device)

    def auto_mask(self, small: np.ndarray) -> np.ndarray:
        """The auto mask of a (512, 384, 3) uint8 person: OpenPose
        keypoints, SCHP labels, ``get_mask_location("hd", "upper_body")``;
        returns it as a (512, 384) uint8 array of 0 / 255."""
        with self.lock:
            keypoints = self.openpose(small)
            parse = self.parsing.labels(small)
        return _mask_of(keypoints, parse)

    def pose_image(self, person: np.ndarray) -> np.ndarray:
        """DensePose's painted pose image of a (H, W, 3) uint8 person at
        the service's size."""
        with self.lock:
            return self.densepose(person)

    def tryon_arrays(self, person: np.ndarray, cloth: np.ndarray,
                     ip: np.ndarray, desc: str, *, small=None, mask=None,
                     steps: int = 30, seed: int = 42, stage_seconds=None):
        """The array core. person, cloth: (H, W, 3) uint8 at the service's
        size; ip: the garment's (224, 224, 3) CLIP-normalized pixels;
        ``mask`` (H, W) bool, the drawn layer, or None for the auto mask
        from ``small``, the (512, 384, 3) uint8 person. Returns (result,
        masked-gray preview), (H, W, 3) uint8 each. ``stage_seconds``:
        ``tryon``'s. The whole request runs under ``lock``; the wait for it
        counts in the request's first stage (openpose, or densepose with a
        drawn mask)."""
        from PIL import Image

        from idmvton_tpu_torch.data.image import (
            denormalize_to_uint8, load_mask,
        )

        w, h = self.size
        drawn = mask is not None
        with contextlib.ExitStack() as hold:
            if not drawn:
                with self._stage("openpose", stage_seconds):
                    hold.enter_context(self.lock)
                    keypoints = self.openpose(small)
                with self._stage("parsing", stage_seconds):
                    parse = self.parsing.labels(small)
                with self._stage("mask", stage_seconds), \
                        profiling.span("mask.build"):
                    mask = load_mask(
                        Image.fromarray(_mask_of(keypoints, parse)), (w, h))
            with self._stage("densepose", stage_seconds):
                hold.enter_context(self.lock)       # re-entrant
                if drawn:
                    mask = np.asarray(mask, np.float32)[..., None]
                # masked-gray preview ((1 - mask) * normalized person, shown
                # as (x + 1) / 2), returned beside the result
                person_pm1 = person.astype(np.float32) / 255.0 * 2.0 - 1.0
                mask_gray = denormalize_to_uint8(
                    ((1.0 - mask) * person_pm1)[None])[0]
                pose_rgb = self.densepose(person)
            with self._stage("tryon", stage_seconds):
                return self._try_on(person_pm1, mask, pose_rgb, cloth, ip,
                                    desc, steps, seed), mask_gray

    def _try_on(self, person_pm1, mask, pose_rgb, cloth, ip, desc, steps,
                seed):
        """The try-on of the prepared arrays: the result, (H, W, 3) uint8."""
        from idmvton_tpu_torch.cli.infer import resize_ip_pixels
        from idmvton_tpu_torch.data.image import denormalize_to_uint8

        caption = "model is wearing " + desc
        caption_cloth = "a photo of " + desc
        dev, dtype = self.device, self.dtype

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)

        def ids(tok, text):
            return torch.from_numpy(np.asarray(tok([text]))).to(dev).long()

        ip_t = tensor(ip.astype(np.float32))
        isz = self.models.vision_cfg.image_size
        if ip_t.shape[1] != isz:
            ip_t = resize_ip_pixels(ip_t, isz)
        inputs = dict(
            person=tensor(person_pm1).to(dtype),
            mask=tensor(mask).to(dtype),
            pose=tensor(pose_rgb.astype(np.float32) / 127.5 - 1).to(dtype),
            cloth=tensor(cloth.astype(np.float32) / 255.0 * 2.0
                         - 1.0).to(dtype),
            ip_pixels=ip_t.to(dtype),
            prompt_ids_l=ids(self.tok1, caption),
            prompt_ids_g=ids(self.tok2, caption),
            neg_ids_l=ids(self.tok1, NEGATIVE_PROMPT),
            neg_ids_g=ids(self.tok2, NEGATIVE_PROMPT),
            cloth_ids_l=ids(self.tok1, caption_cloth),
            cloth_ids_g=ids(self.tok2, caption_cloth),
        )
        generator = torch.Generator(device=dev).manual_seed(seed)
        images = self._gen(steps)(generator, **inputs)
        return denormalize_to_uint8(images.float().cpu().numpy())[0]


def _mask_of(keypoints, parse) -> np.ndarray:
    """``get_mask_location("hd", "upper_body")`` of OpenPose's keypoints
    and SCHP's labels, a (512, 384) uint8 array of 0 / 255."""
    from idmvton_tpu_torch.preprocess.agnostic_mask import get_mask_location
    mask_pil, _ = get_mask_location("hd", "upper_body", parse, keypoints)
    return np.asarray(mask_pil)


def make_handler(service: TryonService):
    """The HTTP handler class of ``service`` (JAX's): GET / the page and
    its galleries, GET /example/<kind>/<name>, POST /tryon (multipart)."""
    from http.server import BaseHTTPRequestHandler

    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/example/"):
                return self._serve_example()
            galleries = "".join(
                _GALLERY.format(
                    title="people" if kind == "human" else "garments",
                    thumbs="".join(
                        _THUMB.format(kind=kind,
                                      enc=urllib.parse.quote(n, safe=""),
                                      title=html.escape(n, quote=True))
                        for n in files))
                for kind, (_, files) in service.examples.items())
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.format(galleries=galleries).encode())

        def _serve_example(self):
            import os
            parts = self.path.split("/")  # ['', 'example', kind, enc-name]
            if len(parts) != 4 or parts[2] not in service.examples:
                self.send_response(404)
                self.end_headers()
                return
            d, files = service.examples[parts[2]]
            # browsers request the percent-encoded thumb URL; decode before
            # matching against the on-disk names
            name = os.path.basename(urllib.parse.unquote(parts[3]))
            if name not in files:  # also rejects any path traversal
                self.send_response(404)
                self.end_headers()
                return
            with open(os.path.join(d, name), "rb") as f:
                data = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "image/png"
                             if name.lower().endswith(".png") else "image/jpeg")
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            from email.parser import BytesParser
            from email.policy import default as email_default
            length = int(self.headers["Content-Length"])
            ctype = self.headers["Content-Type"]
            body = (b"Content-Type: " + ctype.encode() + b"\r\n\r\n"
                    + self.rfile.read(length))
            msg = BytesParser(policy=email_default).parsebytes(body)
            fields = {}
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                payload = part.get_payload(decode=True)
                fields[name] = payload
            try:
                person = Image.open(io.BytesIO(fields["person"]))
                garment = Image.open(io.BytesIO(fields["garment"]))
                mask_image = (Image.open(io.BytesIO(fields["mask"]))
                              if fields.get("mask") else None)
                # canvas-drawn layer (data:image/png;base64,...) takes
                # precedence over an uploaded mask file, like the reference
                # editor layer over the base image (app.py:156)
                md = (fields.get("mask_data") or b"").decode().strip()
                if md.startswith("data:image/"):
                    mask_image = Image.open(io.BytesIO(
                        base64.b64decode(md.split(",", 1)[1])))
                desc = (fields.get("desc") or b"shirt").decode()
                fmt = (fields.get("format") or b"html").decode()
                out, mask_gray = service.tryon(
                    person, garment, desc,
                    auto_mask="auto_mask" in fields,
                    auto_crop="auto_crop" in fields,
                    mask_image=mask_image,
                    steps=int(fields.get("steps", b"30")),
                    seed=int(fields.get("seed", b"42")))

                def png(im):
                    buf = io.BytesIO()
                    im.save(buf, "PNG")
                    return buf.getvalue()

                self.send_response(200)
                if fmt == "png":
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(png(out))
                elif fmt == "json":
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps({
                        "result": base64.b64encode(png(out)).decode(),
                        "masked": base64.b64encode(png(mask_gray)).decode(),
                    }).encode())
                else:  # result + masked-gray preview (app.py:239-241)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_RESULT_PAGE.format(
                        result=base64.b64encode(png(out)).decode(),
                        masked=base64.b64encode(png(mask_gray)).decode(),
                    ).encode())
            except Exception as e:  # surface errors to the browser
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"error": str(e)}).encode())

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="idmvton_tpu_torch try-on demo server")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--examples_dir", default=None,
                   help="dir with human/ and cloth/ example images shown as "
                        "clickable galleries")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    service = TryonService(args)
    from http.server import ThreadingHTTPServer
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(service))
    print(f"serving on http://0.0.0.0:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
