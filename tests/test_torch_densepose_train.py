"""The port's DensePose detection trainer (``preprocess/densepose/train.py``)
and ``ops.nms.nms_topk``'s early exit against the JAX package, on the CPU.

The R-CNN runs at the JAX test's small config (``test_densepose_train.py``:
64x64 images, a 2x64 densepose head at heatmap 56) on shared parameters:
the port's seeded init with random biases and frozen-BN affines, exported
to JAX's tree. JAX draws each image's three uniform vectors from
``split(split(rng, B)[i], 3)``; the port takes the same values through
``uniforms=``. JAX's sampled sets are read by wrapping its
``subsample_labels``, ``_select_topk_mask`` and ``nms_topk`` in a jitted
per-image run that returns what they returned.

Tolerances: the matcher, sampler, top-k slab, NMS and the masks equal
(exact: the same comparisons on the same fp32 values); heatmap coordinates
and bilinear samples within 1e-6 (XLA fuses a multiply-add or two); each
loss on its own within 1e-5 relative (fp32, other summation orders); the batch losses
within 1e-4 and every leaf's gradient within 1e-3 of its largest
magnitude (the R-50-FPN forward and backward in another order, 217
leaves); the optimizer within 1e-5 after three steps, frozen leaves equal.

The gt masks are 28x28 at heatmap 56. A pixel of the rasterized gt mask
can be an exact tie: at 16x16 the samples of a proposal that equals its gt
box fall on bilinear midpoints (v = 0.5 in exact arithmetic), and a
degenerate proposal clipped to the image's edge can put its samples on the
gt mask's edge. XLA's fused multiply-adds and the port's separate roundings
break such ties in opposite directions; ``test_mask_in_box`` shows that
every pixel that differs is one. The batch below has none.
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idmvton_tpu.ops import nms as jnms
from idmvton_tpu.preprocess.densepose import rcnn as jrcnn
from idmvton_tpu.preprocess.densepose import train as jt
from idmvton_tpu_torch.ops import nms as tnms
from idmvton_tpu_torch.preprocess.densepose import rcnn as trcnn
from idmvton_tpu_torch.preprocess.densepose import train as tt
from idmvton_tpu_torch.weights.from_jax import load_module_params
from test_torch_preprocess import _perturb
from test_torch_preprocess_extra import module_tree

CFG_KW = dict(rpn_pre_nms_topk=40, rpn_post_nms_topk=16, num_detections=4,
              dp_chunk=2, dp_convs=2, dp_dim=64, heatmap_size=56)
TCFG_KW = dict(rpn_batch_per_image=32, roi_batch_per_image=16, n_dp_train=4)
JCFG, TCFG = jrcnn.DensePoseConfig(**CFG_KW), trcnn.DensePoseConfig(**CFG_KW)
JTC, TTC = jt.DetectionTrainConfig(**TCFG_KW), tt.DetectionTrainConfig(
    **TCFG_KW)
B, G, P, M = 2, 3, 6, 28
N_ANCHORS = (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1) * 3    # 64x64, P2-P6


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-12)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _boxes(n, seed, span=64.0, lo=2.0, hi=24.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, span, (n, 2))
    s = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)


def _gts(seed):
    rng = np.random.default_rng(seed)
    boxes = np.asarray([[4, 4, 28, 40], [30, 10, 56, 50], [8, 30, 40, 62]],
                       np.float32)
    valid = np.ones((B, G), bool)
    valid[1, 2] = False                       # a padded gt row
    return {"boxes": np.stack([boxes, boxes + 2.5]), "valid": valid,
            "dp_x": rng.uniform(6, 40, (B, G, P)).astype(np.float32),
            "dp_y": rng.uniform(6, 50, (B, G, P)).astype(np.float32),
            "dp_i": rng.integers(0, 25, (B, G, P)).astype(np.int32),
            "dp_u": rng.uniform(0, 1, (B, G, P)).astype(np.float32),
            "dp_v": rng.uniform(0, 1, (B, G, P)).astype(np.float32),
            "dp_pt_valid": rng.uniform(0, 1, (B, G, P)) > 0.1,
            "dp_mask": rng.uniform(0, 1, (B, G, M, M)) > 0.4}


@pytest.fixture(scope="module")
def setup():
    """The shared model / tree, a batch, JAX's draws."""
    model = trcnn.init_densepose_rcnn(0, TCFG, device="cpu")
    tree = _perturb(module_tree(model), 31)
    load_module_params(model, tree)
    images = (np.random.default_rng(2).standard_normal((B, 64, 64, 3))
              * 5).astype(np.float32)
    gts = _gts(3)
    key = jax.random.PRNGKey(7)
    n_prop = JCFG.rpn_post_nms_topk + G
    uniforms = []
    for r in jax.random.split(key, B):
        a, b, c = jax.random.split(r, 3)
        uniforms.append([np.asarray(jax.random.uniform(a, (N_ANCHORS,))),
                         np.asarray(jax.random.uniform(b, (n_prop,))),
                         np.asarray(jax.random.uniform(c, (n_prop,)))])
    return dict(model=model, tree=tree, images=images, gts=gts, key=key,
                uniforms=uniforms)


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's batch losses and gradients (jitted), and per image its losses
    and sampled sets (op by op, through recording wrappers)."""
    jtree = jax.tree.map(jnp.asarray, setup["tree"])
    images = jnp.asarray(setup["images"])
    jgts = jax.tree.map(jnp.asarray, setup["gts"])
    key = setup["key"]
    (total, losses), grads = jax.jit(jax.value_and_grad(
        lambda p: jt.detection_total_loss(p, images, jgts, key, JCFG, JTC),
        has_aux=True))(jtree)
    stash = []

    def spy(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            stash.append(out)
            return out
        return run

    def one_image(p, im, g, r):
        # traced once: the wrappers stash their outputs, returned beside
        # the losses (subsample_labels: anchors, then proposals)
        stash.clear()
        out = jt.detection_loss_fn(p, im, g, r, JCFG, JTC)
        return out, list(stash)

    per_image = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("subsample_labels", "_select_topk_mask", "nms_topk"):
            mp.setattr(jt, name, spy(getattr(jt, name)))
        run = jax.jit(one_image)
        for i, r in enumerate(jax.random.split(key, B)):
            out, sets = run(jtree, images[i:i + 1],
                            {k: v[i] for k, v in jgts.items()}, r)
            rpn_w, (_, _, pidx), roi_w, (idx, valid) = jax.tree.map(
                np.asarray, sets)
            per_image.append(dict(
                losses={k: float(v) for k, v in out.items()},
                sets=dict(rpn_w=rpn_w, prop_idx=pidx, roi_w=roi_w,
                          dp_idx=idx, dp_valid=valid)))
    return dict(total=float(total),
                losses={k: float(v) for k, v in losses.items()},
                grads={k: np.asarray(v) for k, v in _flat(grads).items()},
                per_image=per_image)


@pytest.fixture(scope="module")
def port_run(setup):
    model = setup["model"]
    params = tt.detection_params(model)
    for p in params.values():
        p.requires_grad_(True)
    record = []
    total, losses = tt.detection_total_loss(
        model, params, torch.from_numpy(setup["images"]),
        _torch(setup["gts"]), tcfg=TTC, record=record,
        uniforms=[[torch.from_numpy(u) for u in us]
                  for us in setup["uniforms"]])
    # every leaf reaches the loss: no parameter is left without a gradient
    grads = torch.autograd.grad(total, list(params.values()))
    return dict(total=total.detach(),
                losses={k: v.detach() for k, v in losses.items()},
                grads=dict(zip(params, grads)), record=record)


# ---------------------------------------------------------------------------
# utilities, matcher, sampler
# ---------------------------------------------------------------------------


def test_box_utils_match_jax():
    a, b = _boxes(40, 0), _boxes(25, 1)
    b[:3] = a[:3]                          # identical pairs
    b[3] = [10.0, 10.0, 10.0, 30.0]        # zero area
    iou_w = np.asarray(jt.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    iou_g = tt.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(iou_g.numpy(), iou_w)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        assert _rel(tt.get_deltas(torch.from_numpy(a[:25]),
                                  torch.from_numpy(b), w),
                    jt.get_deltas(jnp.asarray(a[:25]), jnp.asarray(b),
                                  w)) <= 1e-6
    x, y = a[:, :2].ravel(), b[:20, 2:].ravel()
    for beta in (0.0, 1.0):
        np.testing.assert_array_equal(
            tt.smooth_l1(torch.from_numpy(x[:40]), torch.from_numpy(y),
                         beta).numpy(),
            np.asarray(jt.smooth_l1(jnp.asarray(x[:40]), jnp.asarray(y),
                                    beta)))


@pytest.mark.parametrize("low_quality", [True, False])
def test_matcher_matches_jax(low_quality):
    """Ties (duplicate gt boxes: the first maximum wins), an invalid gt,
    candidates equal to a gt, and no valid gt at all."""
    cand = _boxes(300, 4)
    gt = _boxes(5, 5)
    gt[3] = gt[1]                          # duplicate: argmax tie
    cand[:2] = gt[:2]
    valid = np.asarray([True, True, True, True, False])
    for v in (valid, np.zeros(5, bool)):
        for lo, hi in ((0.3, 0.7), (0.5, 0.5)):
            kw = dict(low=lo, high=hi, allow_low_quality=low_quality)
            wm, wl = jt.match_boxes(jnp.asarray(cand), jnp.asarray(gt),
                                    jnp.asarray(v), **kw)
            gm, gl = tt.match_boxes(torch.from_numpy(cand),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(v), **kw)
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
            assert gl.dtype == torch.int8


def test_sampler_and_slab_match_jax():
    rng = np.random.default_rng(6)
    for n, num, frac, seed in ((500, 32, 0.5, 0), (60, 16, 0.25, 1),
                               (40, 64, 0.5, 2)):
        labels = rng.choice(np.asarray([-1, 0, 1], np.int8), n,
                            p=[0.2, 0.7, 0.1])
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, (n,)))
        kw = dict(num_samples=num, positive_fraction=frac)
        want = np.asarray(jt.subsample_labels(jnp.asarray(labels), key, **kw))
        got = tt.subsample_labels(torch.from_numpy(labels),
                                  torch.from_numpy(u), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.sum() == min(num, (labels >= 0).sum())
    # the slab: priorities with forced ties, fewer candidates than slots
    for k, density in ((4, 0.3), (8, 0.05)):
        mask = rng.uniform(0, 1, 50) < density
        pri = (np.round(rng.uniform(0, 1, 50) * 3) / 3).astype(np.float32)
        wi, wv = jt._select_topk_mask(jnp.asarray(mask), jnp.asarray(pri), k)
        gi, gv = tt._select_topk_mask(torch.from_numpy(mask),
                                      torch.from_numpy(pri), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# the losses, each on its own
# ---------------------------------------------------------------------------


def test_rpn_and_box_head_losses_match_jax():
    rng = np.random.default_rng(7)
    anchors = _boxes(400, 8)
    gt = _boxes(3, 9)
    valid = np.asarray([True, True, False])
    obj = rng.standard_normal(400).astype(np.float32) * 3
    deltas = rng.standard_normal((400, 4)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (400,)))
    want = jt.rpn_losses(jnp.asarray(anchors), jnp.asarray(obj),
                         jnp.asarray(deltas), jnp.asarray(gt),
                         jnp.asarray(valid), key, JTC)
    rec = {}
    got = tt.rpn_losses(torch.from_numpy(anchors), torch.from_numpy(obj),
                        torch.from_numpy(deltas), torch.from_numpy(gt),
                        torch.from_numpy(valid), torch.from_numpy(u), TTC,
                        rec)
    assert rec["rpn_w"].sum() > 0
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k

    n = 60
    prop = _boxes(n, 10)
    matched_gt = _boxes(n, 11)
    fg = rng.uniform(0, 1, n) < 0.3
    sample_w = (rng.uniform(0, 1, n) < 0.7).astype(np.float32)
    cls = rng.standard_normal((n, 2)).astype(np.float32)
    reg = rng.standard_normal((n, 4)).astype(np.float32) * 0.2
    want = jt.box_head_losses(*map(jnp.asarray, (cls, reg, prop, matched_gt,
                                                 fg, sample_w)), JCFG)
    got = tt.box_head_losses(*map(torch.from_numpy, (cls, reg, prop,
                                                     matched_gt, fg,
                                                     sample_w)), TCFG)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k


def test_point_sampling_matches_jax():
    rng = np.random.default_rng(12)
    boxes = _boxes(4, 13)
    px = rng.uniform(-5, 70, (4, 9)).astype(np.float32)
    py = rng.uniform(-5, 70, (4, 9)).astype(np.float32)
    want = jt._points_to_heatmap_coords(jnp.asarray(px), jnp.asarray(py),
                                        jnp.asarray(boxes), 56)
    got = tt._points_to_heatmap_coords(torch.from_numpy(px),
                                       torch.from_numpy(py),
                                       torch.from_numpy(boxes), 56)
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) <= 1e-6
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    maps = rng.standard_normal((4, 56, 56, 5)).astype(np.float32)
    hx, hy = (np.asarray(w) for w in want[:2])
    assert _rel(tt._bilinear_at_points(torch.from_numpy(maps),
                                       torch.from_numpy(hx),
                                       torch.from_numpy(hy)),
                jt._bilinear_at_points(jnp.asarray(maps), jnp.asarray(hx),
                                       jnp.asarray(hy))) <= 1e-6


def _exact_tie(mask, gt, prop, s, yy, xx) -> bool:
    """Whether pixel (yy, xx) of ``_mask_in_box`` is a tie in exact
    (rational) arithmetic: its bilinear value exactly 0.5, or its sample
    exactly on the mask's edge (-0.5 or M - 0.5 in mask coordinates)."""
    m = mask.shape[-1]
    f = lambda v: Fraction(float(v))
    coords = []
    for i, a in ((xx, 0), (yy, 1)):
        g = Fraction(2 * int(i) + 1, 2 * s)
        pt = f(prop[a]) + g * (f(prop[a + 2]) - f(prop[a]))
        size = max(f(gt[a + 2]) - f(gt[a]), f(np.float32(1e-6)))
        coords.append((pt - f(gt[a])) / size * m - Fraction(1, 2))
    if any(c in (Fraction(-1, 2), m - Fraction(1, 2)) for c in coords):
        return True
    (mx, my) = coords
    x0 = min(max(math.floor(mx), 0), m - 2)
    y0 = min(max(math.floor(my), 0), m - 2)
    fx = min(max(mx - x0, 0), 1)
    fy = min(max(my - y0, 0), 1)
    v = ((1 - fy) * ((1 - fx) * int(mask[y0, x0]) + fx * int(mask[y0, x0 + 1]))
         + fy * ((1 - fx) * int(mask[y0 + 1, x0])
                 + fx * int(mask[y0 + 1, x0 + 1])))
    return v == Fraction(1, 2)


@pytest.mark.parametrize("s,m", [(56, 28), (112, 56), (56, 16)])
def test_mask_in_box(s, m):
    """The rasterized gt masks against JAX's (its vmap, jitted as in its
    loss), for proposals equal to their gt box, shifted, and degenerate
    (clipped to the image's edge): every pixel that differs is an exact
    tie, and ties are rare."""
    rng = np.random.default_rng(14)
    k = 6
    masks = rng.uniform(0, 1, (k, m, m)) > 0.4
    gt = _boxes(k, 15).round()
    prop = gt.copy()                        # proposals that are gt boxes
    prop[2] += np.float32(0.3)
    prop[3:] = [[64, 64, 64, 64], [0, 64, 64, 64], [0, 0, 64, 64]]
    want = np.asarray(jax.jit(jax.vmap(
        lambda box, mask, pbox: jt._mask_in_box(mask, box, pbox[None], s)[0]
    ))(jnp.asarray(gt), jnp.asarray(masks), jnp.asarray(prop)))
    got = tt._mask_in_box(torch.from_numpy(masks), torch.from_numpy(gt),
                          torch.from_numpy(prop), s).numpy()
    # one gt for every proposal: the (M, M) / (4,) form
    one = tt._mask_in_box(torch.from_numpy(masks[0]),
                          torch.from_numpy(gt[0]), torch.from_numpy(prop),
                          s).numpy()
    np.testing.assert_array_equal(one[0], got[0])
    diff = np.argwhere(got != want)
    for kk, yy, xx in diff:
        assert _exact_tie(masks[kk], gt[kk], prop[kk], s, yy, xx), \
            (kk, yy, xx)
    assert len(diff) < got.size // 200


def test_chart_losses_match_jax():
    rng = np.random.default_rng(16)
    k, s = 5, 56
    outs = {"coarse_segm": rng.standard_normal((k, s, s, 2)),
            "fine_segm": rng.standard_normal((k, s, s, 25)),
            "u": rng.uniform(0, 1, (k, s, s, 25)),
            "v": rng.uniform(0, 1, (k, s, s, 25))}
    outs = {n: o.astype(np.float32) for n, o in outs.items()}
    gts = {n: v[0] for n, v in _gts(17).items()}
    dp_boxes = _boxes(k, 18, lo=10, hi=40)
    dp_valid = np.asarray([True, True, False, True, True])
    matched = np.asarray([0, 1, 0, 2, 1])
    want = jt.densepose_chart_losses(
        jax.tree.map(jnp.asarray, outs), jnp.asarray(dp_boxes),
        jnp.asarray(dp_valid), jax.tree.map(jnp.asarray, gts),
        jnp.asarray(matched), JTC, JCFG)
    got = tt.densepose_chart_losses(
        _torch(outs), torch.from_numpy(dp_boxes), torch.from_numpy(dp_valid),
        _torch(gts), torch.from_numpy(matched), TTC, TCFG)
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name], want[name]) <= 1e-5, name


# ---------------------------------------------------------------------------
# the batch loss, its gradient, the sampled sets
# ---------------------------------------------------------------------------


def test_total_loss_and_grads_match_jax(jax_run, port_run):
    assert set(port_run["losses"]) == set(jax_run["losses"])
    for k, v in jax_run["losses"].items():
        assert _rel(port_run["losses"][k], v) <= 1e-4, k
    assert _rel(port_run["total"], jax_run["total"]) <= 1e-4
    grads = port_run["grads"]
    assert set(grads) == set(jax_run["grads"])
    worst = max((_rel(g, jax_run["grads"][k]), k) for k, g in grads.items())
    assert worst[0] <= 1e-3, worst


def test_sampled_sets_equal_jax(jax_run, port_run):
    """Per image: the sampled anchors, the proposals NMS kept, the sampled
    proposals, the densepose slab and its validity."""
    for got, want in zip(port_run["record"], jax_run["per_image"]):
        for k, w in want["sets"].items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        assert got["roi_w"].sum() > 0 and got["dp_valid"].any()


def test_detection_loss_fn_matches_jax(setup, jax_run):
    """One image through ``detection_loss_fn`` (its per-image terms and
    counts, generator draws replaced by JAX's)."""
    gts = _torch(setup["gts"])
    got = tt.detection_loss_fn(
        setup["model"], None, torch.from_numpy(setup["images"][1:2]),
        {k: v[1] for k, v in gts.items()}, tcfg=TTC,
        uniforms=[[torch.from_numpy(u) for u in setup["uniforms"][1]]])
    want = jax_run["per_image"][1]["losses"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert _rel(got[k].detach(), v) <= 1e-4, k


def test_replayed_proposals_reproduce_the_run(setup, port_run):
    """``proposals=`` (a record's ``prop_idx``, NMS's choice replayed from
    another run) gives this run's own losses and sampled sets, bit for
    bit, on the model's own parameters."""
    record = []
    _, losses = tt.detection_total_loss(
        setup["model"], None, torch.from_numpy(setup["images"]),
        _torch(setup["gts"]), tcfg=TTC, record=record,
        uniforms=[[torch.from_numpy(u) for u in us]
                  for us in setup["uniforms"]],
        proposals=[r["prop_idx"] for r in port_run["record"]])
    for k, v in port_run["losses"].items():
        assert torch.equal(losses[k], v), k
    for got, want in zip(record, port_run["record"]):
        for k in ("rpn_w", "prop_idx", "roi_w", "fg", "dp_idx", "dp_valid"):
            assert torch.equal(got[k], want[k]), k
        assert got["nms_visited"] is None


# ---------------------------------------------------------------------------
# the mask, the optimizer, the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("freeze_at", [0, 1, 2])
def test_trainable_mask_matches_jax(setup, freeze_at):
    tree = setup["tree"]
    want = _flat(jt.detection_trainable_mask(
        tree, jt.DetectionTrainConfig(freeze_at=freeze_at)))
    got = tt.detection_trainable_mask(
        dict(setup["model"].named_parameters()),
        tt.DetectionTrainConfig(freeze_at=freeze_at))
    assert got == want


@pytest.fixture(scope="module")
def optax_runs(setup):
    """Three steps of JAX's optimizer (optax) on three seeded gradient
    trees, masked (``params`` given) and not: {masked: (grads a step by
    name, final params by name)}."""
    out = {}
    for masked in (True, False):
        jparams = jax.tree.map(jnp.asarray, setup["tree"])
        jtx = jt.make_detection_optimizer(JTC, jparams if masked else None)
        jstate = jtx.init(jparams)
        rng = np.random.default_rng(19)
        steps = []
        for _ in range(3):
            jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
                x.shape).astype(np.float32)), jparams)
            upd, jstate = jax.jit(jtx.update)(jg, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            steps.append({k: torch.from_numpy(np.array(g))
                          for k, g in _flat(jg).items()})
        out[masked] = steps, {k: np.asarray(v)
                              for k, v in _flat(jparams).items()}
    return out


@pytest.mark.parametrize("form", ["optax", "torch"])
@pytest.mark.parametrize("masked", [True, False])
def test_sgd_matches_optax(setup, optax_runs, form, masked):
    """The same three gradient steps through the port's optimizer, both
    forms: params within 1e-5 of optax's, frozen leaves equal."""
    steps, want = optax_runs[masked]
    params = tt.detection_params(setup["model"])
    start = {k: p.clone() for k, p in params.items()}
    tx = tt.make_detection_optimizer(TTC, params if masked else None,
                                     form=form)
    state = tx.init(params)
    for grads in steps:
        tx.update_({k: grads[k] for k in params if tx.trains(k)}, state,
                   params)
    mask = tt.detection_trainable_mask(params, TTC)
    for k, p in params.items():
        if masked and not mask[k]:
            np.testing.assert_array_equal(p.numpy(), want[k], err_msg=k)
            assert torch.equal(p, start[k]), k
        else:
            assert _rel(p, want[k]) <= 1e-5, k


def test_train_step_moves_only_the_trainable_leaves(setup):
    """Three steps of ``make_detection_train_step`` (generator draws,
    masked SGD) at the JAX test's input scale (N(0, 0.1^2) pixels: at
    lr 0.01 a random net on larger inputs diverges): finite losses, every
    trainable leaf moved, stem, res2 and every frozen BN bit for bit."""
    model = setup["model"]
    params = tt.detection_params(model)
    start = {k: p.clone() for k, p in params.items()}
    tx = tt.make_detection_optimizer(TTC, params)
    step = tt.make_detection_train_step(TTC, tx)
    state = tx.init(params)
    gen = torch.Generator().manual_seed(0)
    gts = _torch(setup["gts"])
    images = torch.from_numpy(setup["images"]) * 0.02
    for _ in range(3):
        state, metrics = step(model, params, state, images, gts, gen)
        assert all(torch.isfinite(v) for v in metrics.values()), metrics
    for k, p in params.items():
        moved = not torch.equal(p, start[k])
        assert moved == tx.trains(k), k
    assert not any(tx.trains(k) for k in params
                   if k.startswith(("backbone.stem", "backbone.res2"))
                   or ".bn." in k)


# ---------------------------------------------------------------------------
# nms_topk's early exit
# ---------------------------------------------------------------------------


def _old_nms_topk(boxes, scores, *, iou_threshold, topk, score_threshold):
    """The full-matrix path nms_topk had before its early exit: the greedy
    keep mask over the whole IoU matrix, then a top-k of the masked
    scores."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    valid = (scores > score_threshold)[order].numpy()
    b = boxes[order]
    over = (tnms.box_iou(b, b) > iou_threshold).numpy()
    keep_sorted, suppressed = np.zeros(n, bool), np.zeros(n, bool)
    for i in range(n):
        if valid[i] and not suppressed[i]:
            keep_sorted[i] = True
            suppressed |= over[i]
    keep = torch.zeros(n, dtype=torch.bool)
    keep[order] = torch.from_numpy(keep_sorted)
    masked = torch.where(keep, scores, torch.full_like(scores, -np.inf))
    if n < topk:
        masked = torch.cat([masked, masked.new_full((topk - n,), -np.inf)])
        boxes = torch.cat([boxes, boxes.new_zeros(topk - n, 4)])
    idx = torch.argsort(-masked, stable=True)[:topk]
    top = masked[idx]
    ok = torch.isfinite(top)
    return (torch.where(ok[:, None], boxes[idx], boxes.new_zeros(())),
            torch.where(ok, top, top.new_zeros(())),
            torch.where(ok, idx, idx.new_full((), -1)))


@pytest.mark.parametrize("chunk", [7, 2048])
def test_nms_topk_early_exit_is_exact(monkeypatch, chunk):
    """Against the full-matrix path and JAX's nms_topk, bit for bit: ties,
    N below topk, fewer survivors than topk, score thresholds, and chunk
    boundaries inside the walk."""
    monkeypatch.setattr(tnms, "CHUNK", chunk)
    rng = np.random.default_rng(20)
    jtopk = jax.jit(jnms.nms_topk, static_argnames=(
        "iou_threshold", "topk", "score_threshold"))
    for n, topk, thr, score_thr, ties in (
            (200, 20, 0.5, -np.inf, True), (200, 300, 0.7, -np.inf, False),
            (200, 150, 0.3, 0.4, True), (60, 1000, 0.5, 0.2, False),
            (200, 1, 0.5, -np.inf, True)):
        boxes = _boxes(n, int(rng.integers(1000)), span=80.0)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        if ties:
            scores = np.round(scores * 4) / 4
        kw = dict(iou_threshold=thr, topk=topk,
                  score_threshold=float(score_thr))
        tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
        got = tnms.nms_topk(tb, ts, **kw)
        for g, w in zip(got, _old_nms_topk(tb, ts, **kw)):
            assert torch.equal(g, w)
        for g, w in zip(got, jtopk(jnp.asarray(boxes), jnp.asarray(scores),
                                   **kw)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_topk_runs_over_every_anchor():
    """The trainer's case at its served size: 217,413 boxes (800x1088, all
    anchors of P2-P6), topk 1000, with no N x N matrix. The walk stops
    early, and the result is greedy NMS: no kept box overlaps a kept box
    of higher rank, every box it passed over does, and a coarser chunking
    gives the same."""
    n = (200 * 272 + 100 * 136 + 50 * 68 + 25 * 34 + 13 * 17) * 3
    assert n == 217413
    rng = np.random.default_rng(21)
    c = rng.uniform(0, 1088, (n, 2))
    s = rng.uniform(16, 400, (n, 2))
    boxes = torch.from_numpy(np.concatenate([c - s / 2, c + s / 2],
                                            1).astype(np.float32))
    scores = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    rec = {}
    b, sc, idx = tnms.nms_topk(boxes, scores, iou_threshold=0.7, topk=1000,
                               record=rec)
    assert (idx >= 0).all() and rec["visited"] < n
    order = torch.argsort(-scores, stable=True)[:rec["visited"]]
    assert torch.equal(idx, order[torch.isin(order, idx)])
    iou = tnms.box_iou(b, b)
    assert not (iou.triu(1) > 0.7).any()
    passed = order[~torch.isin(order, idx)]
    assert (tnms.box_iou(boxes[passed], b) > 0.7).any(1).all()
