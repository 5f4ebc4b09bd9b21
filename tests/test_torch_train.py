"""The port's training path against the JAX package's, on the CPU.

One micro stack (``UNetConfig.micro`` UNets, the tiny frozen towers, fp32)
on both sides: the JAX tree's structure comes from ``jax.eval_shape`` of
JAX's micro init (no init program runs), its values from the port's seeded
init with random biases and norm affines (``test_torch_affine``), loaded
into the port through ``load_jax_params``. Both losses take the same numpy
batch with injected noise and timesteps and posterior-mode VAE encodes
(``vae_sample=False``), so no random stream is shared.

JAX compiles one program for the three loss cases (``jax.value_and_grad``
of its ``tryon_loss``) and one for its adamw step on the epsilon case's
gradients (``tx.update`` + ``optax.apply_updates``: JAX's ``train_step``
after its ``value_and_grad``); each optimizer's arithmetic is held to
JAX's on a small tree of the UNet's leaf kinds (tracing optax over the
micro stack's 233 leaves costs seconds an optimizer). Tolerances, fp32 on
both sides with the same formulas and other summation orders, are stated
at each comparison.

Port only: the kernels' autograd Functions wired to their plain versions
(a stand-in kernel: the plain version under ``no_grad``), the raise of an
unwrapped kernel call under autograd, gradient accumulation against one
larger batch, remat against none, ``kernel_weight`` under an in-place
update, ``Policy``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idmvton_tpu.core import config as jcfg
from idmvton_tpu.diffusion.scheduler import DDPMScheduler as JDDPM
from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu.train import quant_opt as jquant
from idmvton_tpu.train import train_step as jtrain
from idmvton_tpu_torch.core.config import SchedulerConfig
from idmvton_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY, Policy
from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
from idmvton_tpu_torch.models.layers import Linear, kernel_weight
from idmvton_tpu_torch.ops import autograd as AG
from idmvton_tpu_torch.ops import cuda_attention as A
from idmvton_tpu_torch.ops import cuda_conv as C
from idmvton_tpu_torch.ops import cuda_norm as N
from idmvton_tpu_torch.ops.quant import quantize_kernel_int8
from idmvton_tpu_torch.pipeline.tryon import TryonModels
from idmvton_tpu_torch.train import quant_opt
from idmvton_tpu_torch.train import train_step as train_step_mod
from idmvton_tpu_torch.train.train_step import (
    flat_params, init_train_state, make_optimizer, make_train_step,
    tryon_loss,
)
from idmvton_tpu_torch.weights.from_jax import load_jax_params
from test_torch_affine import random_affine

B, H, W = 2, 32, 32
LR = 1e-3
# (prediction type, snr_gamma): every prediction type and both min-SNR
# weightings (v_prediction's snr + 1 shift; epsilon / sample's plain snr)
CASES = {"epsilon": ("epsilon", None), "v_prediction_min_snr":
         ("v_prediction", 5.0), "sample_min_snr": ("sample", 5.0)}
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")


def _sched_cfg(cfg, pt):
    return dataclasses.replace(cfg, prediction_type=pt)


def _paths(tree, prefix=""):
    """(dotted path, leaf) of a nested dict / list tree, as the port names
    its parameters."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _fill(struct, values, prefix=""):
    if isinstance(struct, dict):
        return {k: _fill(v, values, f"{prefix}{k}.") for k, v in
                struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_fill(v, values, f"{prefix}{i}.")
                            for i, v in enumerate(struct))
    return values[prefix[:-1]]


@pytest.fixture(scope="module")
def stacks():
    """(JAX micro stack, the port's micro stack, the numpy tree both
    hold)."""
    tm = TryonModels.init(0, micro=True, device="cpu", dtype=torch.float32)
    shapes = jax.eval_shape(lambda: jtryon.TryonModels.init(
        jax.random.PRNGKey(0), micro=True, dtype=jnp.float32).params())
    tree = {}
    for name, struct in shapes.items():
        values = {n: p.detach().numpy().copy()
                  for n, p in getattr(tm, name).named_parameters()}
        tree[name] = _fill(struct, values)
    tree = random_affine(tree, 11)
    load_jax_params(tm, tree)
    jm = jtryon.TryonModels(
        unet_cfg=jcfg.UNetConfig.micro("consume"),
        garm_cfg=jcfg.UNetConfig.micro("emit"),
        vae_cfg=jcfg.VAEConfig.tiny(), clip_l_cfg=jcfg.CLIPTextConfig.tiny(),
        clip_g_cfg=jcfg.CLIPTextConfig.tiny(hidden_size=32, projection_dim=64,
                                            use_final_projection=True),
        vision_cfg=jcfg.CLIPVisionConfig.tiny(),
        resampler_cfg=jcfg.ResamplerConfig.tiny(),
        **jax.tree.map(jnp.asarray, tree))
    return jm, tm, tree


def _batch(b=B, seed=0):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    ids = lambda: rng.integers(0, 1000, (b, 7))
    return dict(person=img(), pose=img(), cloth=img(),
                mask=(rng.uniform(size=(b, H, W, 1)) > 0.5).astype(
                    np.float32),
                prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                cloth_ids_g=ids(),
                ip_pixels=rng.uniform(-1, 1, (b, 28, 28, 3)).astype(
                    np.float32),
                noise=rng.standard_normal((b, H // 8, W // 8, 4)).astype(
                    np.float32),
                timesteps=rng.integers(0, 1000, (b,)))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_runs(stacks):
    """JAX's loss and gradients for every case, and each optimizer's first
    step on the epsilon case's gradients (``tx.update`` +
    ``optax.apply_updates``, as its ``train_step``) with the gradients'
    global norm: two compiled programs."""
    jm = stacks[0]
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    tr = {"unet": jm.unet, "resampler": jm.resampler}
    losses = [functools.partial(
        jtrain.tryon_loss, models=jm,
        scheduler=JDDPM(_sched_cfg(jcfg.SchedulerConfig.train(), pt)),
        batch=batch, rng=jax.random.PRNGKey(0), snr_gamma=g,
        compute_dtype=jnp.float32, remat=False, vae_sample=False)
        for pt, g in CASES.values()]
    grads = jax.jit(lambda t: [jax.value_and_grad(f)(t) for f in losses])(tr)
    txs = [jtrain.make_optimizer(learning_rate=LR, optimizer=o)
           for o in OPTIMIZERS]

    def steps(t, g):
        out = []
        for tx in txs:
            updates, st = tx.update(g, tx.init(t), t)
            out.append((optax.apply_updates(t, updates), st))
        return out, optax.global_norm(g)

    stepped, norm = jax.jit(steps)(tr, grads[0][1])
    return dict(zip(CASES, grads)), dict(zip(OPTIMIZERS, stepped)), norm


def _flat(tree):
    return {f"{c}.{p}": np.asarray(v) for c in ("unet", "resampler")
            for p, v in _paths(tree[c])}


def _assert_trees_close(got: dict, want: dict, rtol, atol_frac):
    """Every leaf: max |got - want| <= rtol * max |want leaf| + atol_frac *
    max |want| over all leaves."""
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        err = float(np.abs(g - w).max())
        bound = rtol * float(np.abs(w).max()) + atol_frac * scale
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(stacks, jax_runs, case):
    """``tryon_loss`` and the gradient of every trainable leaf (TryonNet and
    the Resampler) against JAX's ``jax.value_and_grad(tryon_loss)``.
    Tolerance: the loss 1e-5 relative; each leaf's gradient within 1e-3 of
    its own max |g| plus 1e-5 of the largest |g| of the stack (the fp32
    sums of the backward random-walk through ~40 layers; a dropped term at
    any site moves some leaf by its whole size)."""
    jm, tm, _ = stacks
    pt, gamma = CASES[case]
    sched = DDPMScheduler(_sched_cfg(SchedulerConfig.train(), pt))
    state = init_train_state(tm, make_optimizer())
    loss = tryon_loss(state.trainable, tm, sched, _torch_batch(_batch()),
                      snr_gamma=gamma, compute_dtype=torch.float32,
                      remat=False, vae_sample=False)
    params = flat_params(state.trainable)
    grads = torch.autograd.grad(loss, list(params.values()))
    want_loss, want_grads = jax_runs[0][case]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    _assert_trees_close({k: g.numpy() for k, g in zip(params, grads)},
                        _flat(want_grads), 1e-3, 1e-5)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_train_step_matches_jax(stacks, jax_runs, optimizer, monkeypatch):
    """One ``make_train_step`` step (epsilon, lr 1e-3) against JAX's
    ``train_step``: ``value_and_grad``, then ``tx.update`` and
    ``optax.apply_updates``. The loss within 1e-5 and the gradient norm
    within 1e-4 relative. Each parameter within a tenth of its leaf's
    largest step in JAX's update, + 2e-6 of the largest |p|, wherever
    JAX's gradient entry is above the gradient test's bound (1e-3 of the
    leaf's max |g| + 1e-5 of the stack's); below it, where the two
    gradients agree only to rounding, within two such steps: a first
    AdamW step moves a weight by lr * g / (|g| + eps) and a first
    Adafactor step by a normalized g (sign(g) on an unfactored leaf, its
    eps being 1e-30), so a gradient entry at the rounding floor may flip
    its step's sign; a wrong sign, a missing term or a skipped update
    elsewhere moves an entry by a whole step. adamw8bit's
    state: the step count, and the int8 moment codes of every leaf's
    blocks equal or one apart for 99% of them (a log10 rounding tie, or a
    moment near zero whose gradient entry differs). Each optimizer's
    arithmetic is held to optax's on the same gradients below. The step
    computes the global norm once: its ``grad_norm`` is the clip's norm."""
    jm, tm, tree = stacks
    tx = make_optimizer(learning_rate=LR, optimizer=optimizer)
    state = init_train_state(tm, tx)
    step = make_train_step(tm, DDPMScheduler(SchedulerConfig.train()), tx,
                           compute_dtype=torch.float32, remat=False,
                           vae_sample=False)
    norms = []
    plain_norm = train_step_mod.global_norm
    monkeypatch.setattr(train_step_mod, "global_norm",
                        lambda ts: norms.append(plain_norm(ts)) or norms[-1])
    state, metrics = step(state, _torch_batch(_batch()))
    assert state.step == 1
    assert len(norms) == 1 and metrics["grad_norm"] is norms[0]
    (want_params, want_state), want_norm = (jax_runs[1][optimizer],
                                            jax_runs[2])
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_runs[0]["epsilon"][0]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_norm),
                               rtol=1e-4)
    got = {k: p.detach().numpy() for k, p in flat_params(
        state.trainable).items()}
    want, before = _flat(want_params), _flat(tree)
    grads = _flat(jax_runs[0]["epsilon"][1])
    scale = max(float(np.abs(v).max()) for v in want.values())
    g_scale = max(float(np.abs(v).max()) for v in grads.values())
    for k, w in want.items():
        err = np.abs(got[k] - w)
        step = float(np.abs(w - before[k]).max()) + 2e-6 * scale
        g = np.abs(grads[k])
        settled = g > 1e-3 * float(g.max()) + 1e-5 * g_scale
        assert float(err[settled].max(initial=0)) <= step / 10, k
        assert float(err.max()) <= 2 * step, k
    if optimizer != "adamw8bit":
        return
    jst = want_state[1][0]     # chain(clip, chain(scale_by_adam_int8, ...))
    assert int(jst.count) == state.opt_state["count"] == 1
    # JAX's buffer holds the leaves in ``tree_leaves`` order (sorted keys)
    paths, _ = jax.tree_util.tree_flatten_with_path(want_params)
    want_leaves = [(".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                             for e in path), np.asarray(v))
                   for path, v in paths]
    j_offs, j_nb = quant_opt.layout([v.shape for _, v in want_leaves])
    p_offs, p_nb = quant_opt.layout([got[k].shape for k in got])
    assert j_nb == p_nb == state.opt_state["mu_q"].shape[0]
    p_off = dict(zip(got, p_offs))
    for which in ("mu", "nu"):
        jq = np.asarray(getattr(jst, which).q, np.int16)
        tq = state.opt_state[f"{which}_q"].numpy().astype(np.int16)
        close = total = 0
        for (k, v), jo in zip(want_leaves, j_offs):
            nb = -(-v.size // quant_opt.BLOCK)
            d = np.abs(tq[p_off[k]:p_off[k] + nb] - jq[jo:jo + nb])
            close, total = close + (d <= 1).sum(), total + d.size
        assert close / total >= 0.99, (which, close / total)


def _opt_tree(seed):
    """A small tree with the UNet's leaf kinds: a conv kernel whose two
    largest dims factor (>= 128), a linear kernel, one that does not
    factor, biases, a norm scale and a leaf that is not a multiple of the
    int8 optimizer's 256-element blocks."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": (3, 3, 128, 160), "linear": (160, 256),
              "thin": (96, 130), "bias": (256,), "scale": (32,),
              "odd": (5, 7)}
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("optimizer,accum", [
    ("adamw", 1), ("adamw8bit", 1), ("adafactor", 1), ("adamw", 2)])
def test_optimizer_matches_optax(optimizer, accum):
    """``make_optimizer`` against JAX's (optax's ``clip_by_global_norm``,
    ``adamw``, ``adafactor``, the int8 AdamW, ``MultiSteps``) on the same
    gradients: micro-steps whose gradient norms straddle the clip (2.7, then
    0.4 of max_grad_norm 1). Parameters within 1e-6 of each leaf's scale
    (fp32 on both sides, the same formulas; a power or root may differ in
    its last ulp); adamw8bit's moment codes equal or one apart (a log10
    rounding tie; 99.9% equal), its parameters then within the effect of
    one level (15% of lr: a moment one level off moves a step of at most
    lr by its 13% relative spacing)."""
    params = _opt_tree(0)
    grads = [{k: v * f for k, v in _opt_tree(s).items()}
             for s, f in ((1, 1.0), (2, 0.15), (3, 0.5), (4, 1.2))]
    steps = 2 * accum
    jtx = jtrain.make_optimizer(learning_rate=LR, optimizer=optimizer,
                                accum_steps=accum)

    def run(p, gs):
        st = jtx.init(p)
        for g in gs:
            u, st = jtx.update(g, st, p)
            p = optax.apply_updates(p, u)
        return p, st

    want, jst = jax.jit(run)(jax.tree.map(jnp.asarray, params),
                             [jax.tree.map(jnp.asarray, g)
                              for g in grads[:steps]])
    tx = make_optimizer(learning_rate=LR, optimizer=optimizer,
                        accum_steps=accum)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    launches = (quant_opt.fused_global_norm.launches,
                quant_opt.adamw_int8_fused_.launches)
    moved = [tx.update_({k: torch.from_numpy(v.copy()) for k, v in
                         g.items()}, state, tp) for g in grads[:steps]]
    assert moved == [(i + 1) % accum == 0 for i in range(steps)]
    # the CPU takes the plain update: no kernel, no leaf table
    assert (quant_opt.fused_global_norm.launches,
            quant_opt.adamw_int8_fused_.launches) == launches
    assert tx._table is None
    for k, w in want.items():
        w = np.asarray(w)
        atol = (0.15 * LR if optimizer == "adamw8bit"
                else 1e-6 * float(np.abs(w).max()))
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=0, atol=atol,
                                   err_msg=k)
    if optimizer == "adamw8bit":
        jq = jst[1][0]
        assert int(jq.count) == state["count"] == steps
        # each side's buffer holds the leaves in its own order (JAX's:
        # sorted keys), each on a block boundary
        j_offs, _ = quant_opt.layout([params[k].shape for k in sorted(params)])
        p_offs, _ = quant_opt.layout([v.shape for v in params.values()])
        j_off, p_off = dict(zip(sorted(params), j_offs)), dict(zip(params,
                                                                  p_offs))
        for which in ("mu", "nu"):
            codes = state[f"{which}_q"].numpy().astype(np.int16)
            want_codes = np.asarray(getattr(jq, which).q, np.int16)
            for k, v in params.items():
                nb = -(-v.size // quant_opt.BLOCK)
                got_k = codes[p_off[k]:p_off[k] + nb]
                want_k = want_codes[j_off[k]:j_off[k] + nb]
                assert np.abs(got_k - want_k).max() <= 1, (which, k)
                assert (got_k == want_k).mean() >= 0.999, (which, k)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_leaf_table_matches_layout(ranks):
    """The fused update's leaf table against ``layout``: the leaves' first
    blocks, then the blocks they cover (every leaf's blocks, the buffer's
    padding to a multiple of 8 left out), their sizes and their masters'
    addresses. Split over ``ranks`` as ZeRO-1 splits the buffer (one block
    range a rank; 2 ranks cut the conv leaf in two, 8 leave the last rank
    padding only), the kernel walks each covered block once over all ranks,
    and the leaf its binary search finds for a block (the last whose first
    block is not after it) holds the block, elements included."""
    params = {k: torch.from_numpy(v) for k, v in _opt_tree(0).items()}
    table = quant_opt.LeafTable(params)
    offs, nblocks = quant_opt.layout([p.shape for p in params.values()])
    sizes = [p.numel() for p in params.values()]
    nb = [-(-n // quant_opt.BLOCK) for n in sizes]
    assert (table.first, table.nblocks, table.sizes) == (offs, nblocks, sizes)
    assert table.used == sum(nb) == 932 and nblocks == 936
    assert table.static.tolist() == (offs + [table.used] + sizes
                                     + [p.data_ptr() for p in
                                        params.values()])
    assert table.key == quant_opt.LeafTable.key_of(params)
    per = nblocks // ranks
    walked = []
    for r in range(ranks):
        lo, end = table.span((r * per, (r + 1) * per))
        assert lo == r * per and end == min((r + 1) * per, table.used)
        walked += range(lo, end)
    assert walked == list(range(table.used))
    first = np.array(offs + [table.used])
    if ranks == 2:      # the conv leaf (blocks 0-719) spans both ranks
        assert table.span((0, per))[1] == per < nb[0]
    for b in walked:
        i = int(np.searchsorted(first, b, side="right")) - 1
        assert offs[i] <= b < offs[i] + nb[i]
        assert (b - offs[i]) * quant_opt.BLOCK < sizes[i]
    assert table.span() == (0, table.used)


def test_leaf_table_refuses_what_the_kernel_cannot_read():
    """fp32 contiguous masters only; gradients of the masters' sizes in
    fp32 on their device."""
    params = {k: torch.from_numpy(v) for k, v in _opt_tree(0).items()}
    with pytest.raises(ValueError, match="masters"):
        quant_opt.LeafTable(dict(params, bias=params["bias"].double()))
    with pytest.raises(ValueError, match="masters"):
        quant_opt.LeafTable(dict(params, linear=params["linear"].t()))
    table = quant_opt.LeafTable(params)
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    with pytest.raises(ValueError, match="fp32"):
        table.load(dict(grads, odd=grads["odd"].bfloat16()))
    with pytest.raises(ValueError, match="35 fp32"):
        table.load(dict(grads, odd=grads["odd"][:3]))
    with pytest.raises(ValueError, match="gradients for"):
        table.load(dict(list(grads.items())[:-1]))


def test_int8_quantization_matches_jax():
    """``quant_opt.quantize`` / ``dequantize`` against JAX's ``_quantize`` /
    ``_dequantize`` on blocks spanning 10 decades, with exact zeros: codes
    equal or one apart (a log10 rounding tie), the dequantized values then
    within one level (13%) and equal where the codes are."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 256)) * 10.0 ** rng.uniform(
        -8, 2, (64, 256))).astype(np.float32)
    x[3, :17] = 0.0
    q, s = quant_opt.quantize(torch.from_numpy(x))
    jqt = jquant._quantize(jnp.asarray(x))
    jq = np.asarray(jqt.q, np.int16)
    assert np.abs(q.numpy().astype(np.int16) - jq).max() <= 1
    assert (q.numpy() == jq).mean() > 0.999
    np.testing.assert_array_equal(s.numpy(), np.asarray(jqt.scale))
    got = quant_opt.dequantize(q, s).numpy()
    want = np.asarray(jquant._dequantize(jqt, x.shape))
    same = q.numpy() == jq
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6)


def test_gradient_accumulation_matches_full_batch(stacks):
    """accum 2 over two micro-batches of b=1 equals one b=2 step (JAX
    ``tests/test_train.py:72-122``): the parameters do not move after the
    first micro-step (bit for bit), the micro-losses average to the full
    loss (1e-5 relative) and the boundary update equals the full-batch one
    within 1e-5 (lr / 100: the running mean of two halves and one mean
    round differently, and where a gradient entry sits within rounding of
    zero that tips the first Adam step's g / (|g| + eps); a lost or
    doubled micro-gradient moves the step by a good part of lr). The
    accumulation's arithmetic is held to ``optax.MultiSteps`` exactly in
    ``test_optimizer_matches_optax``."""
    tm = stacks[1]
    sched = DDPMScheduler(SchedulerConfig.train())
    full = _torch_batch(_batch(2, seed=5))
    halves = [{k: v[i:i + 1] for k, v in full.items()} for i in range(2)]
    kw = dict(compute_dtype=torch.float32, remat=False, vae_sample=False)
    tx_f = make_optimizer(learning_rate=LR)
    tx_a = make_optimizer(learning_rate=LR, accum_steps=2)
    st_f, st_a = init_train_state(tm, tx_f), init_train_state(tm, tx_a)
    before = {k: p.detach().clone() for k, p in
              flat_params(st_a.trainable).items()}
    st_f, m_f = make_train_step(tm, sched, tx_f, **kw)(st_f, full)
    step_a = make_train_step(tm, sched, tx_a, **kw)
    st_a, m1 = step_a(st_a, halves[0])
    for k, p in flat_params(st_a.trainable).items():
        assert torch.equal(p, before[k]), k
    assert st_a.opt_state["mini_step"] == 1
    st_a, m2 = step_a(st_a, halves[1])
    assert st_a.opt_state["mini_step"] == 0
    assert st_a.opt_state["gradient_step"] == 1
    np.testing.assert_allclose((float(m1["loss"]) + float(m2["loss"])) / 2,
                               float(m_f["loss"]), rtol=1e-5)
    f, a = flat_params(st_f.trainable), flat_params(st_a.trainable)
    for k in f:
        np.testing.assert_allclose(a[k].detach().numpy(),
                                   f[k].detach().numpy(), atol=1e-5,
                                   err_msg=k)


def test_remat_matches_no_remat(stacks):
    """``remat=True`` (each resnet block and Transformer2D checkpointed,
    its recompute reading the step's weights again) gives the gradients of
    ``remat=False``: the same operations recomputed, equal within 1e-6 of
    each leaf's scale."""
    tm = stacks[1]
    sched = DDPMScheduler(SchedulerConfig.train())
    state = init_train_state(tm, make_optimizer())
    params = flat_params(state.trainable)
    out = []
    for remat in (False, True):
        loss = tryon_loss(state.trainable, tm, sched, _torch_batch(_batch()),
                          compute_dtype=torch.float32, remat=remat,
                          vae_sample=False)
        out.append(torch.autograd.grad(loss, list(params.values())))
    for k, g0, g1 in zip(params, *out):
        torch.testing.assert_close(g1, g0, rtol=1e-6,
                                   atol=1e-6 * float(g0.abs().max()) + 1e-12,
                                   msg=k)


def test_scheduler_training_methods_match_jax():
    """``get_velocity`` and ``snr`` against JAX's, on the zero-terminal-SNR
    training schedule at every timestep class (0, mid, the terminal one
    where snr is 0): fp32 formulas on both sides, 1e-6 relative."""
    cfg = SchedulerConfig.train()
    ts = np.array([0, 1, 250, 500, 998, 999])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 4, 4, 4)).astype(np.float32)
    n = rng.standard_normal((6, 4, 4, 4)).astype(np.float32)
    port, jx = DDPMScheduler(cfg), JDDPM(jcfg.SchedulerConfig.train())
    got = port.get_velocity(torch.from_numpy(x), torch.from_numpy(n), ts)
    want = jx.get_velocity(jnp.asarray(x), jnp.asarray(n), jnp.asarray(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(port.snr(ts).numpy(),
                               np.asarray(jx.snr(jnp.asarray(ts))),
                               rtol=1e-6)


def test_policy():
    """``Policy`` with torch dtypes, as JAX's with jnp ones."""
    x = torch.ones(3)
    assert DEFAULT_POLICY.cast(x).dtype == torch.bfloat16
    assert DEFAULT_POLICY.cast_to_param(x).dtype == torch.bfloat16
    assert FP32_POLICY.cast(x.bfloat16()).dtype == torch.float32
    p = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    assert p.cast(x).dtype == torch.bfloat16
    assert p.cast_to_param(x.bfloat16()).dtype == torch.float32
    assert Policy() == DEFAULT_POLICY


def test_kernel_weight_follows_in_place_updates():
    """A weight that requires grad (a master under an optimizer's in-place
    step) reaches the kernels as a fresh cast inside the autograd graph:
    after an in-place update, at the same address and weights epoch, the
    next call reads the new values; a frozen fp32 weight keeps its cached
    copy."""
    lin = Linear(4, 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        lin.kernel.fill_(1.0)
    lin.kernel.requires_grad_(True)
    first = kernel_weight(lin)
    assert first.grad_fn is not None and first.dtype == torch.bfloat16
    with torch.no_grad():
        lin.kernel.add_(1.0)
    assert float(kernel_weight(lin).detach().max()) == 2.0
    lin.kernel.requires_grad_(False)
    cached = kernel_weight(lin)
    assert kernel_weight(lin) is cached


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, wired to their plain versions
# ---------------------------------------------------------------------------


def _rn(*shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _function_cases():
    """name -> (autograd entry, plain version, inputs, keywords): small
    shapes of each kernel's layout, bf16 where the kernel takes bf16."""
    x = _rn(2, 8, 64)
    gam, bet = _rn(64, dtype=torch.float32) * 0.1 + 1, _rn(64, dtype=torch.float32) * 0.1
    w, wg = _rn(64, 32) * 0.1, _rn(64, 64) * 0.1
    b, bg = _rn(32) * 0.1, _rn(64) * 0.1
    w_i8, w_s = quantize_kernel_int8(w)
    xc, k3 = _rn(2, 6, 8, 16), _rn(3, 3, 16, 8) * 0.1
    qkv, kvr = _rn(4, 12, 3 * 32), _rn(2, 10, 2 * 32)
    q, kk, v = _rn(2, 12, 2, 16), _rn(2, 9, 2, 16), _rn(2, 9, 2, 16)
    kr, vr = _rn(2, 5, 2, 16), _rn(2, 5, 2, 16)
    cq, ckv, cip = _rn(2, 12, 32), _rn(2, 7, 64), _rn(2, 4, 64)
    # the channel means of xc, as group_sums hands them to #13
    xf = xc.float().reshape(2, -1, 16)
    m1, m2 = xf.mean(1), xf.square().mean(1)
    return {
        "ln_linear": (AG.ln_linear, N.ln_linear_torch,
                      (x, gam, bet, w, b), {}),
        "ln_linear_geglu": (AG.ln_linear, N.ln_linear_torch,
                            (x, gam, bet, wg, bg), {"geglu": True}),
        "fused_layer_norm": (AG.fused_layer_norm, N.layer_norm_torch,
                             (x, gam, bet), {}),
        "gn_spatial_stats": (AG.gn_spatial_stats, N.gn_spatial_stats_torch,
                             (xc,), {}),
        "gn_apply": (AG.gn_apply, N.gn_apply_torch,
                     (xc, m1, m2, gam[:16], bet[:16]),
                     {"num_groups": 4, "eps": 1e-6}),
        "gn_apply_silu": (AG.gn_apply, N.gn_apply_torch,
                          (xc, m1, m2, gam[:16], bet[:16]),
                          {"num_groups": 4, "silu": True}),
        "flash_attention_gemm": (AG.flash_attention_gemm,
                                 A.flash_attention_gemm_torch, (qkv, kvr),
                                 {"heads": 2, "uncond_rows": 2}),
        "conv3x3": (AG.conv3x3, C.conv3x3_torch, (xc, k3, _rn(8)), {}),
        "conv3x3_hblock": (AG.conv3x3_hblock, C.conv3x3_torch,
                           (xc, k3, _rn(8)), {}),
        "conv3x3_padacc": (AG.conv3x3_padacc, C.conv3x3_torch,
                           (xc, k3, None), {}),
        "ln_linear_i8": (AG.ln_linear_i8, N.ln_linear_i8_torch,
                         (x, gam, bet, w_i8, w_s, b), {}),
        "flash_attention": (AG.flash_attention, A.flash_attention_torch,
                            (q, kk, v), {}),
        "flash_attention_concat_kv": (
            AG.flash_attention_concat_kv,
            A.flash_attention_concat_kv_torch, (q, kk, v, kr, vr), {}),
        "cross_attention_small_kv": (AG.cross_attention_small_kv,
                                     A.cross_attention_small_kv_torch,
                                     (cq, ckv, cip), {"heads": 2}),
    }


FUNCTION_CASES = list(_function_cases())


def _leaf(t):
    if t is None or not t.is_floating_point():
        return t
    return t.detach().clone().requires_grad_()


def _grads(out, ins):
    outs = out if isinstance(out, tuple) else (out,)
    cot = [_rn(*o.shape, dtype=o.dtype, seed=7) for o in outs]
    wrt = [t for t in ins if t is not None and t.requires_grad]
    return torch.autograd.grad(outs, wrt, cot, allow_unused=True)


@pytest.mark.parametrize("name", FUNCTION_CASES)
def test_function_wiring_with_plain_stand_in(name):
    """Each kernel's autograd entry with a stand-in kernel (its plain
    version under ``no_grad``, recording its calls): the stand-in runs
    once in the forward, the output carries the Function's node, and the
    output and every input's gradient equal plain autograd's (exactly: the
    backward recomputes the same operations; #3's closed form within
    fp32 rounding, #8's gradient is the dequantized bf16 product's, as
    JAX's VJP). #4 differentiates the online softmax: the stand-in is
    called with ``fixed_shift=False`` whatever the site asked for."""
    entry, plain, ins, kw = _function_cases()[name]
    calls = []

    def stand_in(*a, **k):
        assert not torch.is_grad_enabled()
        calls.append(k)
        return plain(*a, **k)

    ins_k = [_leaf(t) for t in ins]
    extra = {"fixed_shift": True} if name == "flash_attention_gemm" else {}
    out = entry(*ins_k, kernel=stand_in, **kw, **extra)
    assert len(calls) == 1
    first = out[0] if isinstance(out, tuple) else out
    assert type(first.grad_fn).__name__ in ("KernelVJPBackward",
                                            "GnStatsVJPBackward")
    ins_p = [_leaf(t) for t in ins]
    if name == "ln_linear_i8":
        w = (ins[3].float() * ins[4][None]).to(ins[0].dtype)
        want = N.ln_linear_torch(ins_p[0], ins_p[1], ins_p[2], w, ins_p[5])
        ins_p = [ins_p[0], ins_p[1], ins_p[2], ins_p[5]]
        got_g = _grads(out, [ins_k[0], ins_k[1], ins_k[2], ins_k[5]])
    else:
        want = plain(*ins_p, **kw)
        got_g = _grads(out, ins_k)
    if name == "flash_attention_gemm":
        assert calls[0]["fixed_shift"] is False
    want_g = _grads(want, ins_p)
    tol = dict(rtol=1e-6, atol=1e-6) if name == "gn_spatial_stats" else \
        dict(rtol=0, atol=0)
    for g, wg in zip(got_g, want_g):
        torch.testing.assert_close(g, wg, **tol)
    if name != "ln_linear_i8":
        wants = want if isinstance(want, tuple) else (want,)
        outs = out if isinstance(out, tuple) else (out,)
        for o, w_ in zip(outs, wants):
            torch.testing.assert_close(o, w_.detach(), rtol=0, atol=0)


WRAPPERS = {
    "ln_linear": lambda x: N.ln_linear(x, x.new_ones(64).float(),
                                       x.new_zeros(64).float(),
                                       _rn(64, 32)),
    "fused_layer_norm": lambda x: N.fused_layer_norm(
        x, x.new_ones(64).float(), x.new_zeros(64).float()),
    "gn_spatial_stats": lambda x: N.gn_spatial_stats(x),
    "gn_apply": lambda x: N.gn_apply(
        x, x.new_zeros(2, 64).float(), x.new_ones(2, 64).float(),
        x.new_ones(64).float(), x.new_zeros(64).float(), num_groups=8),
    "conv3x3": lambda x: C.conv3x3(x.reshape(2, 2, 4, 64),
                                   _rn(3, 3, 64, 8)),
    "conv3x3_hblock": lambda x: C.conv3x3_hblock(
        x.reshape(2, 2, 4, 64), _rn(3, 3, 64, 8)),
    "conv3x3_padacc": lambda x: C.conv3x3_padacc(
        x.reshape(2, 2, 4, 64), _rn(3, 3, 64, 8)),
    "flash_attention_gemm": lambda x: A.flash_attention_gemm(
        x.reshape(2, 8, 64).repeat(1, 1, 3)[..., :192].reshape(2, 8, 192),
        heads=4),
    "ln_linear_i8": lambda x: N.ln_linear_i8(
        x, x.new_ones(64).float(), x.new_zeros(64).float(),
        *quantize_kernel_int8(_rn(64, 32))),
    "flash_attention": lambda x: A.flash_attention(
        x.reshape(2, 8, 4, 16).repeat(1, 40, 1, 1),
        x.reshape(2, 8, 4, 16).repeat(1, 40, 1, 1),
        x.reshape(2, 8, 4, 16).repeat(1, 40, 1, 1)),
    "flash_attention_fused_qkv": lambda x: A.flash_attention_fused_qkv(
        torch.stack([x.reshape(2, 8, 4, 16)] * 3, 2), 4),
    "cross_attention_small_kv": lambda x: A.cross_attention_small_kv(
        x.reshape(2, 8, 64), x.reshape(2, 8, 64).repeat(1, 1, 2), heads=4),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_unwrapped_kernel_call_under_grad_raises(name):
    """Every kernel wrapper, #10 included (it has no VJP), called with grad
    mode on and an input that requires grad outside its Function, raises
    before anything else; the same call under ``no_grad`` gets past that
    check (and stops at the CPU tensor)."""
    x = _rn(2, 8, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="under autograd"):
        WRAPPERS[name](x)
    with torch.no_grad(), pytest.raises(Exception) as info:
        WRAPPERS[name](x)
    assert "under autograd" not in str(info.value)
