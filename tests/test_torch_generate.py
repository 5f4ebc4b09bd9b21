"""The port's try-on pipeline API against the JAX package's, on the CPU.

``encode_conditioning``, ``replicate_cond``, the scheduler's
start / end / custom-timestep schedule, ``denoise``, ``generate``,
``jit_generate`` and ``stepwise_generate`` with their options, CLIP's
``clip_skip`` and each ``ValueError`` JAX raises, mirroring the JAX
package's own contracts (``tests/test_pipeline.py``). The JAX tiny stack's
parameters go through ``load_jax_params`` into the port's tiny stack, as
initialized and with random biases and norm affines
(``test_torch_affine.random_affine``); both sides take the same numpy
inputs, posterior-mode VAE encodes and the same injected noises. JAX runs
op by op (``jax.disable_jit``), which on the CPU costs less than compiling
each option's program.

Also, on the port alone: the table step against the int step, the graph
cache's recapture on new weights or a flipped switch, and the captured
step's bookkeeping (launch counters saved and restored around a capture
and added at every replay, the static buffers) with a fake replay.

Tolerances: fp32 on both sides, same formulas, other summation orders:
1e-4 (2e-4 after a decode), as ``test_torch_pipeline.py``. The schedules,
``replicate_cond``, the table step, the split chain and jit_generate
against generate on the CPU are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.core.config import SchedulerConfig as JCfg
from idmvton_tpu.diffusion.scheduler import DDPMScheduler as JSched
from idmvton_tpu.diffusion.scheduler import check_denoising_range as j_check
from idmvton_tpu.models.clip import clip_text_apply
from idmvton_tpu.models.vae import vae_encode
from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu_torch.core.config import SchedulerConfig as TCfg
from idmvton_tpu_torch.diffusion.scheduler import TABLE_COLS
from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler as TSched
from idmvton_tpu_torch.diffusion.scheduler import check_denoising_range
from idmvton_tpu_torch.models.attention import quantize_unet_linears_int8
from idmvton_tpu_torch.ops import cuda_attention, cuda_conv, cuda_norm
from idmvton_tpu_torch.ops import dispatch as tdispatch
from idmvton_tpu_torch.pipeline import graph as tgraph
from idmvton_tpu_torch.pipeline import tryon as ttryon
from idmvton_tpu_torch.weights.from_jax import load_jax_params
from test_torch_affine import INITS, params_for

B, H, W, STEPS = 2, 32, 32, 2
LAT = (B, H // 8, W // 8, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs at tiny shapes, where torch's intra-op threads
    only contend with the other test workers for the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _t(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


@pytest.fixture(scope="module", params=INITS)
def stacks(request):
    """(JAX stack, its parameters as the case has them, the port's stack
    loaded with them)."""
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    tm = ttryon.TryonModels.init(None, tiny=True, dtype=torch.float32,
                                 device="cpu")
    tree = params_for(request.param, jm.params(), 7)
    load_jax_params(tm, tree)
    return jm, jax.tree.map(jnp.asarray, tree), tm


@pytest.fixture(scope="module")
def inputs(stacks):
    jm = stacks[0]
    rng = np.random.default_rng(0)
    img = lambda: rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    ids = lambda: rng.integers(0, jm.clip_l_cfg.vocab_size, (B, 7))
    isz = jm.vision_cfg.image_size
    mask = np.zeros((B, H, W, 1), np.float32)
    mask[:, 6:26, 4:20] = 1.0
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                ip_pixels=rng.uniform(-1, 1, (B, isz, isz, 3))
                .astype(np.float32))


def _noises(rows, steps, seed=1):
    """Initial (rows, h, w, 4) and per-step (steps, rows, h, w, 4) noise."""
    rng = np.random.default_rng(seed)
    lat = (rows,) + LAT[1:]
    return (rng.standard_normal(lat).astype(np.float32),
            rng.standard_normal((steps,) + lat).astype(np.float32))


def _embeds(jm, jp, inputs):
    """JAX's precomputed conditioning: the three prompt slots' embeds (and
    pooled companions) and the masked person's posterior-mode latents, as
    numpy."""
    ji = _j(inputs)
    out = {}
    for pre, key in (("", "prompt"), ("negative_", "neg"),
                     ("cloth_", "cloth")):
        e, pooled = jtryon.encode_prompt_sdxl(jm, jp, ji[f"{key}_ids_l"],
                                              ji[f"{key}_ids_g"])
        out[f"{pre}prompt_embeds"] = np.asarray(e)
        if pre != "cloth_":
            out[f"{pre}pooled_prompt_embeds"] = np.asarray(pooled)
    masked = ji["person"] * (ji["mask"] < 0.5).astype(jnp.float32)
    out["masked_image_latents"] = np.asarray(vae_encode(
        jp["vae"], jm.vae_cfg, masked, rng=None, sample=False))
    return out


# ---------------------------------------------------------------------------
# the encode side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "ids", "micro_conditioning+clip_skip", "prompt", "negative", "cloth",
    "masked"])
def test_encode_conditioning_matches_jax(stacks, inputs, case):
    """Each prompt slot takes ids or embeds (with its pooled companion);
    masked_image_latents skips that VAE encode; micro_conditioning reaches
    the time ids; clip_skip both towers' pick."""
    jm, jp, tm = stacks
    kw, ins = {}, dict(inputs)
    if case == "micro_conditioning+clip_skip":
        kw = dict(micro_conditioning=dict(original_size=(40, 30),
                                          crops_coords_top_left=(3, 4)),
                  clip_skip=1)
    elif case != "ids":
        emb = _embeds(jm, jp, inputs)
        if case == "masked":
            ins["masked_image_latents"] = emb["masked_image_latents"]
        else:
            pre = {"prompt": "", "negative": "negative_",
                   "cloth": "cloth_"}[case]
            key = {"prompt": "prompt", "negative": "neg",
                   "cloth": "cloth"}[case]
            del ins[f"{key}_ids_l"], ins[f"{key}_ids_g"]
            ins[f"{pre}prompt_embeds"] = emb[f"{pre}prompt_embeds"]
            if case != "cloth":
                ins[f"{pre}pooled_prompt_embeds"] = \
                    emb[f"{pre}pooled_prompt_embeds"]
    with jax.disable_jit():
        want = jtryon.TryonPipeline(jm).encode_conditioning(
            jp, jax.random.PRNGKey(1), vae_sample=False, **_j(ins), **kw)
    got = ttryon.TryonPipeline(tm).encode_conditioning(
        torch.Generator().manual_seed(1), vae_sample=False, **_t(ins), **kw)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])
    if case == "micro_conditioning+clip_skip":
        np.testing.assert_array_equal(got["time_ids"][-1].numpy(),
                                      [40, 30, 3, 4, 32, 32])


def test_staged_encoder_passthrough_matches_jax(stacks, inputs):
    """All five embeds and the masked latents through the staged encoder
    reproduce its ids path, on both sides."""
    jm, jp, tm = stacks
    ins = {k: v for k, v in inputs.items() if "ids" not in k}
    ins.update(_embeds(jm, jp, inputs))
    kw = dict(vae_sample=False, micro_conditioning=dict(target_size=(24, 20)))
    with jax.disable_jit():
        want = jtryon.TryonPipeline(jm).staged_encoder(**kw)(
            jp, jax.random.PRNGKey(1), _j(ins))
    pipe = ttryon.TryonPipeline(tm)
    got = pipe.staged_encoder(**kw)(torch.Generator(), _t(ins))
    ids_path = pipe.staged_encoder(**kw)(torch.Generator(), _t(inputs))
    for k in want:
        _close(got[k], want[k])
        _close(got[k], ids_path[k])


@pytest.mark.parametrize("skip", [0, 1])
def test_clip_skip_matches_jax(stacks, inputs, skip):
    jm, jp, tm = stacks
    ids = inputs["prompt_ids_l"]
    want = clip_text_apply(jp["clip_l"], jm.clip_l_cfg, jnp.asarray(ids),
                           clip_skip=skip)
    got = tm.clip_l(torch.from_numpy(ids), clip_skip=skip)
    _close(got["penultimate"], want["penultimate"])
    _close(got["last_hidden"], want["last_hidden"])


@pytest.mark.parametrize("n", [1, 3])
def test_replicate_cond_bit_exact(n):
    rng = np.random.default_rng(5)
    cond = {"mask_lat": rng.standard_normal((2, 4, 4, 1)),
            "context": rng.standard_normal((4, 9, 8)),
            "time_ids": rng.standard_normal((4, 6)),
            "cloth_embeds": rng.standard_normal((2, 7, 8))}
    cond = {k: v.astype(np.float32) for k, v in cond.items()}
    want = jtryon.replicate_cond(_j(cond), n)
    got = ttryon.replicate_cond(_t(cond), n)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_schedule_trims_and_custom_timesteps_match_jax(spacing):
    """Exact: timesteps and (ts, prev_ts) under strength, start, end, both
    and custom lists, and check_denoising_range's normalization."""
    js = JSched(JCfg(timestep_spacing=spacing))
    ts_ = TSched(TCfg(timestep_spacing=spacing))
    cases = [dict(num=10), dict(num=10, strength=0.3),
             dict(num=10, denoising_start=0.5),
             dict(num=10, strength=0.3, denoising_start=0.25),
             dict(num=10, denoising_end=0.5),
             dict(num=30, denoising_start=0.2, denoising_end=0.8),
             dict(num=10, denoising_start=1.5, strength=0.5),
             dict(num=10, denoising_end=0.0),
             dict(num=0, custom=[900, 600, 300]),
             dict(num=0, custom=[901, 601, 301, 10], strength=0.5),
             dict(num=0, custom=[999, 700, 400, 100, 5],
                  denoising_end=0.5)]
    for c in cases:
        kw = dict(strength=c.get("strength", 1.0),
                  denoising_start=c.get("denoising_start"),
                  denoising_end=c.get("denoising_end"),
                  custom_timesteps=c.get("custom"))
        np.testing.assert_array_equal(ts_.timesteps(c["num"], **kw),
                                      np.asarray(js.timesteps(c["num"],
                                                              **kw)))
        for got, want in zip(ts_.timesteps_and_prev(c["num"], **kw),
                             js.timesteps_and_prev(c["num"], **kw)):
            np.testing.assert_array_equal(got, np.asarray(want))
    for pair in ((None, None), (0.3, None), (None, 0.7), (1.0, 0.0),
                 (-0.2, 1.5), (0.2, 0.8)):
        assert check_denoising_range(*pair) == j_check(*pair)


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_step_equals_int_step(prediction_type, dtype):
    """The table step (a row on the device, as the captured step reads it)
    equals the int step bit for bit on the CPU, the last step (no noise) and
    the blend's add_noise at the next timestep included."""
    s = TSched(dataclasses.replace(TCfg.sdxl_inference(),
                                   prediction_type=prediction_type))
    ts, prev = s.timesteps_and_prev(12, denoising_end=0.75)
    nxt = np.concatenate([ts[1:], [-1]])
    table = torch.from_numpy(s.step_table(ts, prev, nxt))
    g = torch.Generator().manual_seed(0)
    for i in range(len(ts)):
        m, x, n = (torch.randn(2, 4, 4, 4, generator=g).to(dtype)
                   for _ in range(3))
        want = s.step(m, int(ts[i]), int(prev[i]), x, n)
        got = s.table_step(m, table[i], x, n)
        for a, b in zip(got, want):
            assert torch.equal(a, b), i
        want_n = s.add_noise(x, n, int(nxt[i])) if nxt[i] >= 0 else x
        assert torch.equal(s.table_add_noise(x, n, table[i]), want_n)


# ---------------------------------------------------------------------------
# denoise / generate / jit_generate / stepwise_generate
# ---------------------------------------------------------------------------


GENERATE_CASES = {
    "inpaint_blend+guidance_rescale+garment_once": dict(
        inpaint_blend=True, guidance_rescale=0.7, garment_cache="once"),
    "latent+strength": dict(output_type="latent", strength=0.6,
                            num_steps=4),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_matches_jax(stacks, inputs, case):
    """generate against JAX's with each option; jit_generate on a CPU input
    equals generate exactly."""
    jm, jp, tm = stacks
    kw = dict(GENERATE_CASES[case], vae_sample=False)
    kw.setdefault("num_steps", STEPS)
    n = kw.get("num_images_per_prompt", 1)
    init_noise, step_noise = _noises(B * n, STEPS)
    noise = dict(init_noise=init_noise, step_noise=step_noise)
    with jax.disable_jit():
        want = jtryon.TryonPipeline(jm).generate(
            jp, jax.random.PRNGKey(2), **_j(inputs), **_j(noise), **kw)
    pipe = ttryon.TryonPipeline(tm)
    got = pipe.generate(torch.Generator().manual_seed(2), **_t(inputs),
                        **_t(noise), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, tol=1e-4 if kw.get("output_type") else 2e-4)
    got_jit = pipe.jit_generate(**kw)(torch.Generator().manual_seed(2),
                                      **_t(inputs), **_t(noise))
    assert torch.equal(got_jit, got)


def test_num_images_per_prompt_replicates(stacks, inputs):
    """num_images_per_prompt=2 with each noise row repeated gives two
    copies of the n=1 image (JAX's contract; the n=2 run is held against
    JAX's in test_stepwise_generate_options_match_jax)."""
    tm = stacks[-1]
    init_noise, step_noise = _noises(B, STEPS, seed=2)
    pipe = ttryon.TryonPipeline(tm)
    kw = dict(num_steps=STEPS, vae_sample=False)
    one = pipe.generate(None, **_t(inputs), init_noise=torch.from_numpy(
        init_noise), step_noise=torch.from_numpy(step_noise), **kw)
    two = pipe.generate(
        None, **_t(inputs), num_images_per_prompt=2,
        init_noise=torch.from_numpy(init_noise).repeat_interleave(2, 0),
        step_noise=torch.from_numpy(step_noise).repeat_interleave(2, 1),
        **kw)
    assert tuple(two.shape) == (2 * B, H, W, 3)
    for i in range(B):
        for j in range(2):
            _close(two[2 * i + j], one[i], tol=2e-5)


STEPWISE_CASES = {
    "blend+rescale+clip_skip+micro": dict(
        inpaint_blend=True, guidance_rescale=0.5, clip_skip=1,
        micro_conditioning=dict(crops_coords_top_left=(2, 1))),
    "two_images+latent+timesteps": dict(
        num_images_per_prompt=2, output_type="latent",
        timesteps=[950, 420]),
}


@pytest.mark.parametrize("case", list(STEPWISE_CASES))
def test_stepwise_generate_options_match_jax(stacks, inputs, case):
    jm, jp, tm = stacks
    kw = dict(STEPWISE_CASES[case], num_steps=STEPS, vae_sample=False)
    n = kw.get("num_images_per_prompt", 1)
    init_noise, step_noise = _noises(B * n, STEPS, seed=3)
    noise = dict(init_noise=init_noise, step_noise=step_noise)
    with jax.disable_jit():
        want = jtryon.TryonPipeline(jm).stepwise_generate(**kw)(
            jp, jax.random.PRNGKey(2), **_j(inputs), **_j(noise))
    got = ttryon.TryonPipeline(tm).stepwise_generate(**kw)(
        torch.Generator().manual_seed(2), **_t(inputs), **_t(noise))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, tol=1e-4 if kw.get("output_type") else 2e-4)


def test_callback_on_step_end_matches_jax(stacks, inputs):
    """The host callback sees each step's index and descending timestep,
    as JAX's; a returned latent replaces the step's (zeros after step 0),
    and the run then matches JAX's run with the same override."""
    jm, jp, tm = stacks
    init_noise, step_noise = _noises(B, STEPS, seed=4)
    noise = dict(init_noise=init_noise, step_noise=step_noise)
    seen = {"jax": [], "torch": []}

    def callback(side, zeros):
        def cb(p, i, t, kwargs):
            assert set(kwargs) == {"latents"}
            seen[side].append((i, t))
            if i == 0:
                return {"latents": zeros(kwargs["latents"])}
        return cb

    kw = dict(num_steps=STEPS, vae_sample=False)
    with jax.disable_jit():
        want = jtryon.TryonPipeline(jm).stepwise_generate(
            **kw, callback_on_step_end=callback("jax", jnp.zeros_like))(
            jp, jax.random.PRNGKey(2), **_j(inputs), **_j(noise))
    pipe = ttryon.TryonPipeline(tm)
    got = pipe.stepwise_generate(
        **kw, callback_on_step_end=callback("torch", torch.zeros_like))(
        torch.Generator(), **_t(inputs), **_t(noise))
    base = pipe.stepwise_generate(**kw)(torch.Generator(), **_t(inputs),
                                        **_t(noise))
    assert seen["torch"] == seen["jax"]
    assert [t for _, t in seen["torch"]] == sorted(
        (t for _, t in seen["torch"]), reverse=True)
    _close(got, want, tol=2e-4)
    assert float((got - base).abs().max()) > 1e-3


def test_denoising_split_chain_bit_exact(stacks, inputs):
    """denoise(denoising_end=x) then denoise(denoising_start=x, latents_in=)
    equals the unsplit run exactly, and so does the same chain through
    stepwise_generate(output_type="latent") (the unsplit runs are held
    against JAX's in the tests above)."""
    tm = stacks[-1]
    num = 4
    init_noise, step_noise = _noises(B, num, seed=5)
    pipe = ttryon.TryonPipeline(tm)
    cond = pipe.encode_conditioning(torch.Generator(), vae_sample=False,
                                    **_t(inputs))
    kw = dict(latent_shape=LAT, num_steps=num,
              init_noise=torch.from_numpy(init_noise))
    sn = torch.from_numpy(step_noise)
    full = pipe.denoise(torch.Generator(), cond, step_noise=sn, **kw)
    k = len(pipe.scheduler.timesteps(num, denoising_end=0.5))
    assert 0 < k < num
    seg1 = pipe.denoise(torch.Generator(), cond, denoising_end=0.5,
                        step_noise=sn[:k], **kw)
    seg2 = pipe.denoise(torch.Generator(), cond, denoising_start=0.5,
                        latents_in=seg1, step_noise=sn[k:], **kw)
    assert torch.equal(seg2, full)

    sw = dict(num_steps=num, vae_sample=False, output_type="latent")
    ins = _t(inputs)
    whole = pipe.stepwise_generate(**sw)(
        torch.Generator(), init_noise=kw["init_noise"], step_noise=sn, **ins)
    first = pipe.stepwise_generate(denoising_end=0.5, **sw)(
        torch.Generator(), init_noise=kw["init_noise"], step_noise=sn[:k],
        **ins)
    second = pipe.stepwise_generate(denoising_start=0.5, **sw)(
        torch.Generator(), init_noise=kw["init_noise"], step_noise=sn[k:],
        latents_in=first, **ins)
    assert torch.equal(second, whole)


def _raises_both(port, jax_call):
    with pytest.raises(ValueError):
        port()
    with jax.disable_jit(), pytest.raises(ValueError):
        jax_call()


@pytest.mark.parametrize("case", [
    "prompt_embeds_without_pooled", "negative_embeds_without_pooled",
    "staged_embeds_incomplete", "start_without_latents",
    "strength_without_image", "blend_without_image", "start_after_end",
    "custom_ascending", "custom_empty", "custom_out_of_range",
    "clip_skip_out_of_range"])
def test_value_errors_match_jax(stacks, inputs, case):
    jm, jp, tm = stacks
    tp, jpipe = ttryon.TryonPipeline(tm), jtryon.TryonPipeline(jm)
    ti, ji = _t(inputs), _j(inputs)
    emb = np.zeros((B, 7, 64), np.float32)
    if case in ("prompt_embeds_without_pooled",
                "negative_embeds_without_pooled"):
        key = "prompt_embeds" if case.startswith("prompt") else \
            "negative_prompt_embeds"
        _raises_both(
            lambda: tp.encode_conditioning(
                None, **ti, **{key: torch.from_numpy(emb)}),
            lambda: jpipe.encode_conditioning(
                jp, jax.random.PRNGKey(0), **ji, **{key: jnp.asarray(emb)}))
    elif case == "staged_embeds_incomplete":
        _raises_both(
            lambda: tp.staged_encoder()(
                None, dict(ti, prompt_embeds=torch.from_numpy(emb))),
            lambda: jpipe.staged_encoder()(
                jp, jax.random.PRNGKey(0),
                dict(ji, prompt_embeds=jnp.asarray(emb))))
    elif case in ("start_without_latents", "strength_without_image",
                  "blend_without_image"):
        kw = {"start_without_latents": dict(denoising_start=0.5),
              "strength_without_image": dict(strength=0.5),
              "blend_without_image": dict(inpaint_blend=True)}[case]
        cond_t = tp.encode_conditioning(None, vae_sample=False, **ti)
        cond_j = jpipe.encode_conditioning(jp, jax.random.PRNGKey(0),
                                           vae_sample=False, **ji)
        _raises_both(
            lambda: tp.denoise(None, cond_t, latent_shape=LAT, num_steps=4,
                               **kw),
            lambda: jpipe.denoise(jp, jax.random.PRNGKey(0), cond_j,
                                  latent_shape=LAT, num_steps=4, **kw))
    elif case == "start_after_end":
        _raises_both(
            lambda: tp.stepwise_generate(denoising_start=0.7,
                                         denoising_end=0.3),
            lambda: jpipe.stepwise_generate(denoising_start=0.7,
                                            denoising_end=0.3))
    elif case.startswith("custom"):
        bad = {"custom_ascending": [300, 600], "custom_empty": [],
               "custom_out_of_range": [1200, 600]}[case]
        _raises_both(lambda: tp.stepwise_generate(timesteps=bad),
                     lambda: jpipe.stepwise_generate(timesteps=bad))
    else:
        ids = inputs["prompt_ids_l"]
        n = jm.clip_l_cfg.num_layers
        _raises_both(
            lambda: tm.clip_l(torch.from_numpy(ids), clip_skip=n),
            lambda: clip_text_apply(jp["clip_l"], jm.clip_l_cfg,
                                    jnp.asarray(ids), clip_skip=n))


# ---------------------------------------------------------------------------
# the captured step's bookkeeping, on the CPU
# ---------------------------------------------------------------------------


def test_counted_capture_restores_and_adds_on_replay():
    counters = tdispatch.launch_counters()
    assert set(counters) == {
        "ln_linear", "fused_layer_norm", "gn_spatial_stats", "conv3x3",
        "conv3x3_hblock", "flash_attention_gemm", "ln_linear_i8",
        "cross_attention_small_kv", "conv3x3_padacc", "flash_attention",
        "flash_attention_fused_qkv", "gn_apply"}
    before = {k: f.launches for k, f in counters.items()}
    with tgraph.CountedCapture() as cc:
        cuda_norm.ln_linear.launches += 3       # what a capture records
        cuda_conv.conv3x3.launches += 2
    assert {k: f.launches for k, f in counters.items()} == before
    assert cc.delta["ln_linear"] == 3 and cc.delta["conv3x3"] == 2
    assert sum(cc.delta.values()) == 5
    for _ in range(4):
        cc.replayed()
    assert cuda_norm.ln_linear.launches == before["ln_linear"] + 12
    assert cuda_conv.conv3x3.launches == before["conv3x3"] + 8
    cuda_norm.ln_linear.launches = before["ln_linear"]
    cuda_conv.conv3x3.launches = before["conv3x3"]


class _FakeGraph:
    """A replay that runs the step's tensors on the CPU but, as a CUDA graph
    replay, no Python: the launches it would count are discarded."""

    def __init__(self, steps):
        self.steps = steps

    def replay(self):
        with tgraph.CountedCapture():
            self.steps._run()


def _fake_capture(self):
    self._run()                       # the first step, eagerly: counted
    with tgraph.CountedCapture() as counts:
        lat, idx = self.lat.clone(), self.idx.clone()
        self._run()                   # what the capture records ...
        self.lat.copy_(lat)           # ... and does not run
        self.idx.copy_(idx)
    return _FakeGraph(self), counts


@pytest.mark.parametrize("options", [
    dict(), dict(inpaint_blend=True, garment_cache="once",
                 guidance_rescale=0.5)])
def test_replayed_loop_equals_eager_loop(stacks, inputs, monkeypatch,
                                         options):
    """The graph loop over static buffers (the step table gathered by a
    device index, the latent written back, the noise slot, a callback's
    latent copied in) with a fake capture and replay: the latents equal the
    eager loop's bit for bit, and the launch counts of the replayed run
    equal the eager run's (each step counts two ln_linear and one conv3x3
    launch here)."""
    tm = stacks[-1]
    monkeypatch.setattr(tgraph.StepGraph, "_capture", _fake_capture)
    runs = {}
    for graph in (False, True):
        pipe = ttryon.TryonPipeline(tm)
        step = pipe._step

        def counted(*a, **kw):
            cuda_norm.ln_linear.launches += 2
            cuda_conv.conv3x3.launches += 1
            return step(*a, **kw)

        pipe._step = counted
        ins = _t(inputs)
        cond = pipe.encode_conditioning(None, vae_sample=False, **ins)
        image = pipe.models.vae.encode(ins["person"], sample=False)
        init_noise, step_noise = _noises(B, 4, seed=6)
        seen = []

        def cb(p, i, t, kw):
            seen.append(float(kw["latents"].abs().sum()))
            if i == 1:
                return {"latents": kw["latents"] * 0.5}

        counters = (cuda_norm.ln_linear, cuda_conv.conv3x3)
        before = [f.launches for f in counters]
        kw = dict(dict(inpaint_blend=False, garment_cache="every_step",
                       guidance_rescale=0.0), **options)
        for request in range(2):   # the second replays from the first step
            lat = pipe._denoise(
                None, cond, latent_shape=LAT, num_steps=4,
                guidance_scale=2.0, strength=1.0, dtype=torch.float32,
                image_latents=image, init_noise=torch.from_numpy(init_noise),
                step_noise=torch.from_numpy(step_noise), denoising_start=None,
                denoising_end=None, latents_in=None, timesteps=None,
                impl=None, callback=cb, graph=graph, **kw)
        runs[graph] = (lat, seen,
                       [f.launches - b for f, b in zip(counters, before)])
        for f, b in zip(counters, before):
            f.launches = b
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[True][2] == runs[False][2] == [2 * 2 * 4, 2 * 4]


def test_graph_cache_recaptures_on_new_weights_and_switches(monkeypatch):
    """pipe.step_graph gives the same graph for the same tensors, options,
    switches and weights, and a new one after the loader or the W8A8
    quantization rewrote the UNets, or after a call-time switch flipped
    (each switch, and calibrate_fixed_shift's force-off)."""
    for k in ("IDMVTON_FLASH_FIXED_SHIFT", "IDMVTON_CROSS_KERNEL",
              "IDMVTON_CONV_PADACC"):
        monkeypatch.delenv(k, raising=False)
    tm = ttryon.TryonModels.init(0, tiny=True, dtype=torch.float32,
                                 device="cpu")
    pipe = ttryon.TryonPipeline(tm)
    cond = {"mask_lat": torch.zeros(B, 4, 4, 1),
            "context": torch.zeros(2 * B, 9, 8)}
    lat = torch.zeros(LAT)
    get = lambda **kw: pipe.step_graph(cond, lat, **kw)
    first = get()
    assert get() is first
    assert get(guidance_rescale=0.5) is not first
    assert get(impl="torch") is first          # what a CPU input resolves to
    for env in ("IDMVTON_FLASH_FIXED_SHIFT=0", "IDMVTON_CROSS_KERNEL=1",
                "IDMVTON_CONV_PADACC=1"):
        name, value = env.split("=")
        monkeypatch.setenv(name, value)
        assert get() is not first, env
        monkeypatch.delenv(name)
        assert get() is first, env
    monkeypatch.setattr(cuda_attention, "_FIXED_SHIFT_FORCED_OFF", True)
    assert get() is not first
    monkeypatch.setattr(cuda_attention, "_FIXED_SHIFT_FORCED_OFF", False)
    assert get() is first
    # the loader writes the weights in place: same addresses, new version
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    second = get()
    assert second is not first and get() is second
    quantize_unet_linears_int8(tm.unet)
    third = get()
    assert third is not second and get() is third
    assert len(pipe.graphs.graphs) == 1        # the stale graphs dropped
    assert third.table.shape == (pipe.scheduler.cfg.num_train_timesteps,
                                 TABLE_COLS)
