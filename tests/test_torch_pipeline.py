"""The PyTorch port's serving pipeline against the JAX package's, on the CPU.

The JAX tiny stack's parameters (``TryonModels.init(tiny=True)``, fp32) go
through ``weights.from_jax.load_jax_params`` into the port's tiny stack;
both pipelines take the same numpy inputs, posterior-mode VAE encodes
(``vae_sample=False``) and the same injected initial / per-step noises, so
they compute the same trajectory.

Every comparison runs on the init's parameters and again with random
biases and norm affines (``test_torch_affine.random_affine``), given to
both stacks.

Tolerances: fp32 on both sides, same formulas, other summation orders;
through the text / vision / VAE towers and two denoise steps of both UNets
the differences stay below 1e-4 at O(1) values (2e-4 for the decoded
images, one more tower deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu_torch.pipeline import tryon as ttryon
from idmvton_tpu_torch.weights.from_jax import (
    load_jax_params, load_module_params,
)
from test_torch_affine import INITS, params_for

B, H, W, STEPS = 2, 32, 32, 2


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


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


def _jax_in(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _torch_in(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def test_staged_encoder_matches_jax(stacks, inputs):
    jm, jp, tm = stacks
    want = jtryon.TryonPipeline(jm).staged_encoder(vae_sample=False)(
        jp, jax.random.PRNGKey(1), _jax_in(inputs))
    got = ttryon.TryonPipeline(tm).staged_encoder(vae_sample=False)(
        torch.Generator().manual_seed(1), _torch_in(inputs))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])


@pytest.mark.parametrize("garment_cache", ["every_step", "once"])
def test_stepwise_generate_matches_jax(stacks, inputs, garment_cache):
    jm, jp, tm = stacks
    rng = np.random.default_rng(1)
    lat = (B, H // 8, W // 8, 4)
    init_noise = rng.standard_normal(lat).astype(np.float32)
    step_noise = rng.standard_normal((STEPS,) + lat).astype(np.float32)
    want = jtryon.TryonPipeline(jm).stepwise_generate(
        num_steps=STEPS, vae_sample=False, garment_cache=garment_cache)(
        jp, jax.random.PRNGKey(2), init_noise=jnp.asarray(init_noise),
        step_noise=jnp.asarray(step_noise), **_jax_in(inputs))
    phases = {}
    got = ttryon.TryonPipeline(tm).stepwise_generate(
        num_steps=STEPS, vae_sample=False, garment_cache=garment_cache)(
        torch.Generator().manual_seed(2), phase_seconds=phases,
        init_noise=torch.from_numpy(init_noise),
        step_noise=torch.from_numpy(step_noise), **_torch_in(inputs))
    assert got.shape == (B, H, W, 3) and bool(torch.isfinite(got).all())
    assert set(phases) == {"encode", "denoise", "decode"}
    _close(got, want, tol=2e-4)


def test_stepwise_generate_strength_matches_jax(stacks, inputs):
    """strength 0.6 of 4 steps runs the last 2 from the person image's
    posterior-mode VAE latents noised to the first of them (JAX
    ``stepwise_generate``, pipeline/tryon.py:802-832)."""
    jm, jp, tm = stacks
    rng = np.random.default_rng(3)
    lat = (B, H // 8, W // 8, 4)
    init_noise = rng.standard_normal(lat).astype(np.float32)
    step_noise = rng.standard_normal((STEPS,) + lat).astype(np.float32)
    kw = dict(num_steps=4, strength=0.6, vae_sample=False)
    want = jtryon.TryonPipeline(jm).stepwise_generate(**kw)(
        jp, jax.random.PRNGKey(2), init_noise=jnp.asarray(init_noise),
        step_noise=jnp.asarray(step_noise), **_jax_in(inputs))
    got = ttryon.TryonPipeline(tm).stepwise_generate(**kw)(
        torch.Generator().manual_seed(2),
        init_noise=torch.from_numpy(init_noise),
        step_noise=torch.from_numpy(step_noise), **_torch_in(inputs))
    _close(got, want, tol=2e-4)
    with pytest.raises(ValueError, match="leaves none"):
        ttryon.TryonPipeline(tm).stepwise_generate(num_steps=4, strength=0.1)


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_strength_schedule_and_add_noise_match_jax(spacing):
    """Exact: the same integer schedule, and the same fp32 coefficients
    and elementwise products."""
    from idmvton_tpu.core.config import SchedulerConfig as JCfg
    from idmvton_tpu.diffusion.scheduler import DDPMScheduler as JSched
    from idmvton_tpu_torch.core.config import SchedulerConfig as TCfg
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler as TSched
    js = JSched(JCfg(timestep_spacing=spacing))
    ts_ = TSched(TCfg(timestep_spacing=spacing))
    for n, strength in ((30, 1.0), (30, 0.6), (25, 0.33), (10, 0.05)):
        want_t, want_p = js.timesteps_and_prev(n, strength)
        got_t, got_p = ts_.timesteps_and_prev(n, strength)
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
        np.testing.assert_array_equal(got_p, np.asarray(want_p))
    rng = np.random.default_rng(4)
    x, n = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
            for _ in range(2))
    for t in (999, 500, 0, [981, 20, 1]):
        want = js.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
        got = ts_.add_noise(torch.from_numpy(x), torch.from_numpy(n), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ts_.add_noise(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(n).bfloat16(), 500)
    assert got.dtype == torch.bfloat16


def test_stepwise_generate_draws_from_the_generator(stacks, inputs):
    """Without injected noise the run is a function of the generator's
    seed: the same seed repeats, another seed differs."""
    tm = stacks[-1]
    fn = ttryon.TryonPipeline(tm).stepwise_generate(num_steps=STEPS)
    run = lambda s: fn(torch.Generator().manual_seed(s), **_torch_in(inputs))
    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-4


@pytest.mark.parametrize("kw", [
    {}, {"original_size": (40, 30), "crops_coords_top_left": (3, 4),
         "target_size": (36, 28), "negative_original_size": (20, 20)},
    {"requires_aesthetics_score": True, "aesthetic_score": 7.0,
     "negative_crops_coords_top_left": (1, 2)}])
def test_make_time_ids_matches_jax(kw):
    want = jtryon.make_time_ids(1024, 768, 3, jnp.float32, **kw)
    got = ttryon.make_time_ids(1024, 768, 3, torch.float32, "cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_full_width_stack_has_the_jax_parameter_tree():
    """At full SDXL width every parameter of the port (built on the meta
    device, no memory) has the name and shape of its JAX leaf."""
    shapes = jax.eval_shape(lambda: jtryon.TryonModels.init(
        jax.random.PRNGKey(0), dtype=jnp.bfloat16).params())
    tm = ttryon.TryonModels.init(None, device="meta")
    total = 0
    for name, module in tm.components().items():
        got = {n: tuple(p.shape) for n, p in module.named_parameters()}
        assert got == _flat(shapes[name]), name
        total += sum(p.numel() for p in module.parameters())
    assert 6.5e9 < total < 7.5e9


def test_loader_rejects_mismatched_trees():
    from idmvton_tpu_torch.models.layers import Linear
    lin = Linear(4, 3, dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="bias"):
        load_module_params(lin, {"kernel": np.zeros((4, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_module_params(lin, {"kernel": np.zeros((3, 4), np.float32),
                                 "bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_module_params(lin, {"kernel": np.zeros((4, 3), np.float32),
                                 "bias": np.zeros(3, np.float32),
                                 "extra": np.zeros(1, np.float32)})
    # bf16 leaves, as jax.tree.map(np.asarray, ...) gives them
    tree = jax.tree.map(np.asarray, {"kernel": jnp.full((4, 3), 1.5,
                                                        jnp.bfloat16),
                                     "bias": jnp.arange(3, dtype=jnp.bfloat16)})
    load_module_params(lin, tree)
    assert torch.equal(lin.kernel, torch.full((4, 3), 1.5))
    assert torch.equal(lin.bias, torch.arange(3.0))
