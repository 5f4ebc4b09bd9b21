"""The port's parallel layer (``idmvton_tpu_torch/parallel``) against the
JAX package's, on the CPU.

The JAX side is ``idmvton_tpu``'s own functions on the conftest's 8
virtual CPU devices; the port's side is 2 or 4 gloo ranks spawned by
``parallel.dryrun.spawn`` (a ``FileStore`` in a temporary directory, each
collective bounded by 60 s, the ranks killed past the call's deadline,
one torch thread a rank). The ranks run ``torch_ranks.py``, which imports
only torch and the port; the inputs are numpy arrays from seeds, and JAX's
parameter trees reach the port through ``weights.from_jax``. fp32 on both
sides; each tolerance is stated where it is checked (JAX's own tests'
bounds unless said otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from idmvton_tpu.core.config import (
    CLIPTextConfig as JCLIPTextConfig, CLIPVisionConfig as JCLIPVisionConfig,
    UNetConfig as JUNetConfig,
)
from idmvton_tpu.models.clip import (
    _encoder_layer, clip_text_apply, clip_vision_apply, init_clip_text,
    init_clip_vision,
)
from idmvton_tpu.models.layers import ACTIVATIONS as JACT
from idmvton_tpu.models.unet import init_unet, unet_apply
from idmvton_tpu.parallel.mesh import make_mesh as jmake_mesh
from idmvton_tpu.parallel.tp import (
    shard_unet_params as jshard_unet_params, unet_param_spec as jspec,
)
from idmvton_tpu.parallel.zero import _moment_spec as j_moment_spec
from idmvton_tpu.train import train_step as jtrain
from idmvton_tpu.diffusion.scheduler import DDPMScheduler as JDDPM
from idmvton_tpu.core import config as jcfg
from idmvton_tpu_torch.core.config import SchedulerConfig, UNetConfig
from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.parallel import pp, tp, zero
from idmvton_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from idmvton_tpu_torch.train.train_step import (
    flat_params, init_train_state, make_optimizer, make_train_step,
)
from idmvton_tpu_torch.weights.checkpoint import load_train_state
import torch_ranks
from test_torch_train import _batch, stacks  # noqa: F401 (a fixture)

F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs at tiny shapes, where torch's intra-op threads
    only contend with the other test workers for the CPU (the spawned
    ranks take one thread each too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _names(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


# ---------------------------------------------------------------------------
# tensor and spatial parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "consume"])
def test_unet_param_spec_matches_jax(mode):
    """``unet_param_spec`` gives JAX's spec leaf for leaf (model axis 2),
    with more than 10 column splits."""
    jparams = init_unet(jax.random.PRNGKey(0), JUNetConfig.tiny(mode),
                        dtype=F32)
    want = {_names(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                jspec(jparams), is_leaf=lambda x: isinstance(x, P))}
    got = tp.unet_param_spec(UNet(UNetConfig.tiny(mode), dtype=torch.float32))
    assert got == want
    assert sum(s == (None, "model") for s in got.values()) > 10


@pytest.fixture(scope="module")
def unet_runs():
    """JAX's tiny "none" UNet at (4, 16, 16, 4): replicated, and tensor
    parallel on a (4, 2) mesh (JAX's test_tensor_parallel setup); the
    port's SP / TP forwards of the same tree and inputs on 4 ranks."""
    cfg = JUNetConfig.tiny("none", in_channels=4, ip_adapter=False)
    params = init_unet(jax.random.PRNGKey(0), cfg, dtype=F32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, cfg.cross_attention_dim)).astype(
        np.float32)
    pooled = np.zeros((4, 64), np.float32)
    tids = np.ones((4, 6), np.float32)
    fwd = jax.jit(lambda p, x_, c: unet_apply(
        p, cfg, x_, jnp.int32(300), c,
        added_cond=(jnp.asarray(pooled), jnp.asarray(tids)))[0])
    ref = np.asarray(fwd(params, x, ctx))
    mesh = jmake_mesh(jax.devices(), data=4, model=2)
    jtp = np.asarray(fwd(jshard_unet_params(params, mesh),
                         jax.device_put(x, NamedSharding(mesh, P("data"))),
                         ctx))
    ranks = spawn(torch_ranks.unet_parallel, 4, _np(params), x, ctx, pooled,
                  tids)
    return ref, jtp, ranks


def test_unet_tp_matches_jax(unet_runs):
    """Each data rank's rows of the port's TP forward against JAX's
    replicated and TP forwards, within 2e-4 (JAX's bound)."""
    ref, jtp, ranks = unet_runs
    np.testing.assert_allclose(jtp, ref, atol=2e-4, rtol=2e-4)
    for r in ranks:
        d, _ = r["coords"]
        np.testing.assert_allclose(r["tp"], ref[2 * d:2 * d + 2], atol=2e-4,
                                   rtol=2e-4)


def test_unet_sp_matches_jax(unet_runs):
    """Each rank's block (its data rank's rows, its model rank's 8 of 16
    latent rows) of the port's SP forward against JAX's forward, within
    2e-5 (JAX's test_spatial_parallel bound)."""
    ref, _, ranks = unet_runs
    for r in ranks:
        d, m = r["coords"]
        np.testing.assert_allclose(r["sp"], ref[2 * d:2 * d + 2,
                                                8 * m:8 * m + 8],
                                   atol=2e-5, rtol=2e-5)


def test_emit_features_dp2_sp2(unet_runs):
    """The tiny GarmentNet under dp=2 x sp=2 emits num_garment_features
    finite features on every rank (JAX's test_train_latents_spatial_
    parallel)."""
    for r in unet_runs[2]:
        n, want, finite = r["emit"]
        assert n == want and finite


def test_guided_step_tp_sp_match_single_process_fp32():
    """The try-on step the two-rank card tests run (``parallel.onecard``:
    GarmentNet's emitted features, TryonNet over the CFG batch with the
    uncond rows' garment K/V zeroed, the guidance), on the tiny UNets at
    16x16 latents in fp32 on 2 ranks: SP=2 (rows gathered) and TP=2 against
    the single-process step within 1e-4 relative (max and mean; fp32
    summation order only)."""
    from idmvton_tpu_torch.parallel import onecard
    for r in spawn(onecard.denoise_ranks, 2, 5, "cpu", True, torch.float32):
        for mode in ("tp", "sp"):
            mx, mean = r[f"{mode}_err"]
            assert mx <= 1e-4 and mean <= 1e-4, (mode, mx, mean)


# ---------------------------------------------------------------------------
# data parallelism, ZeRO-1, tensor-parallel training
# ---------------------------------------------------------------------------

GLOBAL_B = 8   # test_zero1.py's batch


@pytest.fixture(scope="module")
def train_runs(stacks, tmp_path_factory):
    """test_zero1.py's setup on the micro stack (adamw, global batch 8 at
    32x32, injected noise and timesteps, posterior-mode encodes): JAX's
    loss; the port's one-rank step in this process; its dp=4 steps
    (replicated and ZeRO-1, adamw and adamw8bit) and a dp=2 x tp=2 step
    on 4 ranks."""
    jm, tm, tree = stacks
    batch = _batch(GLOBAL_B, seed=3)
    jloss = jax.jit(lambda t: jtrain.tryon_loss(
        t, jm, JDDPM(jcfg.SchedulerConfig.train()),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), compute_dtype=F32, remat=False,
        vae_sample=False))({"unet": jm.unet, "resampler": jm.resampler})
    one = {}
    for opt in ("adamw", "adamw8bit"):
        tx = make_optimizer(optimizer=opt)
        step = make_train_step(tm, DDPMScheduler(SchedulerConfig.train()),
                               tx, compute_dtype=torch.float32, remat=False,
                               vae_sample=False)
        state, metrics = step(init_train_state(tm, tx),
                              {k: torch.from_numpy(np.asarray(v))
                               for k, v in batch.items()})
        one[opt] = (state, metrics)
    state_dir = str(tmp_path_factory.mktemp("zero1_state"))
    ranks = spawn(torch_ranks.train_parallel, 4, tree, batch, state_dir)
    return float(jloss), one, ranks, state_dir


def _params_close(got, want):
    """test_zero1.py's bound: rtol 1e-5, atol 1e-6 a leaf."""
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]),
                                   w.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dp_step_matches_one_rank_and_jax(train_runs):
    """dp=4 at global batch 8 against one rank at batch 8: loss within 1e-6
    relative, the updated masters within 1e-5; the loss against JAX's
    within 1e-5 relative (test_torch_train's cross-framework bound)."""
    jloss, one, ranks, _ = train_runs
    state, metrics = one["adamw"]
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-5)
    for r in ranks:
        got = r["adamw"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"],
                                   float(metrics["grad_norm"]), rtol=1e-5)
        _params_close(got["params"], flat_params(state.trainable))


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_zero1_matches_replicated_and_is_sharded(train_runs, opt):
    """ZeRO-1 at dp=4 (test_zero1.py): loss within 1e-6 relative of the
    replicated dp=4 step, masters within 1e-5 (and of the one-rank step),
    and each rank holds under half the replicated moments' bytes (JAX's
    formula and the slices actually held)."""
    _, one, ranks, _ = train_runs
    for r in ranks:
        rep, z = r[opt], r[f"{opt}_zero1"]
        np.testing.assert_allclose(z["loss"], rep["loss"], rtol=1e-6)
        _params_close(z["params"], {k: torch.from_numpy(v)
                                    for k, v in rep["params"].items()})
        _params_close(z["params"], flat_params(one[opt][0].trainable))
        assert rep["resident"] == rep["whole"] == z["whole"]
        assert z["resident"] < 0.5 * z["whole"], (z["resident"], z["whole"])
        assert z["formula"] < 0.5 * z["whole"]


def test_zero1_state_resumes_at_one_rank(train_runs):
    """The dp=4 ZeRO-1 state, gathered and saved, loads into a one-rank
    template and equals the one-rank step's state: masters within
    test_zero1.py's bound, each moment leaf within 1e-5 of its largest
    entry (the moments are the gradients scaled, summed over 4 ranks in
    another order)."""
    _, one, _, state_dir = train_runs
    state = one["adamw"][0]
    tm_state = load_train_state(state_dir, state)
    assert tm_state.step == 1 and tm_state.opt_state["count"] == 1
    for part in ("mu", "nu"):
        for k, v in state.opt_state[part].items():
            np.testing.assert_allclose(
                tm_state.opt_state[part][k].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-5 * float(v.abs().max()), err_msg=k)
    _params_close({k: v.detach().numpy() for k, v in
                   flat_params(tm_state.trainable).items()},
                  flat_params(state.trainable))


def test_tp_train_step_matches_dp(train_runs):
    """A dp=2 x tp=2 step: the loss within 1e-4 of the one-rank one (the dry run's bound), the clip norm over the whole
    leaves (each shard's squares summed over the group) within 1e-5
    relative, and the split leaves those JAX's spec splits."""
    _, one, ranks, _ = train_runs
    metrics = one["adamw"][1]
    for r in ranks:
        assert abs(r["tp"]["loss"] - float(metrics["loss"])) < 1e-4
        np.testing.assert_allclose(r["tp"]["grad_norm"],
                                   float(metrics["grad_norm"]), rtol=1e-5)
        want = {k for k, s in tp.unet_param_spec(
            UNet(UNetConfig.micro("consume"), dtype=torch.float32)).items()
            if s}
        assert set(r["tp"]["sharded"]) == want and len(want) > 10


@pytest.mark.parametrize("shape", [(4096, 320), (320,), (1000, 3), (7,),
                                   (16, 256), ()])
def test_moment_spec_matches_jax(shape):
    for n in (2, 4, 8):
        want = j_moment_spec(np.zeros(shape), n)
        got = zero._moment_spec(shape, n)
        assert (got is None) == (not any(want))
        if got is not None:
            assert want[got] == "data"


def test_dryrun_multichip_four_ranks():
    """``dryrun_multichip(4)`` on gloo CPU ranks: every phase of JAX's with
    JAX's bounds."""
    out = dryrun_multichip(4, device="cpu")
    assert abs(out["loss_zero1"] - out["loss"]) < 1e-5
    assert abs(out["loss_tp"] - out["loss"]) < 1e-4


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pp_runs():
    """JAX's references (test_pipeline_parallel.py's towers and inputs) and
    the port's GPipe cases on 4 ranks."""
    cfg = JCLIPTextConfig.tiny(num_layers=8, use_final_projection=True)
    params = init_clip_text(jax.random.PRNGKey(0), cfg, dtype=F32)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 12), 0,
                                        cfg.vocab_size))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                     (8, 12, cfg.hidden_size), F32))
    act = JACT[cfg.hidden_act]
    layer_fn = lambda lyr, h: _encoder_layer(
        lyr, h, num_heads=cfg.num_heads, act=act, causal=True)
    ref = _np(clip_text_apply(params, cfg, ids))
    skip = _np(clip_text_apply(params, cfg, ids, clip_skip=2))
    hs = [x]
    for lyr in params["layers"]:
        hs.append(np.asarray(layer_fn(lyr, hs[-1])))

    def loss_seq(layers):
        h = x
        for lyr in layers:
            h = layer_fn(lyr, h)
        return jnp.mean(h ** 2)

    grads = _np(jax.grad(loss_seq)(params["layers"]))
    vcfg = JCLIPVisionConfig.tiny()
    vparams = init_clip_vision(jax.random.PRNGKey(0), vcfg, dtype=F32)
    px = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(1), (8, vcfg.image_size, vcfg.image_size, 3), F32,
        -1, 1))
    vref = _np(clip_vision_apply(vparams, vcfg, px))
    bcfg = JCLIPTextConfig.tiny(num_layers=8)
    bparams = init_clip_text(jax.random.PRNGKey(4), bcfg, dtype=jnp.bfloat16)
    xb = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                      (8, 12, bcfg.hidden_size), F32))
    ranks = spawn(torch_ranks.pipeline_parallel, 4, _np(params), ids, x,
                  _np(vparams), px, _np(bparams), xb)
    return dict(ref=ref, skip=skip, hs=hs, grads=grads, vref=vref,
                ranks=ranks)


def _assert_tower(out, ref):
    for k in ("penultimate", "last_hidden", "pooled"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["dp2_pp2", "pure_pp4", "single_micro",
                                  "single_stage"])
def test_pp_matches_sequential(pp_runs, case):
    """JAX's dp2_pp4 / pure_pp8 / single-microbatch / single-stage cases on
    (2, 2) n_micro 2, (1, 4) n_micro 4, (2, 2) n_micro 1, (4, 1): every
    rank's whole-batch outputs against JAX's sequential tower within 1e-5."""
    for r in pp_runs["ranks"]:
        _assert_tower(r[case], pp_runs["ref"])


def test_pp_clip_skip_capture(pp_runs):
    for r in pp_runs["ranks"]:
        _assert_tower(r["clip_skip"], pp_runs["skip"])


def test_gpipe_capture_on_stage_boundary(pp_runs):
    """capture_before 0 (the raw input), 2 and 4 (the first layers of
    stages 1 and 2 on (1, 4)): output and capture within 1e-5."""
    hs = pp_runs["hs"]
    for r in pp_runs["ranks"]:
        for k, (y, cap) in r["captures"].items():
            np.testing.assert_allclose(y, hs[-1], atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(cap, hs[k], atol=1e-5, rtol=1e-5)


def test_pp_bf16_schedule_is_noise_free(pp_runs):
    """bf16 towers: the schedule equals the sequential forward over the
    same microbatch slices bit for bit (JAX's oracle's structure)."""
    assert all(r["bf16_equal"] for r in pp_runs["ranks"])


def test_gpipe_is_differentiable(pp_runs):
    """Each rank's stage gradients (summed over its data row's microbatches
    and over the data rows) against JAX's sequential gradients, within
    2e-3 (JAX's bound)."""
    grads = pp_runs["grads"]
    for r in pp_runs["ranks"]:
        assert r["grads"]
        for name, g in r["grads"].items():
            i, path = name.split(".", 1)
            want = grads[int(i)]
            for key in path.split("."):
                want = want[key]
            np.testing.assert_allclose(g, want, atol=2e-3, rtol=2e-3,
                                       err_msg=name)


def test_pp_validation_errors(pp_runs):
    """6 layers into 4 stages; batch 8 over data 2 x micro 3."""
    for r in pp_runs["ranks"]:
        e1, e2 = r["errors"]
        assert "not divisible into 4" in e1 and "n_micro 3" in e2


def test_pp_prestaged_params_reused(pp_runs):
    for r in pp_runs["ranks"]:
        for out in r["prestaged"]:
            _assert_tower(out, pp_runs["ref"])


def test_pp_vision_tower_matches_sequential(pp_runs):
    for r in pp_runs["ranks"]:
        for k in ("penultimate", "image_embeds"):
            np.testing.assert_allclose(r["vision"][k], pp_runs["vref"][k],
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def test_replicate_params_takes_rank_0s_values(pp_runs):
    """Ranks seeded apart hold the same parameters after
    ``replicate_params``."""
    sums = [float(r["replicated"]) for r in pp_runs["ranks"]]
    assert len(set(sums)) == 1, sums


def test_stack_layers_shapes():
    from idmvton_tpu_torch.core.config import CLIPTextConfig
    from idmvton_tpu_torch.models.clip import CLIPText
    cfg = CLIPTextConfig.tiny(num_layers=8)
    stacked = pp.stack_layers(CLIPText(cfg, dtype=torch.float32).layers)
    assert stacked["attn.q.kernel"].shape == (8, cfg.hidden_size,
                                               cfg.hidden_size)


# ---------------------------------------------------------------------------
# the training CLI at two ranks
# ---------------------------------------------------------------------------


def test_cli_train_two_ranks_match_one(tmp_path):
    """``cli.train.main --micro --device cpu`` at 2 ranks x batch 1 against
    1 rank x batch 2 (the same global batch), one optimizer step (AdamW, lr
    1e-5): the logged loss within 1e-5 relative; the saved train state's
    first moments (0.1 x the averaged gradient) within 2e-2 of each leaf's
    largest; its masters within 1e-5, save where the one-rank gradient is
    under 1e-2 of its leaf's largest: the CLI computes in bf16, so such an
    entry may flip the sign of Adam's first step (lr * g / |g|) and lands
    within 2 lr + 1e-5 (at most 1% of the entries). With ``--zero1`` the
    moments are partitioned (each rank under 0.6x the replicated bytes)
    and the saved state is the same."""
    from idmvton_tpu_torch.cli import train as cli_train
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from test_data_cli import make_viton_tree
    data = str(tmp_path / "data")
    make_viton_tree(data, n=4, phase="train", size=(32, 32))
    base = ["--data_dir", data, "--micro", "--device", "cpu", "--width",
            "32", "--height", "32", "--max_steps", "1", "--logging_steps",
            "1", "--no_aug"]

    def argv(name, b):
        return base + ["--output_dir", str(tmp_path / name),
                       "--train_batch_size", str(b)]

    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_train.main(argv("one", 2))
    runs = {"one": buf.getvalue()}
    for name, extra in (("two", []), ("two_zero1", ["--zero1"])):
        ranks = spawn(torch_ranks.train_cli, 2, argv(name, 1) + extra)
        runs[name] = ranks[0]["log"]
        assert all(r["zero1"] == bool(extra) for r in ranks)
        if extra:
            assert all(r["bytes"] < 0.6 * ranks_rep_bytes for r in ranks)
        else:
            ranks_rep_bytes = ranks[0]["bytes"]

    def loss(log):
        line = next(s for s in log.splitlines() if "step 1: loss" in s)
        return float(line.split("loss ")[1].split()[0])


    tm = TryonModels.init(0, micro=True, device="cpu", dtype=torch.float32)
    template = init_train_state(tm, make_optimizer())
    states = {n: load_train_state(str(tmp_path / n / "state"), template)
              for n in runs}
    one = states["one"]
    want = flat_params(one.trainable)
    flips = total = 0
    for name in ("two", "two_zero1"):
        np.testing.assert_allclose(loss(runs[name]), loss(runs["one"]),
                                   rtol=1e-5)
        got = states[name]
        for k, v in flat_params(got.trainable).items():
            mu, mu_want = got.opt_state["mu"][k], one.opt_state["mu"][k]
            scale = float(mu_want.abs().max())
            assert float((mu - mu_want).abs().max()) <= 2e-2 * scale, k
            err = (v - want[k]).detach().abs()
            tiny = mu_want.abs() < 1e-2 * scale
            assert bool((err[~tiny] <= 1e-5).all()), k
            assert bool((err[tiny] <= 2 * 1e-5 + 1e-5).all()), k
            flips += int((err[tiny] > 1e-5).sum())
            total += err.numel()
    assert flips <= 0.01 * total, (flips, total)


@pytest.mark.parametrize("ranks", [2, 3])
def test_batch_loader_shards_are_the_global_batch(tmp_path, ranks):
    """``BatchLoader(shard=(r, ranks))``, each rank over its own dataset
    object (as each ``cli.train`` process holds one): rank r's rows of
    every global batch of the shared shuffled order, flipped, jittered and
    moved as one loader of the global batch does it, bit for bit."""
    from idmvton_tpu_torch.data.datasets import BatchLoader, VitonHDDataset
    from test_data_cli import make_viton_tree
    root = str(tmp_path)
    make_viton_tree(root, n=7, phase="train", size=(32, 32))
    kw = dict(phase="train", size=(32, 32), hflip_prob=0.5,
              aug_color_jitter=True, aug_affine=True, seed=3)

    def loader(batch, shard=(0, 1)):
        return BatchLoader(VitonHDDataset(root, **kw), batch, shuffle=True,
                           drop_last=True, seed=5, shard=shard)

    want = list(loader(ranks))
    shards = [list(loader(1, (r, ranks))) for r in range(ranks)]
    assert len(want) == 7 // ranks == len(loader(1, (0, ranks)))
    for i, w in enumerate(want):
        for k, v in w.items():
            got = [s[i][k] for s in shards]
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(np.concatenate(got), v,
                                              err_msg=k)
            else:
                assert sum(got, []) == v, k
    with pytest.raises(ValueError):
        BatchLoader(VitonHDDataset(root, **kw), 1, shard=(0, 2))
