"""The port's spans and counters (``idmvton_tpu_torch/utils/profiling.py``)
and where the program places them.

The recorder: parents and roots, the counters, the ring's bound,
recording switched off, durations kept from a change of the clock's
offset, no ``record_function`` range without a profiler and one under it,
and the stamps on the profiler's own clock. The program, on the CPU at
tiny sizes: a ``stepwise_generate`` request and a ``make_train_step``
step, each one root holding its layers' spans, with ``phase_seconds``
equal to the spans' durations, and ``TryonService`` requests, whose
``stage_seconds`` equal their stages' spans and count the wait for the
service's lock in the first stage. Marked ``cuda`` (skipped without a
card): a kernel's launch inside its span on the profiler's clock, and the
captured step's spans and capture counter over a request. This file
imports no JAX: ``python -m pytest --noconftest -q
tests/test_torch_spans.py`` runs it on a host that has none.
"""

import argparse

import numpy as np
import pytest
import torch

from idmvton_tpu_torch.ops import cuda_norm
from idmvton_tpu_torch.utils import profiling

# a span's stamps against the profiler's events of the same window
CLOCK_SLACK_NS = 50_000


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _new(before):
    """The spans that closed since the ring read ``before``."""
    ids = {s.id for s in before}
    return [s for s in profiling.spans() if s.id not in ids]


def _tree(spans):
    """{name: [spans]} and the one root of ``spans``."""
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1, [s.name for s in roots]
    by = {}
    for s in spans:
        assert s.root == roots[0].id
        by.setdefault(s.name, []).append(s)
    return by, roots[0]


def _inside(child, parent):
    return (parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_parents_and_roots():
    before = profiling.spans()
    with profiling.span("t.a", k=1) as a:
        with profiling.span("t.b") as b:
            with profiling.span("t.c") as c:
                pass
        with profiling.span("t.d") as d:
            pass
    with profiling.span("t.e") as e:
        pass
    assert [s.name for s in _new(before)] == ["t.c", "t.b", "t.d", "t.a",
                                              "t.e"]
    assert a.parent is None and a.root == a.id and a.attrs == {"k": 1}
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    assert {b.root, c.root, d.root} == {a.id}
    assert e.parent is None and e.root == e.id != a.id
    for s in (b, c, d):
        assert _inside(s, a)
    assert a.seconds >= b.seconds >= c.seconds >= 0


def test_counters_add_up_and_outlive_the_ring():
    """``count`` adds to its counter, ``counters()`` is a snapshot, and a
    counter stays when the ring evicts the spans it was counted in."""
    with profiling.span("t.root"):
        profiling.count("t.n")
        profiling.count("t.n", 2)
        profiling.count("t.ns", 1000)
    snap = profiling.counters()
    snap["t.n"] = -1
    for _ in range(profiling.RING_SPANS):
        with profiling.span("t.fill"):
            pass
    assert profiling.counters()["t.n"] == 3
    assert profiling.counters()["t.ns"] == 1000


def test_duration_keeps_its_opening_offset(monkeypatch):
    """A span's two stamps share the clock offset it found at its open: a
    root opened meanwhile (another thread's request) takes a new offset,
    which moves neither the open span's stamps nor its seconds."""
    with profiling.span("t.open") as s:
        monkeypatch.setattr(profiling, "_offset_ns",
                            profiling._offset_ns + 10 ** 9)
    assert 0 <= s.seconds < 0.5
    assert abs(s.start_ns - profiling.time.time_ns()) < 10 ** 9 // 2


def test_ring_holds_at_most_its_bound():
    n = profiling.RING_SPANS
    with profiling.span("t.first") as first:
        pass
    for _ in range(n + 10):
        with profiling.span("t.fill"):
            pass
    ring = profiling.spans()
    assert len(ring) == n
    assert all(s.name == "t.fill" for s in ring)
    assert first not in ring


def test_recording_off_keeps_nothing():
    before = profiling.spans()
    counts = profiling.counters()
    profiling.set_recording(False)
    try:
        with profiling.span("t.off") as s:
            with profiling.span("t.off_child"):
                pass
        seconds = {}
        with profiling.timed("t.off_timed", seconds, "k"):
            pass
    finally:
        profiling.set_recording(True)
    assert _new(before) == [] and profiling.counters() == counts
    assert s.id is None and s.seconds >= 0 and seconds["k"] >= 0


def test_threads_keep_their_own_trees_and_every_count():
    """More threads than cores, with a short switch interval, each opening
    nested spans and counting: every span's parent is of its own thread,
    and no count is lost."""
    import sys
    import threading
    threads, rounds, counts = 16, 100, 50
    seen, errors = {}, []

    def work(k):
        try:
            for _ in range(rounds):
                with profiling.span("t.thread", k=k) as root:
                    with profiling.span("t.inner", k=k) as inner:
                        for _ in range(counts):
                            profiling.count("t.stress")
                    if inner.parent != root.id or root.parent is not None:
                        errors.append(k)
                seen[k] = seen.get(k, 0) + 1
        except Exception as e:      # reported by the assertion below
            errors.append(repr(e))

    before = profiling.counters().get("t.stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert errors == []
    assert seen == {k: rounds for k in range(threads)}
    assert profiling.counters()["t.stress"] - before == \
        threads * rounds * counts


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler running a span opens no profiler range; under
    ``torch.profiler.profile`` its range is in the trace, as a host event
    (the scope aten's operators have, not ``record_function``'s user
    scope)."""
    calls = []
    real = profiling._host_range

    def counting(name, *a):
        calls.append(name)
        return real(name, *a)

    monkeypatch.setattr(profiling, "_host_range", counting)
    with profiling.span("t.plain"):
        torch.ones(8).sum()
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("t.profiled"):
            torch.ones(8).sum()
    assert calls == ["t.profiled"]
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "t.profiled"]
    assert "CPU" in str(event.device_type())
    assert event.scope() != int(torch._C._profiler.RecordScope.USER_SCOPE)


def test_stamps_on_the_profilers_clock():
    """An op run inside a span has its profiler event within the span's
    stamps, and the span's range (opened before its first stamp, closed
    after its last) holds them, to 50 us."""
    a = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("t.clock") as s:
                a @ a
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == "aten::mm"][-1]
    rng = [e for e in events if e.name() == "t.clock"][-1]
    assert s.start_ns - CLOCK_SLACK_NS <= mm.start_ns()
    assert mm.end_ns() <= s.end_ns + CLOCK_SLACK_NS
    assert rng.start_ns() - CLOCK_SLACK_NS <= s.start_ns
    assert s.end_ns <= rng.end_ns() + CLOCK_SLACK_NS


# ---------------------------------------------------------------------------
# the program's spans, on the CPU
# ---------------------------------------------------------------------------


def _tiny_inputs(models, b=1, h=64, w=48, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    img = lambda: torch.rand(b, h, w, 3, generator=g, device=device) * 2 - 1
    ids = lambda: torch.randint(0, models.clip_l_cfg.vocab_size, (b, 77),
                                generator=g, device=device)
    isz = models.vision_cfg.image_size
    mask = torch.zeros(b, h, w, 1, device=device)
    mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 1
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                ip_pixels=torch.rand(b, isz, isz, 3, generator=g,
                                     device=device) * 2 - 1,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids())


def test_stepwise_generate_request_spans():
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
    steps = 3
    models = TryonModels.init(0, tiny=True, dtype=torch.float32,
                              device="cpu")
    fn = TryonPipeline(models).stepwise_generate(num_steps=steps)
    before = profiling.spans()
    phases = {}
    fn(torch.Generator().manual_seed(1), phase_seconds=phases,
       **_tiny_inputs(models))
    by, root = _tree(_new(before))
    assert root.name == "serve.request"
    enc, den, dec = by["serve.encode"][0], by["serve.denoise"][0], \
        by["serve.decode"][0]
    assert {s.parent for s in (enc, den, dec)} == {root.id}
    assert enc.end_ns <= den.start_ns and den.end_ns <= dec.start_ns
    for name in ("encode.text", "encode.vision", "encode.vae"):
        assert [s.parent for s in by[name]] == [enc.id], name
    step_spans = by["serve.step"]
    assert len(step_spans) == steps
    assert all(s.parent == den.id and s.attrs == {"mode": "eager"}
               for s in step_spans)
    assert "graph.lookup" not in by          # the CPU loop runs eagerly
    assert phases == {"encode": enc.seconds, "denoise": den.seconds,
                      "decode": dec.seconds}


def test_train_step_spans():
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        init_train_state, make_optimizer, make_train_step,
    )
    models = TryonModels.init(0, micro=True, device="cpu",
                              dtype=torch.float32)
    tx = make_optimizer(learning_rate=1e-3, optimizer="adamw8bit")
    state = init_train_state(models, tx)
    step = make_train_step(models, DDPMScheduler(SchedulerConfig.train()),
                           tx, compute_dtype=torch.float32, remat=False)
    g = torch.Generator().manual_seed(0)
    img = lambda: torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
    ids = lambda: torch.randint(0, 1000, (2, 7), generator=g)
    batch = dict(person=img(), pose=img(), cloth=img(),
                 mask=(torch.rand(2, 32, 32, 1, generator=g) > 0.5).float(),
                 prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                 cloth_ids_g=ids(),
                 ip_pixels=torch.rand(2, 28, 28, 3, generator=g) * 2 - 1)
    before = profiling.spans()
    step(state, batch, torch.Generator().manual_seed(1))
    by, root = _tree(_new(before))
    assert root.name == "train.step"
    fwd, bwd, opt = (by[f"train.{n}"][0]
                     for n in ("forward", "backward", "optimizer"))
    assert {s.parent for s in (fwd, bwd, opt)} == {root.id}
    assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= opt.start_ns
    for name in ("frozen", "garment", "tryonnet"):
        assert [s.parent for s in by[f"train.{name}"]] == [fwd.id], name
    waits = by["train.wait"]
    assert sorted(s.parent for s in waits) == sorted([fwd.id, opt.id])


@pytest.fixture(scope="module")
def service():
    from idmvton_tpu_torch.cli import demo
    return demo.TryonService(argparse.Namespace(
        width=48, height=64, pretrained=None, tokenizer_dir=None, tiny=True,
        examples_dir=None, device="cpu"))


def _photos(seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    photo = lambda: Image.fromarray(rng.integers(0, 255, (64, 48, 3),
                                                 dtype=np.uint8))
    mask = Image.fromarray((rng.random((64, 48)) > 0.5).astype(np.uint8)
                           * 255)
    return photo(), photo(), mask


def test_tryon_service_stage_spans(service):
    """A drawn-mask request through ``TryonService.tryon``: one root
    ``demo.request``, each stage the span ``demo.<stage>`` under it,
    ``stage_seconds`` keyed as before and equal to the stages' spans, the
    try-on's ``serve.request`` inside ``demo.tryon``."""
    person, garment, mask = _photos(0)
    before = profiling.spans()
    stages = {}
    service.tryon(person, garment, "shirt", auto_mask=False,
                  mask_image=mask, steps=2, seed=1, stage_seconds=stages)
    by, root = _tree(_new(before))
    assert root.name == "demo.request"
    assert list(stages) == ["crop", "densepose", "tryon"]
    for name, seconds in stages.items():
        (s,) = by[f"demo.{name}"]
        assert s.parent == root.id and s.seconds == seconds
    (request,) = by["serve.request"]
    assert request.parent == by["demo.tryon"][0].id
    assert all(s.name.startswith(("demo.", "serve.", "encode.",
                                  "densepose.")) for s in sum(by.values(),
                                                              []))


# each net's device part and host part, and the stage that holds them
NET_SPANS = {"openpose.net": "demo.openpose",
             "openpose.decode": "demo.openpose",
             "parsing.net": "demo.parsing", "parsing.post": "demo.parsing",
             "mask.build": "demo.mask", "densepose.net": "demo.densepose",
             "densepose.paint": "demo.densepose"}


def test_preprocessing_spans_nest_in_their_stages(service, monkeypatch):
    """An auto-mask request: each net's spans under its ``demo.<stage>``
    (SCHP's ``parsing.net`` once for ATR and once for LIP), the host part
    after the device part, each a range of the host's timeline alone
    under a profiler; ``densepose.detections`` counted once a request,
    by the detections DensePose kept."""
    from idmvton_tpu_torch.preprocess.densepose import visualize
    person, garment, _ = _photos(2)
    counts = []
    real = visualize.count

    def counting(name, n=1):
        counts.append((name, n))
        real(name, n)

    monkeypatch.setattr(visualize, "count", counting)
    kept = []
    outputs = service.densepose._outputs
    monkeypatch.setattr(service.densepose, "_outputs", lambda image: (
        kept.append(outputs(image)) or kept[-1]))
    before = profiling.spans()
    total = profiling.counters().get("densepose.detections", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        service.tryon(person, garment, "shirt", auto_mask=True, steps=1,
                      seed=3)
    by, root = _tree(_new(before))
    assert root.name == "demo.request"
    for name, stage in NET_SPANS.items():
        (parent,) = by[stage]
        assert by[name] and all(s.parent == parent.id for s in by[name]), \
            name
    assert [s.attrs for s in by["parsing.net"]] == [{"net": "atr"},
                                                     {"net": "lip"}]
    for net, host in (("openpose.net", "openpose.decode"),
                      ("densepose.net", "densepose.paint")):
        assert by[net][0].end_ns <= by[host][-1].start_ns
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() in NET_SPANS]
    assert {e.name() for e in ranges} == set(NET_SPANS)
    assert all("CPU" in str(e.device_type()) for e in ranges)
    valid = int(kept[-1]["valid"].sum())
    assert counts == [("densepose.detections", valid)]
    assert profiling.counters()["densepose.detections"] - total == valid


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn", "auto"])
def test_lock_wait_counts_in_the_first_stage(service, drawn):
    """A request that waits for ``TryonService.lock`` counts the wait in
    its first stage after the crop (densepose with a drawn mask, openpose
    with the auto mask), and every stage still has its key."""
    import threading
    import time
    person, garment, mask = _photos(1)
    stages, errors = {}, []

    def request():
        try:
            service.tryon(person, garment, "shirt", auto_mask=not drawn,
                          mask_image=mask, steps=1, seed=2,
                          stage_seconds=stages)
        except Exception as e:      # reported by the assertion below
            errors.append(repr(e))

    wait = 0.5
    with service.lock:
        t = threading.Thread(target=request)
        t.start()
        time.sleep(wait)
    t.join(timeout=300)
    assert not t.is_alive() and errors == []
    first = "densepose" if drawn else "openpose"
    assert list(stages) == (["crop", "densepose", "tryon"] if drawn else
                            ["crop", "openpose", "parsing", "mask",
                             "densepose", "tryon"])
    assert stages[first] >= wait * 0.9
    assert stages["crop"] < wait * 0.9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_launch_inside_its_span(dev):
    """The host event of a kernel launched inside a span lies within the
    span's stamps, on the device trace's clock; the span's range is on the
    host's timeline alone."""
    x = torch.randn(256, 640, device=dev, dtype=torch.bfloat16)
    scale = torch.ones(640, device=dev)
    bias = torch.zeros(640, device=dev)
    cuda_norm.fused_layer_norm(x, scale, bias)       # build and load first
    torch.cuda.synchronize(dev)
    with profiling.trace() as prof:
        with profiling.span("t.kernel") as s:
            cuda_norm.fused_layer_norm(x, scale, bias)
        torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()
    launches = [e for e in events if "LaunchKernel" in e.name()]
    assert launches
    assert any(s.start_ns <= e.start_ns() and e.end_ns() <= s.end_ns
               for e in launches)
    # the range is a host event only: nothing of the span's name on the
    # device's timeline, where a device trace would count it as busy
    mine = [str(e.device_type()) for e in events if e.name() == "t.kernel"]
    assert len(mine) == 1 and "CPU" in mine[0]


@pytest.mark.cuda
def test_request_counts_captures_and_replays(dev):
    """The first ``jit_generate`` request captures the step once (its first
    ``serve.step``, holding ``graph.capture``, and the counter
    ``graph.capture_ns``) and replays the rest; a second replays every
    step and captures nothing."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
    steps = 3
    models = TryonModels.init(0, tiny=True, device=dev, dtype=torch.bfloat16)
    fn = TryonPipeline(models).jit_generate(num_steps=steps)
    inputs = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in _tiny_inputs(models, b=2, h=256, w=192,
                                       device=dev).items()}
    runs = []
    with torch.inference_mode():
        for i in range(2):
            before = profiling.spans()
            ns = profiling.counters().get("graph.capture_ns", 0)
            fn(torch.Generator(device=dev).manual_seed(i), **inputs)
            by, _ = _tree(_new(before))
            runs.append((by, profiling.counters()["graph.capture_ns"] - ns))
    (by1, ns1), (by2, ns2) = runs
    assert [s.attrs["mode"] for s in by1["serve.step"]] == \
        ["capture"] + ["replay"] * (steps - 1)
    (capture,) = by1["graph.capture"]
    assert capture.parent == by1["serve.step"][0].id
    assert ns1 == capture.end_ns - capture.start_ns > 0
    assert [s.attrs["mode"] for s in by2["serve.step"]] == ["replay"] * steps
    assert "graph.capture" not in by2 and ns2 == 0
