"""The demo cell (``demo.raw_photos_b1``): its files by name, the generator
at a tiny configuration on the CPU (the try-on stack tiny, the three nets
at their published widths, DensePose at the demo's tiny capacities), the
faults the check has to refuse, the readers without spans, and the frozen
counts of the nets against brute force."""

import copy
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.count import preprocess as count
from benchmark.harness import common, demo, spans
from benchmark.reference import preprocess as ref
from benchmark.reference import stack as S

NAME = "demo.raw_photos_b1"
TESTS = common.BENCH / "tests"
CPU = torch.device("cpu")
SEED = 3_000_000_021
READERS = ("preprocess_s", "openpose_s", "parsing_s", "densepose_s",
           "preprocess_host_s", "densepose_detections", "idle_share.demo",
           "mfu.demo", "conv3x3_roofline.preprocess", "step_device_ms.demo",
           "tryon_s", "encode_s.demo")


def tiny_demo() -> dict:
    cell = common.cell(NAME)
    return copy.deepcopy(dict(
        cell, workload=dict(cell["workload"], name="tiny.demo"),
        config=common.load_json(TESTS / "tiny_demo.json"),
        traffic=common.load_json(TESTS / "tiny_demo_traffic.json"),
        limits=common.load_json(TESTS / "tiny_demo_limits.json")))


@pytest.fixture(scope="module", autouse=True)
def four_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


def test_cell_resolves_by_name():
    cell = common.cell(NAME)
    assert cell["traffic"]["generator"] == "demo"
    assert {m["name"] for m in cell["end_to_end"]} == {
        "setup_s", "request_s", "request_s.p95", "peak_gib"}
    assert [m["name"] for m in cell["per_layer"]] == list(READERS)
    for m in READERS:
        assert callable(common.reader(m).read)
    specs = ref.param_specs(cell["config"]["nets"])
    assert set(specs) == set(demo.NETS)
    assert set(cell["limits"]) == {
        "openpose_rel", "parsing_rel", "fpn_rel", "box_logit_rel",
        "box_fc_rel", "dp_head_rel", "encode_ratio", "step_ratio", "decode_rel",
        "narrow_tensors"}


@pytest.fixture(scope="module")
def measured():
    """(cell, line, the generator's result) of one tiny untraced run."""
    cell = tiny_demo()
    kept = []
    mp = pytest.MonkeyPatch()
    orig = demo.run

    def keeping(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    mp.setattr(demo, "run", keeping)
    try:
        line = run.measure(cell, SEED, 0.0, 0, CPU)
    finally:
        mp.undo()
    return cell, line, kept[0]


def test_tiny_request_is_correct(measured):
    _, line, res = measured
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "request_s", "request_s.p95",
                                    "peak_gib"}
    assert res["readings"]["narrow_tensors"] == 0


@pytest.mark.parametrize("metric", ["preprocess_s", "openpose_s",
                                    "parsing_s", "densepose_s",
                                    "preprocess_host_s",
                                    "densepose_detections", "mfu.demo",
                                    "tryon_s", "encode_s.demo"])
def test_untraced_readers_read(measured, metric):
    cell, _, res = measured
    res = dict(res, done=[dict(r, traced=False) for r in res["done"]])
    value = common.reader(metric).read(cell, res)
    assert value is not None and math.isfinite(value) and value >= 0


def test_preprocess_is_the_four_stages(measured):
    cell, _, res = measured
    total = common.reader("preprocess_s").read(cell, res)
    parts = sum(common.reader(m).read(cell, res)
                for m in ("openpose_s", "parsing_s", "densepose_s"))
    mask = spans.mean_of(res, "demo.request",
                         lambda s: spans.seconds(s, "demo.mask"))
    assert total == pytest.approx(parts + mask)


@pytest.mark.parametrize("metric", READERS)
def test_readers_without_spans_read_none(measured, monkeypatch, metric):
    cell, _, res = measured
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    res = dict(res, trace=None, detections=None)
    if metric == "mfu.demo":    # a host-clock metric: needs no span
        assert common.reader(metric).read(cell, res) is not None
    else:
        assert common.reader(metric).read(cell, res) is None


def test_readers_of_a_program_without_the_demo_root(measured, monkeypatch):
    """The parent's ring (stage spans as roots, no ``demo.request``)."""
    cell, _, res = measured
    from idmvton_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in profiling._ring if s.name != "demo.request"])
    for m in ("preprocess_s", "openpose_s", "preprocess_host_s", "tryon_s",
              "encode_s.demo"):
        assert common.reader(m).read(cell, res) is None


@pytest.fixture(scope="module")
def faults():
    return demo.fault_readings(tiny_demo(), SEED, CPU)


@pytest.mark.parametrize("fault", ["logits_x1.05", "heatmaps_stage5",
                                   "lip_for_atr"])
def test_planted_fault_fails(faults, fault):
    limits = tiny_demo()["limits"]
    correct, checks = common.judge(faults[fault], limits)
    assert correct is False
    bad = [c["name"] for c in checks if not c["value"] <= c["limit"]]
    want = {"logits_x1.05": ["parsing_rel"], "lip_for_atr": ["parsing_rel"],
            "heatmaps_stage5": ["openpose_rel"]}[fault]
    assert bad == want


@pytest.fixture(scope="module")
def bf16_control():
    return demo.operand_control(tiny_demo(), SEED, CPU, "bf16", tryon=False)


def test_bf16_control_fails_the_stated_fp32_classes(measured, bf16_control):
    """The reference with bf16 operands in the program's place: the box
    head's FCs (stated fp32) and OpenPose's maps (their 7x7 and 1x1 convs
    stated TF32) fail, where the program passes them."""
    limits = tiny_demo()["limits"]
    readings, _ = bf16_control
    correct, checks = common.judge(readings, limits)
    assert correct is False
    bad = {c["name"] for c in checks if not c["value"] <= c["limit"]}
    assert {"box_fc_rel", "openpose_rel"} <= bad
    program = measured[2]["readings"]
    assert program["box_fc_rel"] <= limits["box_fc_rel"]
    assert program["openpose_rel"] <= limits["openpose_rel"]


# ---------------------------------------------------------------------------
# the frozen counts against brute force (PyTorch's FLOP counter on the
# reference)
# ---------------------------------------------------------------------------


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def nets():
    return tiny_demo()["config"]["nets"]


def _root(nets, component):
    spec = {component: ref.param_specs(nets)[component]}
    return S.Root(common.make_weights(spec, SEED, CPU, torch.float32))


def test_openpose_counts(nets):
    x = torch.zeros(1, 64, 48, 3)
    W = _root(nets, "openpose").sub("openpose")
    want = counted(lambda: ref.openpose(W, nets["openpose"], x))
    assert sum(s["ops"] for s in count.openpose_sites(
        nets["openpose"], 64, 48)) == want


@pytest.mark.parametrize("which,size", [("atr", 64), ("lip", 59)])
def test_schp_counts(nets, which, size):
    """The fusion logits' path, plus the branches the served net also
    computes: the decoder's parsing logits and the edge logits."""
    cfg = nets["schp"]
    W = _root(nets, f"schp_{which}").sub(f"schp_{which}")
    want = counted(lambda: ref.schp(W, cfg, torch.zeros(1, size, size, 3)))
    sites = count.schp_sites(cfg, cfg[f"{which}_classes"], size)
    assert sum(s["ops"] for s in sites if s["name"] not in (
        "parsing_logits", "edge_logits")) == want


def test_densepose_counts(nets):
    cfg = nets["densepose"]
    h, w = count.densepose_input(cfg, (64, 48))
    W = _root(nets, "densepose").sub("densepose")
    x = torch.zeros(1, h, w, 3)
    boxes = torch.tensor([[0.0, 0.0, 20.0, 30.0]]).repeat(
        cfg["rpn_post_nms_topk"], 1)
    dets = boxes[:cfg["num_detections"]]
    ps = ref.resnet50_fpn(W, x)

    def rpn():
        for p in ps:
            h_ = torch.relu(ref.conv(W.sub("rpn.conv"), p))
            ref.conv(W.sub("rpn.objectness"), h_)
            ref.conv(W.sub("rpn.deltas"), h_)

    def box_head():
        s = ref.box_scores(W, cfg, ps, boxes)
        S.linear(W.sub("box_head.reg"), torch.zeros(boxes.shape[0],
                                                    cfg["box_fc"]))
        return s

    dec = ref.decoder(W, ps)
    want = (counted(lambda: ref.resnet50_fpn(W, x)) + counted(rpn)
            + counted(box_head) + counted(lambda: ref.decoder(W, ps))
            + counted(lambda: ref.densepose_head(W, cfg, dec, dets,
                                                 chunk=cfg["dp_chunk"])))
    assert sum(s["ops"] for s in count.densepose_sites(cfg, h, w)) == want


def test_conv_kernel_sites_are_the_ports():
    """``count.conv_kernel_site`` says what the port's dispatch says
    (``models/layers._conv2d``: 3x3, stride 1, padded 1, then the conv
    kernels' shape predicate) for every site of the served nets."""
    from idmvton_tpu_torch.ops import cuda_conv
    cell = common.cell(NAME)
    t = cell["traffic"]
    sites = count.request_sites(cell["config"]["nets"],
                                (t["height"], t["width"]))
    n = 0
    for s in sites:
        if s["kind"] != "conv":
            continue
        b, h, w, cin, cout = s["shape"]
        x = torch.empty(b, h, w, cin, device="meta")
        k = torch.empty(s["k"], s["k"], cin, cout, device="meta")
        port = (s["stride"] == 1 and s["k"] == 3 and s["pad"] == 1
                and s["dilation"] == 1 and (
                    cuda_conv.conv3x3_supported(x, k)
                    or cuda_conv.conv3x3_hblock_supported(x, k)))
        assert count.conv_kernel_site(s) == port, s
        n += port
    assert n > 50
