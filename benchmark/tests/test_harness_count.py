"""The frozen counts of ``benchmark/count/flops.py`` against brute-force
counts at tiny shapes: the operations PyTorch's FLOP counter reads off the
fp32 reference, and the bytes of the tensors themselves."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.count import flops
from benchmark.harness import common, serve, train
from benchmark.reference import stack as ref
from benchmark.reference import train as ref_train
from benchmark.reference.scheduler import DDPM

TESTS = common.BENCH / "tests"


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_ln_linear_counts():
    g = torch.Generator().manual_seed(0)
    for m, c, n, geglu in ((48, 32, 96, False), (48, 32, 256, True)):
        x = torch.randn(m, c, generator=g).bfloat16()
        w = torch.randn(c, n, generator=g).bfloat16()
        gamma, beta = torch.ones(c), torch.zeros(c)
        bias = torch.zeros(n).bfloat16()
        out = torch.empty(m, n // 2 if geglu else n).bfloat16()
        ops, nbytes = flops.ln_linear(m, c, n, geglu=geglu, bias=True)
        assert ops == counted(lambda: torch.nn.functional.layer_norm(
            x.float(), (c,)) @ w.float())
        assert nbytes == sum(t.numel() * t.element_size()
                             for t in (x, w, gamma, beta, bias, out))


def test_conv3x3_counts():
    g = torch.Generator().manual_seed(1)
    b, h, w, cin, cout = 2, 6, 5, 8, 16
    x = torch.randn(b, h, w, cin, generator=g).bfloat16()
    k = torch.randn(3, 3, cin, cout, generator=g).bfloat16()
    bias = torch.zeros(cout).bfloat16()
    out = torch.empty(b, h, w, cout).bfloat16()
    p = ref.Weights({"c.kernel": k, "c.bias": bias}, "c")
    ops, nbytes = flops.conv(b, h, w, cin, cout)
    assert ops == counted(lambda: ref.conv(p, x.float()))
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in (x, k, bias, out))


def test_attention_over_own_and_garment_keys():
    g = torch.Generator().manual_seed(2)
    b, heads, s, d = 2, 3, 10, 8
    q = torch.randn(b, s, heads, d, generator=g)
    k = torch.randn(b, 2 * s, heads, d, generator=g)
    assert flops.attention(b, heads, s, 2 * s, d) == counted(
        lambda: ref.attention(q, k, k))


@pytest.fixture(scope="module")
def tiny_serve():
    cfg = common.load_json(TESTS / "tiny_serve.json")
    traffic = common.load_json(TESTS / "tiny_serve_traffic.json")
    return {"config": cfg, "traffic": traffic}


def test_request_ops_equal_the_references_count(tiny_serve):
    cfg, traffic = tiny_serve["config"], tiny_serve["traffic"]
    stack, dev = cfg["stack"], torch.device("cpu")
    W = ref.Root(common.make_weights(ref.param_specs(stack), 3, dev))
    req = serve.make_request(stack, traffic, 3, 0, dev)
    lat = req["noise"]["init_noise"]
    vae_noise = torch.randn((3 * traffic["batch"],) + lat.shape[1:])
    sched = DDPM(cfg["scheduler"])
    ts, _ = sched.timesteps(traffic["steps"])

    def request():
        cond = serve.ref_encode(W, stack, req["inputs"], vae_noise)
        for t in ts:
            serve.ref_guided_eps(W, stack, cond, lat, int(t), 2.0)
        ref.vae_decode(W.sub("vae"), stack["vae"], lat)

    with torch.no_grad():
        assert flops.request_ops(stack, traffic) == counted(request)


def test_train_step_ops_within_the_autograd_count():
    """Model operations count a trained product's backward as twice its
    forward; autograd skips the input gradients of the first products (the
    data needs none), so its count is a little lower."""
    cfg = common.load_json(TESTS / "tiny_train.json")
    traffic = common.load_json(TESTS / "tiny_train_traffic.json")
    stack, dev = cfg["stack"], torch.device("cpu")
    flat = common.make_weights(ref.param_specs(stack), 4, dev)
    masters = {n: t.float().requires_grad_() for n, t in flat.items()
               if n.split(".")[0] in ref_train.TRAINED}
    W = ref.Root(dict(flat, **masters))
    batch, vae_seed = train.make_batch(stack, traffic, 4, 0, dev)
    vae_noise = train.vae_draw(batch, vae_seed, dev)
    rows = list(range(traffic["batch"]))

    def step():
        ref_train.row_losses(W, stack, DDPM(cfg["scheduler"]), batch,
                             vae_noise, rows, remat=False).sum().backward()

    want = flops.train_step_ops(stack, traffic)
    got = counted(step)
    assert 0.97 * want <= got <= want
