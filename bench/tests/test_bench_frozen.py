"""The benchmark's frozen copies: the stream generator yields the port's
arrays bit for bit, and the roofline counts hold the values PERF.md's
kernel table prints for its shapes. And what the cells read of their
family stays as it was before families were modules (pinned from the
code of that commit): the drawn weights, the weight lists, the served
logits of the plain reference bit for bit on the CPU, and the model
FLOPs and kernel calls at the cells' shapes."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.harness import port, weights
from bench.harness.cell import load_family
from bench.roofline import counts, peaks
from bench.traffic import streams

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def full(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def smoke(name: str) -> dict:
    return json.loads((BENCH / "tests" / "data" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("n_regions,seed", [(4, 0), (4, 123), (128, 1)])
def test_multi_region_stream_matches_the_port(n_regions, seed):
    from repro_torch.serve import streams as port

    got = streams.multi_region_stream(20_000, n_regions, seed=seed)
    want = port.multi_region_stream(20_000, n_regions, seed=seed)
    for k, v in got[0].items():
        np.testing.assert_array_equal(v, getattr(want[0], k))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_diurnal_hours_matches_the_port():
    from repro_torch.serve import streams as port

    a = streams.diurnal_hours(np.random.default_rng(5), 20_000, peak=7.0)
    b = port.diurnal_hours(np.random.default_rng(5), 20_000, peak=7.0)
    np.testing.assert_array_equal(a, b)


# (call, args, flops, bytes): PERF.md section 6's shapes
KERNEL_COUNTS = [
    ("flash", (4, 512, 32, 8, 80, None, 4), 5.379e9, 52_428_800),
    ("flash", (4, 512, 32, 4, 128, None, 2), None, 37_748_736),
    ("gmm", (128, 160, 2048, 768, 2), 64.42e9, 517_996_544),
    ("gmm", (128, 8, 2048, 768, 2), None, 408_420_352),
    ("gmm", (16, 320, 4096, 14336, 2), 601.3e9, 2_067_791_872),
    ("gmm", (16, 8, 4096, 14336, 2), None, 1_883_766_784),
    ("ssd", (4, 512, 48, 64, 128, 256, 4), 4.03e9, None),
    ("ssd", (4, 512, 128, 64, 16, 128, 2), None, 70_386_688),
]


@pytest.mark.parametrize("kind,args,flops,nbytes", KERNEL_COUNTS)
def test_kernel_counts(kind, args, flops, nbytes):
    f, b = getattr(counts, f"{kind}_call")(*args)
    if flops is not None:
        assert f == pytest.approx(flops, rel=2e-3)
    if nbytes is not None:
        assert b == nbytes


def test_bounds_and_peaks():
    f, b = counts.flash_call(4, 512, 32, 8, 80, None, 4)
    assert peaks.least_seconds(f, b, "float32") == pytest.approx(80.3e-6, rel=2e-3)
    f, b = counts.gmm_call(16, 320, 4096, 14336, 2)
    assert peaks.least_seconds(f, b, "bfloat16") == pytest.approx(617.3e-6, rel=2e-3)
    assert peaks.flops("float32") == 67e12


def test_causal_pairs_and_capacity():
    assert counts.causal_pairs(512, None) == 512 * 513 // 2
    assert counts.causal_pairs(10, 4) == 1 + 2 + 3 + 4 * 7
    m = {"moe_group_size": 1024, "moe_capacity_factor": 1.25,
         "experts_per_token": 2, "n_experts": 16}
    assert counts.moe_capacity(m, 4 * 512) == (2, 160)
    assert counts.moe_capacity(m, 4 * 1536) == (6, 160)
    assert counts.moe_capacity(m, 4) == (1, 8)


def test_model_flops_danube():
    cfg = full("h2o-danube-1.8b")
    fam = load_family(cfg)
    # PERF.md's training table: 21.88 TFLOP a (4, 512) step
    assert fam.train_flops(cfg, 4, 512) == pytest.approx(21.88e12, rel=1e-3)
    d = fam.decode_flops(cfg, 16, 1000)
    assert 2 * 16 * 1.8e9 < d < 2 * 16 * 1.9e9


# sha256 of every tensor drawn on seed 0, and of the served logits of one
# fixed batch (2 x 46 tokens, prompt 40) on seed 0's weights
SMOKE_PINS = {
    "danube-smoke": (
        "9d93ee9a9854042fae972f0d07959f938f2099111cdd80436227f0299713ee9b",
        "57039c9160ebd249e4c9144e2242a34738869c2c82919a89b920ffbeabb42c7d"),
    "jamba-smoke": (
        "419bb4fef19f5cb09b9595b0d130bc9b2e048750b8302941d3ef849789aa0415",
        "c7dd98d6f269c491fb59e7a787ce187df896fc577fcb39f59ef0ba88b1f1849e"),
    "danube-smoke-bf16": (
        "e6352e881a4a2947317d385a2e28a65b3006716f2c982f0a7b2c3dab36eac546",
        "7695fb978a8cf2d776eb3804fb30009d6fcc210a6f01ec6c91160f6f84792207"),
}
# (tensors, sha256 of the weight list), sha256 of the counts at the cells'
# shapes (``CELL_SHAPES``)
FULL_PINS = {
    "h2o-danube-1.8b": (
        (219, "28b9f4bc553d8ce4f62d6a5a68562b166ee6739491604336f85b910df3fac9dc"),
        "8272bc810ee01be29396aa32f660e160b1d11f18b97c40b6cd6a1a125b696501"),
    "jamba-v0.1-52b": (
        (281, "553723d950fc8aa93897496163f5e9f17999ecc3c797a8673f7df3c41d8e8811"),
        "b1e7a4d4e655b8311a16b9377ac3e219e5e8ae43f67c28174c91b02b8cc428d9"),
}
# batch, [(prompt, new)] of the serving cell, (batch, seq) of a step
CELL_SHAPES = {
    "h2o-danube-1.8b": (16, [(256, 512), (128, 256), (384, 128), (1024, 128),
                             (768, 512), (512, 256)], (4, 512)),
    "jamba-v0.1-52b": (4, [(1024, 16), (1536, 16), (2048, 16), (3072, 16),
                           (4096, 16)], (4, 1024)),
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(SMOKE_PINS))
def test_drawn_weights_are_pinned(name, one_thread):
    cfg = smoke(name)
    fam, m = load_family(cfg), cfg["model"]
    h = hashlib.sha256()
    for g in fam.groups(m):
        for n, t in weights.draw(fam, m, getattr(torch, cfg["dtype"]), 0, g,
                                 CPU).items():
            h.update(f"{n}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(_digest(t))
    assert h.hexdigest() == SMOKE_PINS[name][0]


@pytest.mark.parametrize("name", sorted(SMOKE_PINS))
def test_served_logits_are_pinned(name, one_thread):
    cfg = smoke(name)
    fam = load_family(cfg)
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg["model"]["vocab_size"], (2, 46), generator=g)
    (out,) = fam.served_logits(cfg, port.draw_fn(cfg, fam, 0, CPU),
                               [(toks, 40)])
    assert hashlib.sha256(_digest(out)).hexdigest() == SMOKE_PINS[name][1]


@pytest.mark.parametrize("name", sorted(FULL_PINS))
def test_weight_lists_are_pinned(name):
    cfg = full(name)
    fam, m = load_family(cfg), cfg["model"]
    rows = [[g, n, list(s), str(dt), list(init)] for g in fam.groups(m)
            for n, s, dt, init in fam.group_specs(
                m, getattr(torch, cfg["dtype"]), g)]
    assert (len(rows), hashlib.sha256(json.dumps(rows).encode()).hexdigest()
            ) == FULL_PINS[name][0]


@pytest.mark.parametrize("name", sorted(FULL_PINS))
def test_model_counts_are_pinned(name):
    """What ``mfu.*`` and ``*_roofline.*`` read: each prefill's FLOPs, each
    batch's decode FLOPs summed over its steps, the kernel calls of a
    prefill and a decode step, and a training step's FLOPs."""
    cfg = full(name)
    fam = load_family(cfg)
    B, cycle, (tb, ts) = CELL_SHAPES[name]
    vals = []
    for S, new in cycle:
        vals.append(["prefill", S, fam.prefill_flops(cfg, B, S)])
        vals.append(["decode", S, sum(fam.decode_flops(cfg, B, S + s)
                                      for s in range(new - 1))])
        for ph in ("prefill", "decode"):
            vals.append([ph, S, fam.layer_calls(cfg, B, S, ph)])
    vals.append(["train", ts, fam.train_flops(cfg, tb, ts)])
    assert hashlib.sha256(json.dumps(vals, sort_keys=True).encode()
                          ).hexdigest() == FULL_PINS[name][1]
