"""The benchmark's frozen copies: the stream generator yields the port's
arrays bit for bit, and the roofline counts hold the values PERF.md's
kernel table prints for its shapes."""

import numpy as np
import pytest

from bench.roofline import counts, peaks
from bench.traffic import streams


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
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "h2o-danube-1.8b.json").read_text())
    # PERF.md's training table: 21.88 TFLOP a (4, 512) step
    assert counts.train_flops(cfg, 4, 512) == pytest.approx(21.88e12, rel=1e-3)
    d = counts.decode_flops(cfg, 16, 1000)
    assert 2 * 16 * 1.8e9 < d < 2 * 16 * 1.9e9
