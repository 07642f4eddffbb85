"""The port's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips on a host without a CUDA device. On the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [(2, 64, 4, 2, 32, None),
               (1, 128, 8, 8, 64, None),
               (2, 64, 4, 1, 16, 16),
               (1, 96, 6, 3, 32, 32),
               (1, 256, 2, 1, 128, None),
               (2, 96, 4, 2, 16, 32),
               (1, 96, 4, 1, 80, 40),
               (4, 512, 32, 8, 80, 4096),  # h2o-danube-1.8b prefill
               (1, 200, 4, 4, 8, 1)]  # window 1: each row sees itself only
NORM_SHAPES = [(4, 37, 96), (1, 8, 8, 64), (4, 2560), (2048, 2560),
               (3, 5, 1000)]
SSD_CASES = [(2, 64, 8, 16, 16, 16, False),  # tests/test_kernels.py sweep
             (1, 128, 16, 32, 32, 32, False),
             (2, 96, 4, 8, 8, 24, False),
             (1, 64, 8, 64, 128, 16, False),
             (1, 32, 4, 8, 16, 8, True),  # from an initial state
             (2, 100, 8, 64, 128, 32, True),  # ragged S
             (1, 70, 4, 16, 16, 256, False)]  # S shorter than the chunk
GMM_CASES = [(4, 32, 64, 48), (8, 16, 32, 32), (2, 128, 128, 128),
             (16, 8, 16, 8), (3, 70, 100, 130), (8, 8, 2048, 768)]


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else \
        dict(atol=5e-4, rtol=5e-4)


def _rand(rng, shape, name, device):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=TORCH_DTYPES[name])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("b,s,h,hkv,d,window", FLASH_CASES)
    def test_flash_kernel_matches_plain(self, cuda, name, b, s, h, hkv, d,
                                        window):
        rng = np.random.default_rng(s + d)
        q, k, v = (_rand(rng, shape, name, cuda)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        before = t_ops.LAUNCHES["flash_attention"]
        out = t_ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["flash_attention"] == before + 1
        want = t_ref.flash_attention_ref(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(name))

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("shape", NORM_SHAPES)
    def test_rmsnorm_kernel_matches_plain(self, cuda, name, shape):
        rng = np.random.default_rng(len(shape))
        x = _rand(rng, shape, name, cuda)
        s = torch.from_numpy(rng.standard_normal(shape[-1]).astype(
            np.float32)).to(cuda)
        before = t_ops.LAUNCHES["fused_rmsnorm"]
        out = t_ops.fused_rmsnorm(x, s)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["fused_rmsnorm"] == before + 1
        want = t_ref.rmsnorm_ref(x, s)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(name))


def _ssd_args(rng, b, s, h, p, n, name, device, init):
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    bc = f(b, s, 1, 2 * n).to(TORCH_DTYPES[name])
    return (f(b, s, h, p).to(TORCH_DTYPES[name]),
            torch.nn.functional.softplus(f(b, s, h)), -torch.exp(f(h) * 0.5),
            bc[..., :n], bc[..., n:], f(h), f(b, h, p, n) if init else None)


@pytest.mark.cuda
class TestCudaSlice2Kernels:
    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("b,s,h,p,n,chunk,init", SSD_CASES)
    def test_ssd_kernel_matches_plain(self, cuda, name, b, s, h, p, n, chunk,
                                      init):
        x, dt, A, Bm, Cm, D, s0 = _ssd_args(np.random.default_rng(s + n),
                                            b, s, h, p, n, name, cuda, init)
        before = t_ops.LAUNCHES["ssd_scan"]
        y, sf = t_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                               initial_state=s0)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["ssd_scan"] == before + 1
        assert y.dtype == x.dtype and sf.dtype == torch.float32
        yr, sr = t_ref.ssd_ref(x, dt, A, Bm, Cm, D, s0)
        tol = 5e-2 if name == "bfloat16" else 5e-4
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   yr.float().cpu().numpy(), atol=tol, rtol=tol)
        np.testing.assert_allclose(sf.cpu().numpy(), sr.cpu().numpy(),
                                   atol=5e-3, rtol=5e-3)

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("e,c,d,f", GMM_CASES)
    def test_gmm_kernel_matches_plain(self, cuda, name, e, c, d, f):
        rng = np.random.default_rng(e + c + d + f)
        x, w = _rand(rng, (e, c, d), name, cuda), _rand(rng, (e, d, f), name,
                                                         cuda)
        before = t_ops.LAUNCHES["grouped_matmul"]
        out = t_ops.grouped_matmul(x, w)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["grouped_matmul"] == before + 1
        want = t_ref.grouped_matmul_ref(x, w)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(name))

    def test_refusals(self, cuda):
        """A CPU tensor among CUDA ones, meta tensors and wrong dtypes are
        refused; nothing is launched and nothing falls back."""
        rng = np.random.default_rng(0)
        args = list(_ssd_args(rng, 1, 16, 2, 8, 8, "float32", cuda, True))
        x = _rand(rng, (2, 8, 16), "float32", cuda)
        w = _rand(rng, (2, 16, 4), "float32", cuda)
        before = dict(t_ops.LAUNCHES)
        for i in range(7):  # each argument in turn on the CPU
            bad = list(args)
            bad[i] = bad[i].cpu()
            with pytest.raises(ValueError, match="CUDA"):
                t_ops.ssd_scan(*bad[:6], chunk=8, initial_state=bad[6])
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.grouped_matmul(x, w.cpu())
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.grouped_matmul(x.to("meta"), w.to("meta"))
        with pytest.raises(TypeError):
            t_ops.grouped_matmul(x.double(), w.double())
        with pytest.raises(TypeError):
            t_ops.grouped_matmul(x.bfloat16(), w)
        with pytest.raises(TypeError):  # dt must be float32
            t_ops.ssd_scan(args[0], args[1].double(), *args[2:6], chunk=8)
        with pytest.raises(TypeError):  # B and C in x's dtype
            t_ops.ssd_scan(args[0], args[1], args[2], args[3].bfloat16(),
                           args[4], args[5], chunk=8)
        with pytest.raises(ValueError):  # P over the kernel's limit
            t_ops.ssd_scan(*_ssd_args(rng, 1, 8, 1, 65, 8, "float32", cuda,
                                      False)[:6])
        assert t_ops.LAUNCHES == before


@pytest.mark.cuda
class TestCudaTilingEdges:
    """The edges of the tensor-core tilings: C against the N tile (8 to
    256 wide, tiled over the grid above 256), d and f off the 16-byte
    rows (element-wise tile loads), D padded to a multiple of 16, ragged
    q tiles, windows and every GQA grouping. Both dtypes; each call adds
    one launch."""

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("f", [8, 130, 768])
    @pytest.mark.parametrize("d", [16, 100, 2048])
    @pytest.mark.parametrize("c", [1, 7, 9, 65, 160, 257])
    def test_gmm_tiles(self, cuda, name, c, d, f):
        rng = np.random.default_rng(c * 10007 + d * 101 + f)
        x, w = _rand(rng, (2, c, d), name, cuda), _rand(rng, (2, d, f), name,
                                                         cuda)
        before = t_ops.LAUNCHES["grouped_matmul"]
        out = t_ops.grouped_matmul(x, w)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["grouped_matmul"] == before + 1
        assert out.dtype == x.dtype and tuple(out.shape) == (2, c, f)
        want = t_ref.grouped_matmul_ref(x, w)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(name))

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("hkv", [1, 4, 8])
    @pytest.mark.parametrize("window", [None, 24])
    @pytest.mark.parametrize("s", [1, 63, 65, 512])
    @pytest.mark.parametrize("d", [16, 80, 96, 128])
    def test_flash_tiles(self, cuda, name, d, s, window, hkv):
        rng = np.random.default_rng(d * 1009 + s * 7 + hkv)
        q, k, v = (_rand(rng, (2, s, h, d), name, cuda)
                   for h in (8, hkv, hkv))
        before = t_ops.LAUNCHES["flash_attention"]
        out = t_ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert t_ops.LAUNCHES["flash_attention"] == before + 1
        assert out.dtype == q.dtype and out.shape == q.shape
        want = t_ref.flash_attention_ref(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(name))

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    def test_flash_strided_and_misaligned_views(self, cuda, name):
        """q/k/v as views of one wider tensor (strides, no copies); k/v
        starting 2 elements in, off the 16-byte rows (element-wise
        loads)."""
        rng = np.random.default_rng(5)
        big = _rand(rng, (2, 70, 4, 100), name, cuda)
        q = big[..., :32]
        for lo in (32, 34):
            k, v = big[:, :, :2, lo:lo + 32], big[:, :, :2, lo + 32:lo + 64]
            out = t_ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            want = t_ref.flash_attention_ref(q, k, v, causal=True)
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       **_tol(name))


SSD_CHUNKING = [(2048, 64), (2048, 256),  # many chunks
                 (1, 1), (33, 1), (64, 16), (100, 16), (100, 100),
                 (257, 256), (65, 256), (130, 256)]  # ragged S


def _ssd_check(args, chunk, name):
    """One launch per call, dtypes kept, y and the final state against the
    token recurrence at the SSD bars (5e-4 f32, 5e-2 bf16; state 5e-3)."""
    x, dt, A, Bm, Cm, D, s0 = args
    before = t_ops.LAUNCHES["ssd_scan"]
    y, sf = t_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert t_ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert sf.dtype == torch.float32
    yr, sr = t_ref.ssd_ref(x, dt, A, Bm, Cm, D, s0)
    tol = 5e-2 if name == "bfloat16" else 5e-4
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(sf.cpu().numpy(), sr.cpu().numpy(),
                               atol=5e-3, rtol=5e-3)


@pytest.mark.cuda
class TestCudaSsdChunkParallel:
    """The chunk-parallel SSD kernels (64-token chunks whatever ``chunk``
    is): many chunks, every caller chunk, ragged S, B/C groups, initial
    states, contiguous, strided and misaligned B/C, and mamba2-780m's own
    A = -(1..48) with dt up to 2. Both dtypes."""

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("init", [False, True])
    @pytest.mark.parametrize("g", [1, 2, 8])
    @pytest.mark.parametrize("s,chunk", SSD_CHUNKING)
    def test_chunks_groups_and_states(self, cuda, name, s, chunk, g, init):
        rng = np.random.default_rng(s * 31 + chunk * 7 + g)
        f = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)
        b, h, p, n = 2, 8, 64, 128
        bc = f(b, s, g, 2 * n).to(TORCH_DTYPES[name])
        args = (f(b, s, h, p).to(TORCH_DTYPES[name]),
                torch.nn.functional.softplus(f(b, s, h)),
                -torch.exp(f(h) * 0.5), bc[..., :n], bc[..., n:], f(h),
                f(b, h, p, n) if init else None)
        _ssd_check(args, chunk, name)

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("init", [False, True])
    @pytest.mark.parametrize("layout", ["contiguous", "views", "misaligned",
                                        "narrow"])
    def test_layouts(self, cuda, name, layout, init):
        """B/C as contiguous tensors, as views of one (B,S,G,2N) tensor, as
        views one element off the 16-byte rows (element-wise loads), and
        P, N off the 16-byte units (P=6, N=10)."""
        rng = np.random.default_rng(len(layout) + init)
        f = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)
        b, s, h, g = 2, 300, 8, 2
        p, n = (6, 10) if layout == "narrow" else (64, 128)
        dtype = TORCH_DTYPES[name]
        if layout == "contiguous":
            Bm, Cm = f(b, s, g, n).to(dtype), f(b, s, g, n).to(dtype)
        else:
            lo = 1 if layout == "misaligned" else 0
            bc = f(b, s, g, 2 * n + 1).to(dtype)
            Bm, Cm = bc[..., lo:lo + n], bc[..., lo + n:lo + 2 * n]
        args = (f(b, s, h, p).to(dtype),
                torch.nn.functional.softplus(f(b, s, h)),
                -torch.exp(f(h) * 0.5), Bm, Cm, f(h),
                f(b, h, p, n) if init else None)
        _ssd_check(args, 256, name)

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("init", [False, True])
    def test_model_like_decay(self, cuda, name, init):
        """A = -(1..48) and dt in (0, 2): a step's log-decay down to -96,
        a chunk's cumsum near -1e4, where differences of cumsums would
        lose the 5e-4 bar."""
        rng = np.random.default_rng(48 + init)
        f = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)
        b, s, h, p, n = 2, 512, 48, 64, 128
        dtype = TORCH_DTYPES[name]
        bc = f(b, s, 1, 2 * n).to(dtype)
        args = (f(b, s, h, p).to(dtype), 2 * torch.sigmoid(f(b, s, h)),
                -torch.arange(1, h + 1, dtype=torch.float32, device=cuda),
                bc[..., :n], bc[..., n:], f(h), f(b, h, p, n) if init else None)
        _ssd_check(args, 256, name)


@pytest.mark.cuda
class TestCudaNormWidths:
    """The RMSNorm register path (one read, 16-byte vectors, 32 to 256
    threads per row) at every served width and beyond, and the general
    path (widths off the 16-byte units, too wide, misaligned bases)."""

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("rows", [1, 4, 37, 2048])
    @pytest.mark.parametrize("d", [1, 7, 96, 1536, 2048, 2560, 3072, 8192,
                                   10000])
    def test_widths_and_rows(self, cuda, name, d, rows):
        rng = np.random.default_rng(d * 7 + rows)
        _norm_check(_rand(rng, (rows, d), name, cuda), rng, name, cuda)

    @pytest.mark.parametrize("name", list(TORCH_DTYPES))
    @pytest.mark.parametrize("d", [96, 1536, 2560])
    def test_unaligned_base(self, cuda, name, d):
        rng = np.random.default_rng(d)
        flat = _rand(rng, (37 * d + 1,), name, cuda)
        _norm_check(flat[1:].view(37, d), rng, name, cuda)


def _norm_check(x, rng, name, cuda):
    s = torch.from_numpy(rng.standard_normal(x.shape[-1]).astype(
        np.float32)).to(cuda)
    before = t_ops.LAUNCHES["fused_rmsnorm"]
    out = t_ops.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert t_ops.LAUNCHES["fused_rmsnorm"] == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    want = t_ref.rmsnorm_ref(x, s)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(name))


@pytest.mark.cuda
def test_launcher_refuses_float32_qwen3_moe(cuda):
    """qwen3-moe-30b-a3b in float32 needs 122 GB: the launcher says so
    before it allocates anything."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="GB"):
        serve.check_fits(get_config("qwen3-moe-30b-a3b"), torch.float32, cuda)
    serve.check_fits(get_config("qwen3-moe-30b-a3b"), torch.bfloat16, cuda)


@pytest.mark.cuda
def test_smoke_model_runs_the_kernels_and_matches_plain(cuda):
    """Prefill of the smoke config on the card goes through the kernels
    (one flash launch per layer, two norms per layer plus the final one)
    and matches the same module through the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = Transformer(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = dict(t_ops.LAUNCHES)
    got, _ = model.prefill(toks, max_seq=64)
    torch.cuda.synchronize()
    assert t_ops.LAUNCHES["flash_attention"] - before["flash_attention"] == \
        cfg.n_layers
    assert t_ops.LAUNCHES["fused_rmsnorm"] - before["fused_rmsnorm"] == \
        2 * cfg.n_layers + 1
    want, _ = model.prefill(toks, max_seq=64, kernels=t_ops.PLAIN)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(4))
def test_wrappers_launch_on_the_tensors_device(cuda, index):
    """The wrappers make the tensors' device current for the launch, so a
    tensor on another card than the current one still gets a right answer
    (and the current device is left as it was)."""
    if index >= torch.cuda.device_count():
        pytest.skip(f"needs {index + 1} CUDA devices")
    dev = torch.device("cuda", index)
    current = torch.cuda.current_device()
    rng = np.random.default_rng(index)
    q = _rand(rng, (1, 70, 4, 16), "float32", dev)
    k = _rand(rng, (1, 70, 2, 16), "float32", dev)
    x = _rand(rng, (5, 96), "float32", dev)
    s = torch.from_numpy(rng.standard_normal(96).astype(np.float32)).to(dev)
    out = t_ops.flash_attention(q, k, k, causal=True, window=32)
    y = t_ops.fused_rmsnorm(x, s)
    assert torch.cuda.current_device() == current
    assert out.device == dev and y.device == dev
    torch.cuda.synchronize(dev)
    np.testing.assert_allclose(
        out.cpu().numpy(), t_ref.flash_attention_ref(
            q, k, k, causal=True, window=32).cpu().numpy(), **_tol("float32"))
    np.testing.assert_allclose(y.cpu().numpy(),
                               t_ref.rmsnorm_ref(x, s).cpu().numpy(),
                               **_tol("float32"))


FLEET_N = 20_000


def _fleet_router(kind, n, device):
    """The chip smoke's ``xregion``, ``mesoscale`` and ``temporal_joint``
    routers with their DC-tier caps, at ``n`` requests."""
    from repro_torch.configs import get_config
    from repro_torch.core.carbon_intensity import CarbonGrid
    from repro_torch.core.infrastructure import pack_infra, tpu_fleet
    from repro_torch.serve import (FleetRouter, OraclePolicy,
                                   PlacementPolicy, TemporalPolicy)

    n_regions = 128 if kind == "mesoscale" else 4
    grid = (CarbonGrid.from_sites(n_regions, 8, seed=0, device=device)
            if kind == "mesoscale" else
            CarbonGrid.fully_connected(latency_penalty=1.05, device=device))
    frac = 0.6 if kind == "temporal_joint" else 0.4
    caps = np.full((n_regions, 3), np.inf)
    caps[:, 1] = caps[:, 2] = max(1.0, frac * n / (n_regions * 24))
    oracle = OraclePolicy(pack_infra(tpu_fleet(), device=device))
    policy = (TemporalPolicy(oracle, caps, max_defer_h=12)
              if kind == "temporal_joint" else PlacementPolicy(oracle, caps))
    return FleetRouter(get_config("h2o-danube-1.8b"), grid=grid,
                       policy=policy, device=device)


@pytest.mark.cuda
class TestCudaFleet:
    """The decide half on the card makes the CPU's decisions, to the bit."""

    @pytest.mark.parametrize("kind", ["xregion", "mesoscale",
                                      "temporal_joint"])
    def test_fleet_router_card_equals_cpu(self, cuda, kind):
        from repro_torch.serve.streams import (deferrable_stream,
                                               multi_region_stream)

        stream = (deferrable_stream(FLEET_N, 4) if kind == "temporal_joint"
                  else multi_region_stream(FLEET_N, 128, seed=1)
                  if kind == "mesoscale" else multi_region_stream(FLEET_N, 4))
        out = {}
        for dev in (cuda, torch.device("cpu")):
            fr = _fleet_router(kind, FLEET_N, dev)
            res, state = fr.route_stream_with_state(*stream)
            assert res.target.device.type == dev.type
            out[dev.type] = (res, state)
        (g, gs), (c, cs) = out["cuda"], out["cpu"]
        for f in ("target", "exec_region", "counts", "feasible",
                  "shed_count", "spilled_count", "deferred_count"):
            np.testing.assert_array_equal(getattr(g, f).cpu().numpy(),
                                          getattr(c, f).numpy(), err_msg=f)
        for f in ("shed", "shed_pair") + (
                ("exec_hour", "defer_hours") if kind == "temporal_joint"
                else ()):
            np.testing.assert_array_equal(getattr(gs, f).cpu().numpy(),
                                          getattr(cs, f).numpy(), err_msg=f)
        np.testing.assert_allclose(g.carbon_g.cpu().numpy(),
                                   c.carbon_g.numpy(), rtol=1e-5, atol=0)
        np.testing.assert_allclose(float(g.routed_carbon_g),
                                   float(c.routed_carbon_g), rtol=1e-5)
        assert int(g.shed_count) > 0 and int(g.spilled_count) > 0

    def test_windowed_segment_ranks_past_2_16_rows_per_column(self, cuda):
        from repro_torch.serve.placement import windowed_segment_ranks

        n, n_seg, width = 900_000, 2, 3  # ~135k active rows per cell
        rng = np.random.default_rng(0)
        seg = np.sort(rng.integers(0, n_seg, n))
        choice = rng.integers(0, width, n)
        active = rng.random(n) < 0.9
        cell = seg * width + choice
        starts = np.searchsorted(seg, np.arange(n_seg))
        ends = np.concatenate([starts[1:], [n]])
        args = [torch.as_tensor(a) for a in (choice, active, cell, starts,
                                             ends)]
        rank_c, tot_c = windowed_segment_ranks(*args, width)
        rank_g, tot_g = windowed_segment_ranks(
            *(a.to(cuda) for a in args), width)
        assert rank_g.dtype == torch.int32 and tot_g.dtype == torch.int32
        np.testing.assert_array_equal(rank_g.cpu().numpy(), rank_c.numpy())
        np.testing.assert_array_equal(tot_g.cpu().numpy(), tot_c.numpy())
        want = np.bincount(cell[active], minlength=n_seg * width)
        np.testing.assert_array_equal(tot_g.cpu().numpy(), want)
        assert want.max() > 2**16
        last = np.nonzero(active)[0][-1]  # the last active row's rank
        assert int(rank_g[last]) == int((cell[active] == cell[last]).sum()) - 1


SERVE_N = 20_000
SERVE_FIELDS = ("target", "exec_region", "exec_hour", "defer_hours", "shed")


def _assert_commitments_equal(g, c, fields=SERVE_FIELDS):
    for f in fields:
        bad = int((getattr(g, f) != getattr(c, f)).sum())
        assert bad == 0, f"{f}: {bad} entries differ card vs CPU"
    np.testing.assert_allclose(g.carbon_g, c.carbon_g, rtol=1e-5, atol=0)
    np.testing.assert_allclose(g.routed_carbon_g, c.routed_carbon_g,
                               rtol=1e-5)


@pytest.mark.cuda
class TestCudaServe:
    """The serving loop on the card commits what the CPU commits: the
    rolling re-planner, the continuous-batching queue and the online refit
    (``chip_smoke.py``'s ``[serve]`` recipes at 20k requests)."""

    def test_rolling_card_equals_cpu(self, cuda):
        from repro_torch.configs import get_config
        from repro_torch.core.carbon_intensity import DEFAULT_REGIONS
        from repro_torch.core.infrastructure import pack_infra, tpu_fleet
        from repro_torch.serve import (EmissionsLedger, FleetRouter,
                                       OraclePolicy, TemporalPolicy)
        from repro_torch.serve.streams import forecast_scenario

        out = {}
        for dev in (cuda, torch.device("cpu")):
            batch, region, t_hours, grid = forecast_scenario(
                SERVE_N, DEFAULT_REGIONS, sigma_h=0.03, seed=0, device=dev)
            fr = FleetRouter(get_config("h2o-danube-1.8b"), grid=grid,
                             device=dev, policy=TemporalPolicy(
                                 OraclePolicy(pack_infra(tpu_fleet(),
                                                         device=dev)),
                                 np.full((4, 3), np.inf), max_defer_h=12,
                                 risk_lambda=1.0))
            out[dev.type] = fr.route_stream_rolling(
                batch, region, t_hours, step_h=6, ledger=EmissionsLedger())
        _assert_commitments_equal(out["cuda"], out["cpu"])
        assert out["cuda"].deferred_count > 0

    @pytest.mark.parametrize("slots", [30_000.0, 40.0])
    def test_queue_card_equals_cpu(self, cuda, slots):
        from repro_torch.configs import get_config
        from repro_torch.core.carbon_intensity import CarbonGrid
        from repro_torch.core.infrastructure import pack_infra, tpu_fleet
        from repro_torch.serve import (FleetRouter, OraclePolicy,
                                       PlacementPolicy, WorkerPool,
                                       serve_stream)
        from repro_torch.serve.streams import diurnal_stream

        batch, region, t_hours = diurnal_stream(SERVE_N, 4)
        out = {}
        for dev in (cuda, torch.device("cpu")):
            fr = FleetRouter(
                get_config("h2o-danube-1.8b"), device=dev,
                grid=CarbonGrid.fully_connected(latency_penalty=1.05,
                                                device=dev),
                policy=PlacementPolicy(OraclePolicy(pack_infra(
                    tpu_fleet(), device=dev)), np.ones((4, 3))))
            pool = WorkerPool(4, slots_per_worker=slots,
                              launch_delay_steps=0)
            for r in range(4):
                for tier in (1, 2):
                    pool.launch(r, tier, n=2)
            out[dev.type] = serve_stream(fr, batch, region, t_hours,
                                         pool=pool)
        _assert_commitments_equal(out["cuda"], out["cpu"],
                                  SERVE_FIELDS + ("step",))
        if slots < 100:
            assert out["cuda"].shed_count > 0

    def test_refit_flips_card_vs_cpu(self, cuda):
        """The static learned policy (fitted on the host) and its online
        refit on the card decide as on the CPU: the flip count is 0."""
        from repro_torch.configs import get_config
        from repro_torch.core import (ALL_PAPER_WORKLOADS, ScenarioAxes,
                                      build_scenarios, explore, paper_fleet)
        from repro_torch.core.carbon_intensity import CarbonGrid
        from repro_torch.core.infrastructure import pack_infra, tpu_fleet
        from repro_torch.core.schedulers import (ClassificationScheduler,
                                                 build_dataset)
        from repro_torch.serve import (FleetRouter, LearnedPolicy,
                                       OnlineRefitter, TemporalPolicy,
                                       serve_stream)
        from repro_torch.serve.streams import deferrable_stream_multiday

        cpu = torch.device("cpu")
        table = build_scenarios(paper_fleet(),
                                ScenarioAxes(hours=tuple(range(0, 24, 4))),
                                device=cpu)
        train = build_dataset(ALL_PAPER_WORKLOADS,
                              explore(ALL_PAPER_WORKLOADS, table),
                              table).split()[0]
        static = LearnedPolicy.fit(ClassificationScheduler(carbon_head=False),
                                   train, device=cpu)
        batch, region, t_hours = deferrable_stream_multiday(SERVE_N, 4,
                                                            n_days=2)
        caps = np.full((4, 3), np.inf)
        caps[:, 1] = caps[:, 2] = max(1.0, 0.6 * SERVE_N / (4 * 48))
        out = {}
        for dev in (cuda, cpu):
            inner = dataclasses.replace(
                static.to(dev), infra=pack_infra(tpu_fleet(), device=dev))
            fr = FleetRouter(get_config("h2o-danube-1.8b"), device=dev,
                             grid=CarbonGrid.fully_connected(
                                 latency_penalty=1.05, n_days=2, device=dev),
                             policy=TemporalPolicy(inner, caps,
                                                   max_defer_h=16))
            refitter = OnlineRefitter(min_observations=SERVE_N // 12,
                                      refit_every=SERVE_N // 6)
            out[dev.type] = serve_stream(fr, batch, region, t_hours,
                                         step_h=2, refitter=refitter)
        g, c = out["cuda"], out["cpu"]
        assert g.refits == c.refits >= 2
        flips = int((g.target != c.target).sum()
                    + (g.exec_region != c.exec_region).sum()
                    + (g.exec_hour != c.exec_hour).sum())
        assert flips == 0, f"{flips} decisions flipped card vs CPU"
        _assert_commitments_equal(g, c, SERVE_FIELDS + ("step",))


@pytest.mark.cuda
class TestCudaScenarios:
    """The scenario matrix, the plan-driven serve loop and the tour on the
    card decide as on the CPU (``chip_smoke.py``'s ``[scenarios]``,
    ``[provision]`` and ``[tour]`` recipes at 20k requests)."""

    def test_matrix_card_equals_cpu(self, cuda):
        from repro_torch.serve import scenarios as sc

        for sname, scenario in sc.default_scenarios().items():
            for pname, factory in sc.default_policies().items():
                out = {}
                for dev in (cuda, torch.device("cpu")):
                    res, state, run = sc.route_scenario(
                        scenario, factory, n=SERVE_N, device=dev)
                    out[dev.type] = (res, state,
                                     sc._cell(sname, pname, len(run.batch),
                                              res))
                (g, gs, gc), (c, cs, cc) = out["cuda"], out["cpu"]
                for f in ("target", "exec_region", "counts"):
                    assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), \
                        f"{sname}/{pname}: {f}"
                for f in ("shed", "exec_hour"):
                    if hasattr(cs, f):
                        assert torch.equal(getattr(gs, f).cpu(),
                                           getattr(cs, f)), \
                            f"{sname}/{pname}: {f}"
                np.testing.assert_allclose(g.carbon_g.cpu().numpy(),
                                           c.carbon_g.numpy(), rtol=1e-5,
                                           atol=0)
                assert (gc.n, gc.shed_rate, gc.spill_rate, gc.defer_rate) \
                    == (cc.n, cc.shed_rate, cc.spill_rate, cc.defer_rate)

    def test_plan_serve_card_equals_cpu(self, cuda):
        from repro_torch.configs import get_config
        from repro_torch.core.carbon_intensity import CarbonGrid
        from repro_torch.core.infrastructure import (pack_infra, paper_fleet,
                                                     tpu_fleet)
        from repro_torch.serve import (FleetRouter, OraclePolicy,
                                       PlacementPolicy, serve_stream)
        from repro_torch.serve.provision import (demand_from_arrivals,
                                                 provision_greedy)
        from repro_torch.serve.streams import multi_region_stream

        batch, region, t_hours = multi_region_stream(SERVE_N, 128, seed=1)
        demand = demand_from_arrivals(region, t_hours, 24, 128)
        out = {}
        for dev in (cuda, torch.device("cpu")):
            grid = CarbonGrid.from_sites(128, 8, seed=0, device=dev)
            plan = provision_greedy(demand, grid, paper_fleet(),
                                    slots_per_server=16.0)
            fr = FleetRouter(get_config("h2o-danube-1.8b"), grid=grid,
                             device=dev, policy=PlacementPolicy(
                                 OraclePolicy(pack_infra(tpu_fleet(),
                                                         device=dev)),
                                 np.ones((128, 3))))
            out[dev.type] = (plan, serve_stream(fr, batch, region, t_hours,
                                                plan=plan))
        (gp, g), (cp, c) = out["cuda"], out["cpu"]
        np.testing.assert_array_equal(gp.servers, cp.servers)
        assert gp.total_carbon_g == cp.total_carbon_g
        _assert_commitments_equal(g, c, SERVE_FIELDS + ("step",))

    def test_tour_launch_counts(self, cuda):
        """The tour's engine (the full danube config in f32) runs act 3's
        one prefill through 24 flash launches and its 8 forward passes
        through 49 RMSNorm launches each; nothing else launches a kernel."""
        from repro_torch.configs import get_config
        from repro_torch.launch import tour

        t_ops.reset_launches()
        run = tour.main(["--device", "cuda", "--no-smoke", "--requests",
                         str(SERVE_N)])
        torch.cuda.synchronize()
        launches = dict(t_ops.LAUNCHES)
        cfg = get_config("h2o-danube-1.8b")
        assert run.acts[3]["engine"] == cfg.name
        assert launches == dict({k: 0 for k in launches},
                                flash_attention=cfg.n_layers,
                                fused_rmsnorm=(2 * cfg.n_layers + 1) * 8)
