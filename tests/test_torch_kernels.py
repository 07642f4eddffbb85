"""The port's kernel wrappers against the JAX reference.

On the CPU the wrappers run their plain versions; those are held against
the jnp oracles and the Pallas kernels in interpret mode (flash attention:
interpret mode in float32, where the bfloat16 kernel is already held to the
oracle by ``tests/test_kernels.py``), on the ``tests/test_kernels.py``
sweep plus S=96 and D=80 with a window, at the same bars (5e-4 f32, 2e-2
bf16; the SSD state at 5e-3, or 5e-4 from an initial state, as there). The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402

from repro_torch.kernels import build as t_build  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_CASES = [(2, 64, 4, 2, 32, None),
               (1, 128, 8, 8, 64, None),
               (2, 64, 4, 1, 16, 16),
               (1, 96, 6, 3, 32, 32),
               (1, 256, 2, 1, 128, None),
               (2, 96, 4, 2, 16, 32),  # ragged S=96 at the smoke head_dim
               (1, 96, 4, 1, 80, 40)]  # the danube head_dim with a window
NORM_SHAPES = [(4, 37, 96), (1, 8, 8, 64)]
SSD_CASES = [(2, 64, 8, 16, 16, 16, 4),  # tests/test_kernels.py sweep
             (1, 128, 16, 32, 32, 32, 8),
             (2, 96, 4, 8, 8, 24, 4),
             (1, 64, 8, 64, 128, 16, 8)]
GMM_CASES = [(4, 32, 64, 48), (8, 16, 32, 32), (2, 128, 128, 128),
             (16, 8, 16, 8)]


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else \
        dict(atol=5e-4, rtol=5e-4)


def _pair(rng, shape, name):
    """The same values as a jnp and a torch array of one dtype (both round
    the float32 draw to bfloat16 the same way)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[name]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def counts():
    """Launch counts before the test; the test asserts they did not move."""
    return dict(t_ops.LAUNCHES)


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,s,h,hkv,d,window", FLASH_CASES)
    def test_against_pallas_and_oracle(self, name, b, s, h, hkv, d, window,
                                       counts):
        rng = np.random.default_rng(b * 1000 + s + d)
        qj, qt = _pair(rng, (b, s, h, d), name)
        kj, kt = _pair(rng, (b, s, hkv, d), name)
        vj, vt = _pair(rng, (b, s, hkv, d), name)
        out = t_ops.flash_attention(qt, kt, vt, causal=True, window=window)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        oracle = r_ref.flash_attention_ref(qj, kj, vj, causal=True,
                                           window=window)
        np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(name))
        if name == "float32":
            # the interpreted Pallas kernel in float32; in bfloat16 the
            # reference's own tests/test_kernels.py holds it to the oracle
            pallas = r_ops.flash_attention(qj, kj, vj, causal=True,
                                           window=window, interpret=True)
            np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(name))
        assert t_ops.LAUNCHES == counts  # CPU tensors launch nothing


class TestRMSNormPlain:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("shape", NORM_SHAPES)
    def test_against_pallas_and_oracle(self, name, shape, counts):
        rng = np.random.default_rng(len(shape))
        xj, xt = _pair(rng, shape, name)
        s = rng.standard_normal(shape[-1]).astype(np.float32)
        out = t_ops.fused_rmsnorm(xt, torch.from_numpy(s))
        assert out.dtype == xt.dtype and out.shape == xt.shape
        pallas = r_ops.fused_rmsnorm(xj, jnp.asarray(s), interpret=True)
        oracle = r_ref.rmsnorm_ref(xj, jnp.asarray(s))
        np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(name))
        np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(name))
        assert t_ops.LAUNCHES == counts


def _ssd_inputs(rng, b, s, h, p, n, init=False):
    """numpy inputs of the SSD scan, drawn as tests/test_kernels.py draws
    them (softplus dt, A = -exp(0.5 z), one B/C group)."""
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = dict(x=f(b, s, h, p), dt=np.logaddexp(0.0, f(b, s, h)),
               A=-np.exp(f(h) * 0.5), B=f(b, s, 1, n), C=f(b, s, 1, n),
               D=f(h))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["s0"] = f(b, h, p, n) if init else None
    return out


class TestSSDScanPlain:
    @pytest.mark.parametrize("b,s,h,p,n,chunk,block_h", SSD_CASES)
    def test_against_pallas_and_oracle(self, b, s, h, p, n, chunk, block_h,
                                       counts):
        a = _ssd_inputs(np.random.default_rng(s + n), b, s, h, p, n)
        args = [a[k] for k in ("x", "dt", "A", "B", "C", "D")]
        y, sf = t_ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
        assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
        assert sf.dtype == torch.float32 and sf.shape == (b, h, p, n)
        jargs = list(map(jnp.asarray, args))
        yp, sp = r_ops.ssd_scan(*jargs, chunk=chunk, block_h=block_h,
                                interpret=True)
        yr, sr = r_ref.ssd_ref(*jargs)
        for want_y, want_s in ((yp, sp), (yr, sr)):
            np.testing.assert_allclose(_f32(y), _f32(want_y), **_tol("float32"))
            np.testing.assert_allclose(_f32(sf), _f32(want_s), atol=5e-3,
                                       rtol=5e-3)
        assert t_ops.LAUNCHES == counts

    def test_initial_state(self, counts):
        """tests/test_kernels.py's initial-state case (chunk 8 of S=32)."""
        a = _ssd_inputs(np.random.default_rng(7), 1, 32, 4, 8, 16, init=True)
        args = [a[k] for k in ("x", "dt", "A", "B", "C", "D")]
        y, sf = t_ops.ssd_scan(*map(torch.from_numpy, args), chunk=8,
                               initial_state=torch.from_numpy(a["s0"]))
        jargs = list(map(jnp.asarray, args))
        s0 = jnp.asarray(a["s0"])
        for want_y, want_s in (r_ops.ssd_scan(*jargs, chunk=8, initial_state=s0,
                                              interpret=True),
                               r_ref.ssd_ref(*jargs, initial_state=s0)):
            np.testing.assert_allclose(_f32(y), _f32(want_y), **_tol("float32"))
            np.testing.assert_allclose(_f32(sf), _f32(want_s), **_tol("float32"))
        assert t_ops.LAUNCHES == counts

    def test_bfloat16_keeps_dtypes(self):
        a = _ssd_inputs(np.random.default_rng(3), 1, 24, 4, 8, 8)
        t = {k: torch.from_numpy(v) for k, v in a.items() if v is not None}
        bf = {k: t[k].bfloat16() for k in ("x", "B", "C")}
        y, sf = t_ops.ssd_scan(bf["x"], t["dt"], t["A"], bf["B"], bf["C"],
                               t["D"], chunk=8)
        assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
        yr, sr = r_ref.ssd_ref(*(jnp.asarray(np.asarray(v.float()), dt)
                                 for v, dt in ((bf["x"], jnp.bfloat16),
                                               (t["dt"], jnp.float32),
                                               (t["A"], jnp.float32),
                                               (bf["B"], jnp.bfloat16),
                                               (bf["C"], jnp.bfloat16),
                                               (t["D"], jnp.float32))))
        np.testing.assert_allclose(_f32(y), _f32(yr), atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(_f32(sf), _f32(sr), atol=5e-3, rtol=5e-3)


class TestGroupedMatmulPlain:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("e,c,d,f", GMM_CASES)
    def test_against_pallas_and_oracle(self, name, e, c, d, f, counts):
        rng = np.random.default_rng(e * c + d + f)
        xj, xt = _pair(rng, (e, c, d), name)
        wj, wt = _pair(rng, (e, d, f), name)
        out = t_ops.grouped_matmul(xt, wt)
        assert out.dtype == xt.dtype and out.shape == (e, c, f)
        pallas = r_ops.grouped_matmul(xj, wj, block_c=16, block_f=16,
                                      block_d=16, interpret=True)
        oracle = r_ref.grouped_matmul_ref(xj, wj)
        np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(name))
        np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(name))
        assert t_ops.LAUNCHES == counts


class TestWrappers:
    def test_non_cpu_tensor_never_takes_the_plain_version(self, counts):
        """A tensor off the CPU launches the kernel or raises; meta tensors
        are not CUDA tensors, so the wrappers must refuse them."""
        q = torch.empty((1, 8, 2, 16), device="meta")
        k = torch.empty((1, 8, 1, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.fused_rmsnorm(torch.empty((4, 16), device="meta"),
                                torch.empty((16,), device="meta"))
        meta = lambda *shape: torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.ssd_scan(meta(1, 8, 2, 4), meta(1, 8, 2), meta(2),
                           meta(1, 8, 1, 4), meta(1, 8, 1, 4), meta(2))
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.ssd_scan(*(torch.zeros(s) for s in ((1, 8, 2, 4), (1, 8, 2),
                                                      (2,), (1, 8, 1, 4),
                                                      (1, 8, 1, 4), (2,))),
                           initial_state=meta(1, 2, 4, 4))
        with pytest.raises(ValueError, match="CUDA"):
            t_ops.grouped_matmul(meta(2, 4, 8), meta(2, 8, 3))
        assert t_ops.LAUNCHES == counts

    def test_kernel_sets(self):
        assert t_ops.KERNELS.flash_attention is t_ops.flash_attention
        assert t_ops.KERNELS.rmsnorm is t_ops.fused_rmsnorm
        assert t_ops.KERNELS.ssd_scan is t_ops.ssd_scan
        assert t_ops.KERNELS.grouped_matmul is t_ops.grouped_matmul
        assert t_ops.PLAIN.flash_attention is t_ref.flash_attention_ref
        assert t_ops.PLAIN.rmsnorm is t_ref.rmsnorm_ref
        assert t_ops.PLAIN.ssd_scan is t_ref.ssd_ref
        assert t_ops.PLAIN.grouped_matmul is t_ref.grouped_matmul_ref
        assert set(t_ops.LAUNCHES) == {"flash_attention", "fused_rmsnorm",
                                       "ssd_scan", "grouped_matmul"}

    def test_build_sources_and_location(self):
        names = sorted(p.name for p in t_build._sources())
        assert names == ["flash_attention.cu", "grouped_matmul.cu",
                         "rmsnorm.cu", "ssd_scan.cu"]
        assert set(t_build.SIGNATURES) == {"gs_flash_attention", "gs_rmsnorm",
                                           "gs_ssd_scan", "gs_grouped_matmul"}
        repo = t_build.CSRC.parents[3]
        assert t_build.build_dir() == repo / "build" / "repro_torch"
        assert (repo / "chip_smoke.py").is_file()

    def test_build_digest_covers_the_shared_headers(self, tmp_path,
                                                    monkeypatch):
        """The kernels include ``common.cuh`` and ``tensor_core.cuh``: an
        edit to a header names a new library, so a stale build is never
        reused; the headers are included, not compiled on their own."""
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for p in t_build.CSRC.iterdir():
            (csrc / p.name).write_bytes(p.read_bytes())
        monkeypatch.setattr(t_build, "CSRC", csrc)
        assert {"common.cuh", "tensor_core.cuh"} <= {
            p.name for p in csrc.glob("*.cuh")}
        assert all(p.suffix == ".cu" for p in t_build._sources())
        before = t_build._digest("nvcc")
        header = csrc / "tensor_core.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        assert t_build._digest("nvcc") != before


def _meta_launch(monkeypatch, lib):
    """Route the wrappers' CUDA branch to ``lib`` on meta tensors: no
    device check, no device context, stream 0."""
    import contextlib
    import types

    monkeypatch.setattr(t_ops, "_check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(t_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(t_ops, "LAUNCHES", dict(t_ops.LAUNCHES))


class TestSsdCall:
    """The SSD wrapper's call of ``gs_ssd_scan``, checked on the CPU: the
    arguments go through a ctypes prototype of the declared signature, as
    they do into the library on the card."""

    def test_call_matches_the_signature_and_workspace_device(self,
                                                             monkeypatch):
        import ctypes

        calls, spaces = [], []
        proto = ctypes.CFUNCTYPE(ctypes.c_int,
                                 *t_build.SIGNATURES["gs_ssd_scan"])
        fake = proto(lambda *args: calls.append(args) or 0)
        _meta_launch(monkeypatch, type("Lib", (), {"gs_ssd_scan": fake})())
        real = t_ops.ssd_workspace
        monkeypatch.setattr(t_ops, "ssd_workspace", lambda *a: spaces.append(
            real(*a)) or spaces[-1])
        meta = lambda *shape: torch.empty(shape, device="meta")
        b, s, h, g, p, n = 2, 130, 4, 2, 16, 8
        bc = meta(b, s, g, 2 * n)
        y, sf = t_ops.ssd_scan(meta(b, s, h, p), meta(b, s, h), meta(h),
                               bc[..., :n], bc[..., n:], meta(h), chunk=256,
                               initial_state=meta(b, h, p, n))
        assert len(calls) == 1 and t_ops.LAUNCHES["ssd_scan"] == 1
        args = calls[0]
        assert len(args) == len(t_build.SIGNATURES["gs_ssd_scan"])
        assert args[13:20] == (b, s, h, g, p, n, 256)
        assert args[20:23] == (s * h * p, h * p, p)  # x strides
        assert args[26:29] == (s * g * 2 * n, g * 2 * n, 2 * n)  # B strides
        assert y.device.type == sf.device.type == "meta"
        # the workspaces: the input's device, nc = ceil(130 / 64) = 3
        (sums, cb, states), = spaces
        assert sums.device == cb.device == states.device == \
            torch.device("meta")
        assert sums.dtype == cb.dtype == states.dtype == torch.float32
        assert tuple(sums.shape) == (b, h, 3, 5, 64)
        assert tuple(cb.shape) == (b, 3, g, 64, 64)
        assert tuple(states.shape) == (b, 3, h, p, n)

    @pytest.mark.parametrize("s,nc", [(0, 0), (1, 1), (64, 1), (65, 2),
                                      (512, 8), (4096, 64)])
    def test_workspace_sizes(self, s, nc):
        sums, cb, states = t_ops.ssd_workspace(4, s, 48, 1, 64, 128,
                                               torch.device("meta"))
        assert tuple(sums.shape) == (4, 48, nc, 5, 64)
        assert tuple(cb.shape) == (4, nc, 1, 64, 64)
        assert tuple(states.shape) == (4, nc, 48, 64, 128)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", t_build.CSRC.parents[3] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_times_every_served_norm_and_a_long_ssd_prompt():
    """``chip_smoke.py`` times RMSNorm at every served prefill shape and at
    decode, the SSD scan at the prefill and at a 4096-token prompt, and
    its ``--profile`` report names every SSD sub-kernel."""
    smoke = _chip_smoke()
    assert set(smoke.NORM_TIMED) >= {
        ((2048, 2560), "float32"), ((2048, 1536), "float32"),
        ((2048, 3072), "float32"), ((2048, 2048), "bfloat16"),
        ((4, 2560), "float32")}
    assert smoke.NORM_TIMED[0] == ((2048, 2560), "float32")
    assert smoke.SSD_TIMED[0] == ("main", 4, 512, 48, 64, 128, 256)
    assert ("long prompt", 1, 4096, 48, 64, 128, 256) in smoke.SSD_TIMED
    # the profile keeps every kernel whose name holds "ssd_": the five
    # kernels of ssd_scan.cu
    src = (t_build.CSRC / "ssd_scan.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                             r"\s+(\w+)\(", src))
    assert sorted(kernels) == ["ssd_chunk_cb", "ssd_chunk_scan",
                               "ssd_chunk_state", "ssd_chunk_sums",
                               "ssd_state_pass"]
    assert '"ssd_" in key' in (t_build.CSRC.parents[3]
                               / "chip_smoke.py").read_text()


def test_chip_smoke_names_each_kernel_with_its_spills():
    """``chip_smoke.py`` turns nvcc's ``-Xptxas -v`` log into one
    ``[build]`` line per kernel, so a spill is tied to the kernel that
    spilled."""
    smoke = _chip_smoke()
    entry = "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi128ELb1EEEvNS_6ParamsE"
    log = "\n".join([
        "== flash_attention.cu",
        f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'",
        f"ptxas info    : Function properties for {entry}",
        "    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooi",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers",
        "== link"])
    lines = smoke.ptxas_summary(log)
    assert lines[0] == "== flash_attention.cu" and lines[-1] == "== link"
    assert len(lines) == 4
    assert lines[1].endswith(": 128 registers, spill stores 16 B, loads 12 B")
    assert lines[2].endswith(": 32 registers, spill stores 0 B, loads 0 B")
    # demangled where c++filt is installed, the mangled name otherwise
    assert ("flash_fwd_bf16<128, true>" in lines[1]) or (entry in lines[1])
