"""The port's kernel wrappers against the JAX reference.

On the CPU the wrappers run their plain versions; those are held against
the jnp oracles and the Pallas kernels in interpret mode (flash attention:
interpret mode in float32, where the bfloat16 kernel is already held to the
oracle by ``tests/test_kernels.py``), on the ``tests/test_kernels.py``
sweep plus S=96 and D=80 with a window, at the same bars (5e-4 f32, 2e-2
bf16). The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there."""

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
        assert t_ops.LAUNCHES == counts

    def test_kernel_sets(self):
        assert t_ops.KERNELS.flash_attention is t_ops.flash_attention
        assert t_ops.KERNELS.rmsnorm is t_ops.fused_rmsnorm
        assert t_ops.PLAIN.flash_attention is t_ref.flash_attention_ref
        assert t_ops.PLAIN.rmsnorm is t_ref.rmsnorm_ref

    def test_build_sources_and_location(self):
        names = sorted(p.name for p in t_build._sources())
        assert names == ["flash_attention.cu", "rmsnorm.cu"]
        assert set(t_build.SIGNATURES) == {"gs_flash_attention", "gs_rmsnorm"}
        repo = t_build.CSRC.parents[3]
        assert t_build.build_dir() == repo / "build" / "repro_torch"
        assert (repo / "chip_smoke.py").is_file()
