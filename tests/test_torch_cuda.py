"""The port's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips on a host without a CUDA device. On the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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
