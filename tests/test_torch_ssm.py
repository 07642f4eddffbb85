"""The port's Mamba-2 mixer against the JAX reference on the smoke config
``mamba2-780m-smoke`` (d_model 64, 8 SSM heads of P=16, N=16, chunk 16):
weights from the reference ``init_mamba``, inputs from numpy. Prefill
(jnp scan and the interpreted Pallas kernel on the reference side, the
plain SSD recurrence on the port's), a split prefill carried by the
state, and decode steps, within 5e-4 in float32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import mamba2 as r_mamba  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import mamba2 as t_mamba  # noqa: E402

ARCH = "mamba2-780m"
TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port mixer)."""
    r_cfg = r_get_config(ARCH, smoke=True)
    params = r_mamba.init_mamba(jax.random.PRNGKey(0), r_cfg, jnp.float32)
    cfg = get_config(ARCH, smoke=True)
    mixer = t_mamba.Mamba2(cfg, device="cpu")
    for name, leaf in params.items():
        with torch.no_grad():
            getattr(mixer, name).copy_(torch.tensor(np.asarray(leaf)))
    return r_cfg, params, cfg, mixer


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _assert_state(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got.ssm), np.asarray(want.ssm), **tol)
    np.testing.assert_allclose(_np(got.conv_x), np.asarray(want.conv_x), **tol)
    np.testing.assert_allclose(_np(got.conv_bc), np.asarray(want.conv_bc),
                               **tol)


def test_leaf_names_and_dtypes(pair):
    r_cfg, params, cfg, mixer = pair
    assert {n for n, _ in mixer.named_parameters()} == set(params)
    for name, leaf in params.items():
        p = getattr(mixer, name)
        assert tuple(p.shape) == leaf.shape, name
        assert p.dtype == torch.float32
    bf = t_mamba.Mamba2(cfg, device="cpu", dtype=torch.bfloat16)
    assert bf.z_proj.dtype == bf.conv_x_w.dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias", "norm_scale"):
        assert getattr(bf, name).dtype == torch.float32, name


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seq", [32, 24])  # a chunk multiple / padded to 32
def test_mamba_forward(pair, use_pallas, seq):
    r_cfg, params, cfg, mixer = pair
    x = _x((2, seq, cfg.d_model), seed=seq)
    want_y, want_st = r_mamba.mamba_forward(params, r_cfg, jnp.asarray(x),
                                            use_pallas=use_pallas)
    counts = dict(t_ops.LAUNCHES)
    y, st = t_mamba.mamba_forward(mixer, cfg, torch.from_numpy(x))
    assert t_ops.LAUNCHES == counts  # CPU tensors launch nothing
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **TOL)
    _assert_state(st, want_st)
    assert st.conv_x.dtype == torch.float32  # x's dtype, as the reference


def test_split_prefill_carries_the_state(pair):
    """[a; b] == a, then b from a's state (tests/test_models.py:175), on
    both sides, and the port's split equals the reference's split."""
    r_cfg, params, cfg, mixer = pair
    x = _x((2, 32, cfg.d_model), seed=5)
    y_full, st_full = t_mamba.mamba_forward(mixer, cfg, torch.from_numpy(x))
    y_a, st_a = t_mamba.mamba_forward(mixer, cfg, torch.from_numpy(x[:, :16]))
    y_b, st_b = t_mamba.mamba_forward(mixer, cfg, torch.from_numpy(x[:, 16:]),
                                      initial_state=st_a)
    np.testing.assert_allclose(_np(y_b), _np(y_full[:, 16:]), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(_np(st_b.ssm), _np(st_full.ssm), atol=1e-3,
                               rtol=1e-3)
    _, r_a = r_mamba.mamba_forward(params, r_cfg, jnp.asarray(x[:, :16]))
    r_y_b, r_b = r_mamba.mamba_forward(params, r_cfg, jnp.asarray(x[:, 16:]),
                                       initial_state=r_a)
    np.testing.assert_allclose(_np(y_b), np.asarray(r_y_b), **TOL)
    _assert_state(st_b, r_b)


def test_decode_steps(pair):
    """Prefill 12 positions, then 6 one-token steps on both sides."""
    r_cfg, params, cfg, mixer = pair
    x = _x((2, 18, cfg.d_model), seed=9)
    _, r_st = r_mamba.mamba_forward(params, r_cfg, jnp.asarray(x[:, :12]))
    _, st = t_mamba.mamba_forward(mixer, cfg, torch.from_numpy(x[:, :12]))
    for pos in range(12, 18):
        want, r_st = r_mamba.mamba_decode_step(params, r_cfg,
                                               jnp.asarray(x[:, pos:pos + 1]),
                                               r_st)
        got, st = t_mamba.mamba_decode_step(mixer, cfg,
                                            torch.from_numpy(x[:, pos:pos + 1]),
                                            st)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                   err_msg=f"position {pos}")
        _assert_state(st, r_st)


def test_init_ssm_state(pair):
    r_cfg, _, cfg, _ = pair
    want = r_mamba.init_ssm_state(r_cfg, 3)
    got = t_mamba.init_ssm_state(cfg, 3, device="cpu")
    for name in ("conv_x", "conv_bc", "ssm"):
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == w.shape and not g.any(), name
        assert str(g.dtype)[6:] == str(w.dtype), name  # bf16 tails, f32 ssm


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, dt, A, Bm, Cm, D, s = (f(2, 4, 8), np.abs(f(2, 4)), -np.abs(f(4)),
                              f(2, 2, 16), f(2, 2, 16), f(4), f(2, 4, 8, 16))
    y, new = t_mamba.ssd_decode_step(*map(torch.from_numpy,
                                          (x, dt, A, Bm, Cm, D, s)))
    wy, wnew = r_mamba.ssd_decode_step(*map(jnp.asarray,
                                            (x, dt, A, Bm, Cm, D, s)))
    np.testing.assert_allclose(_np(y), np.asarray(wy), **TOL)
    np.testing.assert_allclose(_np(new), np.asarray(wnew), **TOL)
