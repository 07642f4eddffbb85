"""The port's training substrate against the JAX reference on the CPU:
AdamW, the global-norm clip and the schedules on seeded numpy trees;
``cross_entropy``; ``sdpa`` on its dense, blocked-causal and banded-SWA
branches (the danube smoke config with ``attn_block_q=8``, S=64, window
16) and ``ssd_chunked`` with and without an initial state, values and
input gradients; then whole steps on ``h2o-danube-1.8b-smoke``: remat
policies and microbatching leave the gradients unchanged, ``grad_dtype``
casts them, and three ``make_train_step`` steps match the reference's
losses and grad norms. Inputs come from numpy; reference params from
``init_params``, carried by ``load_jax_params``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro.data import batch_for as r_batch_for  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import mamba2 as r_mamba  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import train_step as r_ts  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Transformer,
    count_params,
    cross_entropy,
    jax_tree_names,
    load_jax_params,
    param_bytes,
    sdpa,
    ssd_chunked,
)
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    grads_over_microbatches,
    init_train_state,
    make_train_step,
)
from torch_fleet_parity import one_thread  # noqa: E402,F401

ARCH = "h2o-danube-1.8b"
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
FN_TOL = dict(rtol=1e-5, atol=1e-5)  # sdpa / ssd_chunked values and grads
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-5
SHAPE = ShapeConfig("t", ShapeKind.TRAIN, 32, 4)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.detach().float().cpu().numpy()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": _normal(rng, (3, 4)), "b": _normal(rng, (4,)),
            "m": _normal(rng, (2, 3, 5)), "s": _normal(rng, ())}


class TestOptimizer:
    @pytest.mark.parametrize("max_norm", [1.0, 100.0])
    def test_clip_and_global_norm_match_reference(self, max_norm):
        tree = _tree(0)
        r_clip, r_norm = r_opt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        t_clip, t_norm = t_opt.clip_by_global_norm(
            {k: _t(v) for k, v in tree.items()}, max_norm)
        np.testing.assert_allclose(_np(t_norm), np.asarray(r_norm), **OPT_TOL)
        for k in tree:
            np.testing.assert_allclose(_np(t_clip[k]), np.asarray(r_clip[k]),
                                       **OPT_TOL)

    @pytest.mark.parametrize("count", [0, 1, 5, 10, 37, 100, 140])
    def test_schedules_match_reference(self, count):
        r_lr = r_opt.warmup_cosine(3e-3, 10, 100)(jnp.asarray(count))
        t_lr = t_opt.warmup_cosine(3e-3, 10, 100)(torch.tensor(count))
        np.testing.assert_allclose(_np(t_lr), np.asarray(r_lr), **OPT_TOL)
        assert float(t_opt.constant_lr(0.25)(torch.tensor(count))) == 0.25

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_adamw_three_steps_match_reference(self, dtype):
        """Three updates (clip first, count + 1 for the bias correction and
        the schedule, decay on matrices only, float32 moments): params,
        moments, count and the pre-clip norm."""
        kw = dict(weight_decay=0.1, max_grad_norm=1.0)
        r = r_opt.adamw(r_opt.warmup_cosine(1e-2, 2, 10), **kw)
        t = t_opt.adamw(t_opt.warmup_cosine(1e-2, 2, 10), **kw)
        params = _tree(1)
        rp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
        tp = {k: _t(v).to(getattr(torch, dtype)) for k, v in params.items()}
        rs, ts = r.init(rp), t.init(tp)
        for i in range(3):
            grads = _tree(10 + i)
            rp, rs, rn = r.update(jax.tree.map(jnp.asarray, grads), rs, rp)
            tp, ts, tn = t.update({k: _t(v) for k, v in grads.items()}, ts,
                                  tp)
            np.testing.assert_allclose(_np(tn), np.asarray(rn), **OPT_TOL)
        assert int(ts.count) == int(rs.count) == 3
        for k in params:
            assert tp[k].dtype == getattr(torch, dtype)
            assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32
            np.testing.assert_allclose(_np(ts.mu[k]), np.asarray(rs.mu[k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(_np(ts.nu[k]), np.asarray(rs.nu[k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(
                _np(tp[k]), np.asarray(rp[k].astype(jnp.float32)),
                **(OPT_TOL if dtype == "float32" else dict(rtol=8e-3)))

    def test_weight_decay_only_on_matrices(self):
        opt = t_opt.adamw(0.1, weight_decay=0.5, max_grad_norm=1e9)
        p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
        new, _, _ = opt.update({k: torch.zeros_like(v) for k, v in p.items()},
                               opt.init(p), p)
        assert float(new["w"][0, 0]) < 1.0
        np.testing.assert_array_equal(_np(new["b"]), 1.0)


class TestLoss:
    @pytest.mark.parametrize("masked", [False, True])
    def test_cross_entropy_matches_reference(self, masked):
        rng = np.random.default_rng(3)
        logits = _normal(rng, (2, 7, 11), 3.0)
        labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
        mask = (rng.random((2, 7)) > 0.4).astype(np.float32) if masked \
            else None
        want = r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      None if mask is None else
                                      jnp.asarray(mask))
        got = cross_entropy(_t(logits), _t(labels).long(),
                            None if mask is None else _t(mask))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)

    def test_cross_entropy_empty_mask_floors_count(self):
        logits = torch.zeros((1, 3, 5))
        got = cross_entropy(logits, torch.zeros((1, 3), dtype=torch.long),
                            torch.zeros((1, 3)))
        assert float(got) == 0.0


def _vjp_pair(r_fn, t_fn, inputs, seed):
    """Outputs and input gradients of sum(out * cotangent) for the
    reference function and the port's, on the same numpy inputs."""
    r_out = r_fn(*map(jnp.asarray, inputs))
    outs = r_out if isinstance(r_out, tuple) else (r_out,)
    rng = np.random.default_rng(seed)
    cot = [_normal(rng, np.shape(o)) for o in outs]

    def r_obj(*xs):
        o = r_fn(*xs)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * c) for a, c in zip(o, cot))

    r_grads = jax.grad(r_obj, argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))
    leaves = [_t(x).requires_grad_(True) for x in inputs]
    t_out = t_fn(*leaves)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    obj = sum((a * _t(c)).sum() for a, c in zip(t_outs, cot))
    t_grads = torch.autograd.grad(obj, leaves)
    return outs, t_outs, r_grads, t_grads


class TestPlainPaths:
    @pytest.mark.parametrize("branch", ["dense", "blocked-causal",
                                        "banded-swa", "non-causal",
                                        "window-covers-all"])
    def test_sdpa_matches_reference(self, branch):
        """danube smoke with attn_block_q=8 at S=64: the dense form, the
        blocked causal form over full keys, the banded SWA form (window
        16, keys padded by 8 and a span of 16), the non-causal dense form
        of the encoder and cross attention, and a window of Sk."""
        cfg = dataclasses.replace(r_get_config(ARCH, smoke=True),
                                  attn_block_q=8)
        rng = np.random.default_rng(4)
        S, H, Hkv, D = 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (_normal(rng, (2, S, h, D)) for h in (H, Hkv, Hkv))
        kw = {"dense": dict(causal=True, window=16),
              "blocked-causal": dict(causal=True, block_q=8),
              "banded-swa": dict(causal=True, window=16, block_q=8),
              "non-causal": dict(causal=False),
              "window-covers-all": dict(causal=True, window=S,
                                        block_q=8)}[branch]
        outs, t_outs, rg, tg = _vjp_pair(
            lambda a, b, c: r_attn.sdpa(a, b, c, **kw),
            lambda a, b, c: sdpa(a, b, c, **kw), (q, k, v), 5)
        np.testing.assert_allclose(_np(t_outs[0]), np.asarray(outs[0]),
                                   **FN_TOL)
        for a, b in zip(tg, rg):
            np.testing.assert_allclose(_np(a), np.asarray(b), **FN_TOL)

    @pytest.mark.parametrize("init", [False, True])
    def test_ssd_chunked_matches_reference(self, init):
        rng = np.random.default_rng(6)
        Bsz, S, H, P, N, chunk = 2, 64, 4, 8, 16, 16
        x = _normal(rng, (Bsz, S, H, P))
        dt = np.log1p(np.exp(_normal(rng, (Bsz, S, H)))).astype(np.float32)
        A = -np.exp(_normal(rng, (H,), 0.5)).astype(np.float32)
        B, C = _normal(rng, (Bsz, S, 1, N)), _normal(rng, (Bsz, S, 1, N))
        D = _normal(rng, (H,))
        inputs = [x, dt, A, B, C, D]
        if init:
            inputs.append(_normal(rng, (Bsz, H, P, N)))

        def r_fn(*a):
            return r_mamba.ssd_chunked(*a[:6], chunk=chunk,
                                       initial_state=a[6] if init else None)

        def t_fn(*a):
            return ssd_chunked(*a[:6], chunk=chunk,
                               initial_state=a[6] if init else None)

        outs, t_outs, rg, tg = _vjp_pair(r_fn, t_fn, inputs, 7)
        for a, b in zip(t_outs, outs):
            np.testing.assert_allclose(_np(a), np.asarray(b), **FN_TOL)
        for a, b in zip(tg, rg):
            np.testing.assert_allclose(_np(a), np.asarray(b), **FN_TOL)

    def test_ssd_chunked_gradient_finite_past_exp_overflow(self):
        """A chunk whose decay passes e^88 (dt 0.5, A down to -4, a chunk
        of 256): the reference's ``where(tri, exp(seg), 0)`` overflows in
        the masked triangle and its dt gradient is NaN; the port's
        ``exp(-inf)`` there gives the same values and a finite gradient,
        equal to the reference's where the reference's is finite."""
        rng = np.random.default_rng(8)
        S, H, chunk = 256, 4, 256
        x = _normal(rng, (1, S, H, 8))
        dt = np.full((1, S, H), 0.5, np.float32)
        A = -np.arange(1, H + 1, dtype=np.float32)
        B, C = _normal(rng, (1, S, 1, 16)), _normal(rng, (1, S, 1, 16))
        D = np.ones(H, np.float32)
        outs, t_outs, rg, tg = _vjp_pair(
            lambda *a: r_mamba.ssd_chunked(*a, chunk=chunk)[0],
            lambda *a: ssd_chunked(*a, chunk=chunk)[0],
            [x, dt, A, B, C, D], 9)
        np.testing.assert_allclose(_np(t_outs[0]), np.asarray(outs[0]),
                                   **FN_TOL)
        assert not np.isfinite(np.asarray(rg[1])).all()
        for a, b in zip(tg, rg):
            assert torch.isfinite(a).all()
            ok = np.isfinite(np.asarray(b))
            np.testing.assert_allclose(_np(a)[ok], np.asarray(b)[ok],
                                       rtol=1e-4, atol=1e-4)

    def test_ssd_chunked_refuses_ragged_sequence(self):
        x = torch.zeros((1, 10, 2, 4))
        with pytest.raises(ValueError, match="multiple"):
            ssd_chunked(x, torch.zeros((1, 10, 2)), torch.zeros(2),
                        torch.zeros((1, 10, 1, 4)), torch.zeros((1, 10, 1, 4)),
                        torch.zeros(2), chunk=4)


@pytest.fixture(scope="module")
def danube():
    """(reference cfg, reference params, port model, the reference's
    value_and_grad of loss_fn, a batch as numpy and as port tensors)."""
    cfg = r_get_config(ARCH, smoke=True)
    params = jax.jit(r_tf.init_params, static_argnums=1,
                     static_argnames="dtype")(jax.random.PRNGKey(0), cfg,
                                              dtype=jnp.float32)
    model = Transformer(get_config(ARCH, smoke=True), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    batch = {k: np.asarray(v) for k, v in
             r_batch_for(cfg, SHAPE, step=0).items()}
    return cfg, params, model, batch


def _port_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind == "i"
            else torch.tensor(v) for k, v in batch.items()}


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


class TestSteps:
    def test_count_params_and_bytes_match_reference(self, danube):
        cfg, params, model, _ = danube
        assert count_params(model) == r_tf.count_params(params) == \
            cfg.param_count()
        assert count_params(dict(model.named_parameters())) == \
            r_tf.count_params(params)
        assert param_bytes(model) == r_tf.param_bytes(params)
        bf16 = Transformer(get_config(ARCH, smoke=True), device="cpu",
                           dtype=torch.bfloat16)
        r_bf16 = jax.eval_shape(lambda: r_tf.init_params(
            jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
        assert param_bytes(bf16) == r_tf.param_bytes(r_bf16)

    def test_remat_policies_leave_gradients_unchanged(self, danube,
                                                      one_thread):
        _, _, model, batch = danube
        params, b = _params(model), _port_batch(batch)
        want, _ = grads_over_microbatches(model, params, b, remat="none")
        for policy in ("dots", "minimal"):
            got, _ = grads_over_microbatches(model, params, b, remat=policy)
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=1e-6,
                                           atol=1e-7)

    def test_unknown_remat_policy_raises(self, danube):
        _, _, model, batch = danube
        with pytest.raises(ValueError, match="unknown remat"):
            grads_over_microbatches(model, _params(model),
                                    _port_batch(batch), remat="everything")

    def test_two_microbatches_match_one(self, danube, one_thread):
        """The float32 mean of two half-batch gradients, against the
        reference's own two-microbatch gradient and the port's one-batch
        gradient (the reference's bar, tests/test_train.py)."""
        cfg, params, model, batch = danube
        p, b = _params(model), _port_batch(batch)
        g1, m1 = grads_over_microbatches(model, p, b, remat="none")
        g2, m2 = grads_over_microbatches(model, p, b, microbatches=2,
                                         remat="none")
        r2, _ = jax.jit(lambda p_, b_: r_ts._grads_over_microbatches(
            p_, b_, cfg, microbatches=2, remat="none", use_pallas=False))(
            params, jax.tree.map(jnp.asarray, batch))
        r2 = jax_tree_names(model.cfg, jax.tree.map(np.asarray, r2))
        for k in g1:
            assert g2[k].dtype == torch.float32
            np.testing.assert_allclose(_np(g2[k]), _np(g1[k]), atol=2e-4,
                                       rtol=2e-3)
            scale = np.abs(r2[k]).max()
            np.testing.assert_allclose(_np(g2[k]), r2[k],
                                       atol=1e-4 * scale + 1e-7, rtol=0)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-5)

    def test_grad_dtype_casts_before_the_optimizer(self, danube, one_thread):
        _, _, model, batch = danube
        seen = {}

        def update(grads, state, params):
            seen.update({k: g.dtype for k, g in grads.items()})
            return inner.update(grads, state, params)

        inner = t_opt.adamw(1e-3)
        opt = t_opt.Optimizer(init=inner.init, update=update)
        step = make_train_step(model, opt, grad_dtype=torch.bfloat16)
        state = init_train_state(_params(model), opt)
        state, m = step(state, _port_batch(batch))
        assert set(seen.values()) == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in state.params.values())
        assert int(state.step) == 1 and float(m["step"]) == 1.0

    def test_kernels_refused_for_training(self, danube):
        _, _, model, _ = danube
        with pytest.raises(NotImplementedError, match="no backward"):
            make_train_step(model, t_opt.adamw(1e-3), use_kernels=True)

    def test_three_steps_match_reference(self, danube, one_thread):
        """``make_train_step`` (remat dots, warm-up cosine) for three steps
        on the reference's batches, each from the reference's own state
        carried across by ``jax_tree_names`` (AdamW's first step moves a
        parameter by the sign of its gradient, so a near-zero gradient
        whose sign the two packages round apart moves it 2 lr apart, and
        the states drift): loss within 1e-5, grad norm within 1e-5
        relative, the moments and the count equal after each step."""
        cfg, params, model, _ = danube
        r_o = r_opt.adamw(r_opt.warmup_cosine(1e-3, 2, 10))
        t_o = t_opt.adamw(t_opt.warmup_cosine(1e-3, 2, 10))
        r_state = r_ts.init_train_state(params, r_o)
        r_step = jax.jit(r_ts.make_train_step(cfg, r_o, remat="dots"))
        t_step = make_train_step(model, t_o, remat="dots")

        def port(tree):
            return {k: torch.tensor(np.asarray(v)) for k, v in
                    jax_tree_names(model.cfg, jax.tree.map(np.asarray,
                                                           tree)).items()}

        for i in range(3):
            t_state = TrainState(port(r_state.params), t_opt.AdamState(
                port(r_state.opt.mu), port(r_state.opt.nu),
                torch.tensor(int(r_state.opt.count), dtype=torch.int32)),
                None)
            b = r_batch_for(cfg, SHAPE, step=i)
            r_state, rm = r_step(r_state, b)
            t_state, tm = t_step(t_state, _port_batch(
                {k: np.asarray(v) for k, v in b.items()}))
            np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(rm["grad_norm"]),
                                       rtol=GNORM_RTOL)
            assert float(tm["step"]) == float(rm["step"]) == i + 1
            for name, want in port(r_state.opt.mu).items():
                scale = float(want.abs().max())
                torch.testing.assert_close(t_state.opt.mu[name], want,
                                           atol=1e-4 * scale + 1e-9, rtol=0)
