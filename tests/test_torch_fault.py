"""The port's fault tolerance (``repro_torch.train.fault``), mirroring the
reference's ``tests/test_fault.py`` on ``deepseek-7b-smoke`` (f32, 32
tokens, a global batch of 8 in 4 shards): all ranks alive equals the
plain step, a dead rank is masked out exactly as training on the other
three, a failed quorum is a no-op, and elastic restart (fail at 12,
restore step 10, reach 20) equals the uninterrupted run bit for bit; the
straggler step's loss matches the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro.models import init_params as r_init_params  # noqa: E402
from repro.train import fault as r_fault  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import train_step as r_ts  # noqa: E402
from repro.data import batch_for as r_batch_for  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.models import Transformer, load_jax_params  # noqa: E402
from repro_torch.train import (  # noqa: E402
    ElasticRunner,
    StragglerPolicy,
    adamw,
    constant_lr,
    init_train_state,
    make_straggler_train_step,
    make_train_step,
)
from torch_fleet_parity import one_thread  # noqa: E402,F401

ARCH = "deepseek-7b"
CFG = get_config(ARCH, smoke=True)
SHAPE = ShapeConfig("t", ShapeKind.TRAIN, 32, 8)


@pytest.fixture(scope="module")
def pair():
    """(reference params, port model holding them, the initial params)."""
    params = r_init_params(jax.random.PRNGKey(1), r_get_config(ARCH, smoke=True),
                           dtype=jnp.float32)
    model = Transformer(CFG, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, model, {k: v.detach().clone()
                           for k, v in model.named_parameters()}


def _state(p0, opt):
    return init_train_state({k: v.clone() for k, v in p0.items()}, opt)


def _sharded(step, n_shards=4):
    parts = [batch_for(CFG, SHAPE, step=step, shard=s, n_shards=n_shards)
             for s in range(n_shards)]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def _close(a, b, **tol):
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], **tol)


def test_all_alive_matches_plain_step(pair, one_thread):
    _, model, p0 = pair
    opt = adamw(constant_lr(1e-3))
    sharded = _sharded(0)
    batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in sharded.items()}
    s_plain, m_plain = make_train_step(model, opt)(_state(p0, opt), batch)
    s_frag, m_frag = make_straggler_train_step(model, opt, n_shards=4)(
        _state(p0, opt), sharded, torch.ones(4, dtype=torch.bool))
    np.testing.assert_allclose(float(m_plain["loss"]), float(m_frag["loss"]),
                               rtol=1e-4)
    _close(s_plain, s_frag, atol=2e-5, rtol=2e-4)


def test_straggler_masked_out(pair, one_thread):
    _, model, p0 = pair
    opt = adamw(constant_lr(1e-3))
    sharded = _sharded(0)
    s1, m1 = make_straggler_train_step(model, opt, n_shards=4)(
        _state(p0, opt), sharded, torch.tensor([True, True, False, True]))
    assert float(m1["n_alive"]) == 3.0 and float(m1["aborted"]) == 0.0
    alive = {k: v[[0, 1, 3]] for k, v in sharded.items()}
    s2, m2 = make_straggler_train_step(model, opt, n_shards=3)(
        _state(p0, opt), alive, torch.ones(3, dtype=torch.bool))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    _close(s1, s2, atol=1e-5, rtol=1e-4)


def test_quorum_failure_is_noop(pair, one_thread):
    _, model, p0 = pair
    opt = adamw(constant_lr(1e-3))
    step = make_straggler_train_step(model, opt, n_shards=4,
                                     policy=StragglerPolicy(min_quorum=0.75))
    state = _state(p0, opt)
    new, m = step(state, _sharded(0), torch.tensor([True, True, False,
                                                    False]))
    assert float(m["aborted"]) == 1.0 and int(new.step) == 0
    for k in p0:
        assert torch.equal(new.params[k], p0[k])


def test_straggler_loss_matches_reference(pair, one_thread):
    """The reference's straggler step on the same sharded batch and mask
    (one rank dead): loss and grad norm."""
    params, model, p0 = pair
    r_cfg = r_get_config(ARCH, smoke=True)
    parts = [r_batch_for(r_cfg, SHAPE, step=0, shard=s, n_shards=4)
             for s in range(4)]
    r_sharded = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    mask = np.array([True, False, True, True])
    r_o = r_opt.adamw(r_opt.constant_lr(1e-3))
    _, rm = jax.jit(r_fault.make_straggler_train_step(r_cfg, r_o, n_shards=4))(
        r_ts.init_train_state(params, r_o), r_sharded, jnp.asarray(mask))
    opt = adamw(constant_lr(1e-3))
    _, tm = make_straggler_train_step(model, opt, n_shards=4)(
        _state(p0, opt), _sharded(0), torch.from_numpy(mask))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)


def test_elastic_restart_resumes_exactly(pair, tmp_path, one_thread):
    """Kill at step 12, restore from the step-10 checkpoint, continue: the
    final state equals the uninterrupted run bit for bit (same data)."""
    _, model, p0 = pair
    opt = adamw(constant_lr(1e-3))
    step_fn = make_train_step(model, opt)

    def make_batch(i):
        return batch_for(CFG, SHAPE, step=i)

    s_ref = _state(p0, opt)
    for i in range(20):
        s_ref, _ = step_fn(s_ref, make_batch(i))

    root = str(tmp_path)

    def failure_handler(state):
        return ckpt.restore(root, ckpt.latest_step(root), state), step_fn

    runner = ElasticRunner(ckpt_root=root, save_every=10)
    s_run, hist = runner.run(_state(p0, opt), 20, make_batch=make_batch,
                             step_fn=step_fn, failures={12: failure_handler})
    assert int(s_run.step) == 20 and len(hist) == 22
    assert ckpt.latest_step(root) == 20
    for k in p0:
        assert torch.equal(s_run.params[k], s_ref.params[k]), k
        assert torch.equal(s_run.opt.mu[k], s_ref.opt.mu[k]), k


def test_launcher_resumes_from_its_checkpoint(tmp_path, one_thread):
    """``launch.train`` for 6 steps, saving every 2; with the step-6
    checkpoint gone (a crash after step 4), the same command resumes from
    step 4 and ends where the whole run ended, bit for bit, in the model's
    own parameters."""
    import shutil

    from repro_torch.launch import train

    root = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--device", "cpu", "--seq-len", "32", "--batch",
            "4", "--log-every", "2", "--warmup", "2", "--steps", "6",
            "--ckpt-dir", root, "--save-every", "2"]
    whole = train.main(args)
    assert ckpt.latest_step(root) == 6 and len(whole.history) == 6
    shutil.rmtree(tmp_path / "ck" / "step_6")
    resumed = train.main(args)
    assert len(resumed.history) == 2 and int(resumed.state.step) == 6
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[4:]]
    for (k, a), (_, b) in zip(resumed.model.named_parameters(),
                              whole.model.named_parameters()):
        assert torch.equal(a, b), k
