"""The port's four user entry points against the reference's printout on
the same inputs: ``launch.quickstart`` (``examples/quickstart.py``),
``launch.lm_design_space`` (``benchmarks/lm_design_space.py``),
``launch.fault_tolerant_training`` and ``launch.carbon_aware_training``
(their ``examples/`` namesakes). Decisions and integers exact, carbon
within rtol 1e-5; training starts from the reference's initial params
and is held to the training bars of ``test_torch_train.py``: each step's
loss and grad norm within 1e-5 of the reference's from the reference's
state, the first-moment update within 1e-4 of its scale."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import lm_design_space as r_lm  # noqa: E402
from repro import checkpoint as r_ckpt  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs.base import ShapeConfig, ShapeKind  # noqa: E402
from repro.core import Grid as RGrid, grid_trace as r_grid_trace  # noqa: E402
from repro.data import batch_for as r_batch_for  # noqa: E402
from repro.models import init_params as r_init_params  # noqa: E402
from repro.train import carbon_aware as r_ca  # noqa: E402
from repro.train.fault import make_straggler_train_step as r_straggler  # noqa: E402
from repro.train.optimizer import adamw as r_adamw  # noqa: E402
from repro.train.optimizer import warmup_cosine as r_warmup_cosine  # noqa: E402
from repro.train.train_step import init_train_state as r_init_state  # noqa: E402
from repro.train.train_step import make_train_step as r_make_step  # noqa: E402

from repro_torch.launch import carbon_aware_training as t_ca  # noqa: E402
from repro_torch.launch import fault_tolerant_training as t_ft  # noqa: E402
from repro_torch.launch import lm_design_space as t_lm  # noqa: E402
from repro_torch.launch import quickstart as t_qs  # noqa: E402
from repro_torch.models import jax_tree_names  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.train_step import TrainState  # noqa: E402

from torch_fleet_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
LOSS_RTOL = GNORM_RTOL = 1e-5  # tests/test_torch_train.py
#: a whole run without re-syncing to the reference's state drifts (AdamW
#: moves a weight by lr x sign(g), and near-zero gradients flip signs):
#: 20 steps stayed within 1.1e-4 of the reference's losses
RUN_LOSS_RTOL = 5e-4
CPU = ["--device", "cpu"]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(cfg, tree) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in
            jax_tree_names(cfg, jax.tree.map(np.asarray, tree)).items()}


def _port_state(cfg, r_state) -> TrainState:
    return TrainState(_port(cfg, r_state.params), t_opt.AdamState(
        _port(cfg, r_state.opt.mu), _port(cfg, r_state.opt.nu),
        torch.tensor(int(r_state.opt.count), dtype=torch.int32)), None)


def _torch_batch(b) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# --- quickstart --------------------------------------------------------------


def test_quickstart_prints_the_reference(capsys):
    _example("quickstart").main()
    want = capsys.readouterr().out
    got = t_qs.main(CPU)
    assert capsys.readouterr().out == want
    from repro.core import (ChargingBehavior, Environment, Grid, carbon_model,
                            grid_trace, mobile_carbon_intensity, pack_infra,
                            paper_fleet)
    from repro.core.workloads import by_name
    ciso, urban = grid_trace(Grid.CISO), grid_trace(Grid.URBAN)
    env = Environment.make(
        ci_mobile=mobile_carbon_intensity(ChargingBehavior.NIGHTTIME, ciso),
        ci_edge=float(urban.ci_hourly.mean()), ci_core=280.0,
        ci_hyper=float(ciso.ci_hourly.mean()))
    w = by_name("resnet50").workload
    b = carbon_model.evaluate(w, pack_infra(paper_fleet(), "act"), env)
    for field in ("total_cf", "latency", "op_total", "emb_total"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(b, field)), rtol=RTOL)
    assert got.optimal == int(carbon_model.optimal_target(b, w))
    assert got.n_points == 1728
    picks = re.findall(r"^\s+(\S+)\s+carbon-optimal by hour: (.*)$", want,
                       re.M)
    assert {n: str(h) for n, h in got.picks.items()} == dict(picks)


# --- lm_design_space -----------------------------------------------------------


@pytest.fixture(scope="module")
def lm_rows():
    return r_lm.run(), t_lm.main(CPU)


def test_lm_design_space_rows_equal_the_reference(lm_rows):
    """Every row's derived column (tier picks, savings, hours,
    migrations, pauses, carbon) equal; the timing column is each
    package's own."""
    want, got = lm_rows
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.derived == w.derived, g.name


def test_lm_carbon_training_ledgers_equal_the_reference(lm_rows):
    _, got = lm_rows
    pods = [r_ca.PodSpec(name="ciso-pod", trace=r_grid_trace(RGrid.CISO),
                         chips=256, embodied_g=256 * 0.9e6),
            r_ca.PodSpec(name="rural-pod", trace=r_grid_trace(RGrid.RURAL),
                         chips=256, embodied_g=256 * 0.9e6)]
    scheds = {"greedy": r_ca.CarbonSchedule(),
              "deadline72h": r_ca.CarbonSchedule(deadline_h=72),
              "no-elastic": r_ca.CarbonSchedule(elastic=False)}
    for row in got[-3:]:
        tr = r_ca.CarbonAwareTrainer(pods=pods,
                                     schedule=scheds[row.name.split("/")[1]],
                                     steps_per_hour_full=2000)
        ledger = tr.run(total_steps=100_000, start_hour=0)
        _same_ledger(row.values["ledger"], ledger)
        np.testing.assert_allclose(row.values["aware_g"],
                                   tr.total_carbon(ledger), rtol=RTOL)
        base, base_h = tr.baseline_carbon(100_000)
        np.testing.assert_allclose(row.values["base_g"], base, rtol=RTOL)
        assert row.values["base_hours"] == base_h


def _same_ledger(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.hour, g.pod, g.action, g.steps) == (w.hour, w.pod,
                                                      w.action, w.steps)
        np.testing.assert_allclose([g.dp_frac, g.op_g, g.emb_g, g.ci],
                                   [w.dp_frac, w.op_g, w.emb_g, w.ci],
                                   rtol=RTOL)


# --- fault_tolerant_training -----------------------------------------------------


@pytest.fixture(scope="module")
def ft_reference(tmp_path_factory):
    """The reference example's run, step by step: (params0, [(state
    before, sharded batch, alive, n_shards, metrics)], final state)."""
    cfg = r_get_config("deepseek-7b", smoke=True)
    shape = ShapeConfig("t", ShapeKind.TRAIN, 64, 8)

    def sharded(step, n):
        parts = [r_batch_for(cfg, shape, step=step, shard=s, n_shards=n)
                 for s in range(n)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *parts)

    params = r_init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    opt = r_adamw(r_warmup_cosine(2e-3, 10, 60))
    state = r_init_state(params, opt)
    steps = {n: jax.jit(r_straggler(cfg, opt, n_shards=n)) for n in (2, 4)}
    root = str(tmp_path_factory.mktemp("ft_ref"))
    log = []
    for i in range(20):
        n = 4 if i < 12 else 2
        alive = (jnp.asarray([True, True, i not in (5, 6, 7), True])
                 if n == 4 else jnp.ones(2, bool))
        b = sharded(i, n)
        before = state
        state, m = steps[n](state, b, alive)
        log.append((before, b, alive, n, m))
        if i < 12:
            r_ckpt.save(root, i + 1, state)
    return cfg, params, log, state


def test_fault_tolerant_training_run(ft_reference, tmp_path, capsys):
    """The port's run from the reference's params: the same printout up
    to the losses' last digits and the checkpoint path, the same masks,
    restored step and final step; losses within the run's drift bar."""
    cfg, params, log, _ = ft_reference
    run = t_ft.main(CPU + ["--ckpt-dir", str(tmp_path)],
                    params=_port(cfg, params))
    out = capsys.readouterr().out
    assert run.restored == 12 and int(run.state.step) == 20
    assert [m["n_alive"] for m in run.phase1] == [
        3.0 if i in (5, 6, 7) else 4.0 for i in range(12)]
    got = [m["loss"] for m in run.phase1 + run.phase2]
    want = [float(m["loss"]) for *_, m in log]
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=RUN_LOSS_RTOL)
    assert re.sub(r"loss=\d+\.\d+|from \S+", "", out).splitlines() == [
        "phase 1: 4-way DP, rank 2 straggles at steps 5-7",
        "  step  5: straggler masked, n_alive=3, ",
        "  step  6: straggler masked, n_alive=3, ",
        "  step  7: straggler masked, n_alive=3, ",
        "phase 2: node failure at step 12 -> elastic restart on 2-way DP",
        "  restored step 12 ",
        "  continued to step 20 on half the fleet, ",
        "done: masked-gradient math and restart path both exercised"]


def test_fault_tolerant_training_steps_meet_the_training_bars(ft_reference):
    """Each of the run's 20 steps (4-way, the masked straggler, then
    2-way) through the port's step function from the reference's state
    before it: loss and grad norm within 1e-5, the first moment within
    1e-4 of its scale."""
    cfg, _, log, _ = ft_reference
    from repro_torch.models import Transformer
    from repro_torch.train.fault import make_straggler_train_step
    model = Transformer(t_ft.CFG, device="cpu")
    opt = t_opt.adamw(t_opt.warmup_cosine(2e-3, 10, 60))
    steps = {n: make_straggler_train_step(model, opt, n_shards=n)
             for n in (2, 4)}
    for i, (before, b, alive, n, m) in enumerate(log):
        state, tm = steps[n](_port_state(cfg, before), _torch_batch(b),
                             torch.from_numpy(np.asarray(alive)))
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=GNORM_RTOL)
        assert float(tm["n_alive"]) == float(m["n_alive"])
    for name, want in _port(cfg, ft_reference[3].opt.mu).items():
        scale = float(want.abs().max())
        torch.testing.assert_close(state.opt.mu[name], want,
                                   atol=1e-4 * scale + 1e-9, rtol=0)


# --- carbon_aware_training --------------------------------------------------------


CA_STEPS = 2
CA_ARGS = ["--steps", str(CA_STEPS), "--seq-len", "32", "--batch", "2"]


def test_carbon_aware_ledger_at_the_default_steps_equals_the_reference():
    """The ledger of the example's default run (300 steps from step 0),
    decided by the same trainer: its hook returns the steps it was asked
    for, so the ledger does not depend on the training."""
    ref = _example("carbon_aware_training")
    pods = [r_ca.PodSpec(name="ciso", trace=r_grid_trace(RGrid.CISO),
                         chips=8, embodied_g=8 * 0.9e6),
            r_ca.PodSpec(name="rural", trace=r_grid_trace(RGrid.RURAL),
                         chips=8, embodied_g=8 * 0.9e6)]
    want_tr = ref.CarbonAwareTrainer(
        pods=pods, schedule=ref.CarbonSchedule(deadline_h=48),
        steps_per_hour_full=300 // 12)
    tr = t_ca.trainer(300, "cpu")
    _same_ledger(tr.run(total_steps=300, start_hour=6),
                 want_tr.run(total_steps=300, start_hour=6))
    np.testing.assert_allclose(tr.baseline_carbon(300)[0],
                               want_tr.baseline_carbon(300)[0], rtol=RTOL)
    assert t_ca.CFG_100M == type(t_ca.CFG_100M)(**{
        k: getattr(ref.CFG_100M, k) for k in
        t_ca.CFG_100M.__dataclass_fields__})


def test_carbon_aware_training_run(tmp_path, capsys):
    """The example's run at a smoke step count from the reference's
    params: its ledger, the reference's steps' losses (the first within
    1e-5), checkpoints resumable; then a second run resumes from the
    last checkpoint (over the weights it starts from) and has nothing
    left to train."""
    ref = _example("carbon_aware_training")
    cfg = ref.CFG_100M
    params = jax.jit(r_init_params, static_argnums=1,
                     static_argnames="dtype")(jax.random.PRNGKey(0), cfg,
                                              dtype=jnp.float32)
    opt = r_adamw(r_warmup_cosine(1e-3, 30, CA_STEPS))
    step = jax.jit(r_make_step(cfg, opt, remat="dots"))
    state = r_init_state(params, opt)
    shape = ShapeConfig("train", ShapeKind.TRAIN, 32, 2)
    want = []
    for i in range(CA_STEPS):
        state, m = step(state, r_batch_for(cfg, shape, step=i))
        want.append(float(m["loss"]))
    del state

    ckpt_dir = str(tmp_path / "ca")
    run = t_ca.main(CPU + CA_ARGS + ["--ckpt", ckpt_dir],
                    params=_port(cfg, params))
    np.testing.assert_allclose(run.losses[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(run.losses, want, rtol=RUN_LOSS_RTOL)
    assert int(run.state.step) == CA_STEPS
    pods = [r_ca.PodSpec(name="ciso", trace=r_grid_trace(RGrid.CISO),
                         chips=8, embodied_g=8 * 0.9e6),
            r_ca.PodSpec(name="rural", trace=r_grid_trace(RGrid.RURAL),
                         chips=8, embodied_g=8 * 0.9e6)]
    tr = r_ca.CarbonAwareTrainer(pods=pods,
                                 schedule=r_ca.CarbonSchedule(deadline_h=48),
                                 steps_per_hour_full=1)
    _same_ledger(run.ledger, tr.run(total_steps=CA_STEPS, start_hour=6))
    out = capsys.readouterr().out
    assert out.startswith("model: danube-100m, 80M params\n")
    assert f"hourly ledger ({len(run.ledger)} simulated hours)" in out
    assert sorted(p.name for p in Path(ckpt_dir).iterdir()) == [
        f"step_{CA_STEPS - 1}", f"step_{CA_STEPS}"]

    again = t_ca.main(CPU + CA_ARGS + ["--ckpt", ckpt_dir],
                      params=_port(cfg, params))
    assert again.resumed_from == CA_STEPS and again.losses == []
    assert (f"resumed from checkpoint step {CA_STEPS}"
            in capsys.readouterr().out)
