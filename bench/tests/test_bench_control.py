"""The comparison that decides ``correct`` fails what it should fail, at
sizes a test run holds: the lower-precision control and the training
faults, held against a cell's limits by ``harness.control`` (what
``bench/calibrate.py`` runs on the card at the cells' own sizes), read not
correct while the program reads correct; and a run whose timed path is
broken underneath comes out not correct (a decode step that returns its
state unchanged, a token altered where it is produced, a training step
that returns its state unchanged, half of each training batch left
out)."""

import time

import pytest
import torch

from bench.harness import control
from bench.harness.cell import load_cell
from bench.harness.cli import run_cell
from bench.tests.smoke import make_root
from bench.tests.test_bench_reference import config, reference, served

CPU = torch.device("cpu")
# the smoke cells run in float32 on the CPU, where the program and the
# reference agree to ~1e-6: any limit between that and the faults' gaps
LIMITS = {"danube-smoke-chat": {"served_token_gap": 1e-3},
          "jamba-smoke-rag": {"served_token_gap": 1e-3},
          # bf16 on the CPU: the program's widest gap read up to 0.026 and
          # its fp8 control's at least 0.101 over ten seeds, one batch
          # judged or two
          "danube-smoke-bf16-chat": {"served_token_gap": 0.05},
          "danube-smoke-train": {"loss_gap": 1e-5, "grad_norm_gap": 1e-4,
                                 "change_norm_gap": 1e-4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def drive(root, name, seed=2_400_000_011):
    cell = load_cell(name, root)
    return run_cell(cell, seed, 0.3, False, CPU, time.time())


@pytest.mark.parametrize("name,control", [("danube-smoke", "tf32"),
                                          ("jamba-smoke", "fp8")])
def test_control_lands_far_above_the_program(name, control):
    cfg = config(name)
    prog, toks, prompt = served(cfg, CPU, B=4, S=48, new=16)
    ref = reference(cfg, CPU, prompt, toks)
    ctl = reference(cfg, CPU, prompt, toks, precision=control)
    assert (ctl - ref).abs().max() > 10 * (prog - ref).abs().max()


@pytest.mark.parametrize("seed", [2_400_000_021, 2_400_000_022,
                                  2_400_000_023])
@pytest.mark.parametrize("name,kinds", [
    ("danube-smoke-bf16-chat", {"control", "witness"}),
    ("danube-smoke-train", {"control", "half_batch", "state_unchanged"})])
def test_control_and_faults_read_not_correct(root, name, kinds, seed):
    """The readings calibrate.py takes, through the rule of ``correct`` at
    the cell's limits: the program correct, every control and fault not."""
    cell = load_cell(name, root)
    run = run_cell(cell, seed, 0.3, False, CPU, time.time())
    nums, _ = control.readings(run, CPU)
    verdict = control.verdicts(nums, cell.workload["limits"])
    assert set(verdict) == {"program"} | kinds
    assert verdict["program"]["correct"], verdict
    assert control.faults_caught(verdict), verdict
    assert not any(verdict[k]["correct"] for k in kinds - {"witness"})


def test_a_reading_without_a_limited_number_is_refused():
    with pytest.raises(ValueError):
        control.verdicts({"control": {"other": 1.0}},
                         {"served_token_gap": 1e-3})


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_sound_runs_are_correct(root, name):
    run = drive(root, name)
    assert run.correct, run.checks


def test_decode_step_that_keeps_its_state(root, monkeypatch):
    from repro_torch.serve import ServeEngine

    step = ServeEngine.serve_step

    def stuck(self, state, tokens):
        logits, _ = step(self, state, tokens)
        return logits, state

    monkeypatch.setattr(ServeEngine, "serve_step", stuck)
    for name in ("danube-smoke-chat", "jamba-smoke-rag"):
        run = drive(root, name)
        assert not run.correct, run.checks


def test_token_altered_where_it_is_produced(root, monkeypatch):
    from repro_torch.serve import ServeEngine

    step = ServeEngine.serve_step

    def shifted(self, state, tokens):
        logits, state = step(self, state, tokens)
        return logits.roll(1, dims=-1), state

    monkeypatch.setattr(ServeEngine, "serve_step", shifted)
    run = drive(root, "danube-smoke-chat")
    assert not run.correct, run.checks


def test_train_step_that_keeps_its_state(root, monkeypatch):
    import repro_torch.train as train

    make = train.make_train_step

    def frozen(*a, **kw):
        step = make(*a, **kw)

        def run_step(state, batch):
            snapshot = {k: v.detach().clone() for k, v in state.params.items()}
            new, metrics = step(state, batch)
            with torch.no_grad():
                for k, v in new.params.items():
                    v.copy_(snapshot[k])
            return new, metrics
        return run_step

    monkeypatch.setattr(train, "make_train_step", frozen)
    run = drive(root, "danube-smoke-train")
    assert not run.correct
    assert run.checks["change_norm_gap"][0] == pytest.approx(1.0)


def test_train_step_on_half_the_batch(root, monkeypatch):
    import repro_torch.train as train

    make = train.make_train_step

    def halved(*a, **kw):
        step = make(*a, **kw)
        return lambda state, batch: step(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(train, "make_train_step", halved)
    run = drive(root, "danube-smoke-train")
    assert not run.correct, run.checks


def test_a_fault_in_one_slot_fails_jamba_rags_own_limits():
    """jamba-rag judges 4 batches of 4 requests of 16 tokens over 65,536
    ids. On reference logits of std 1, a sound background at or above the
    largest readings of the program's twelve calibration seeds (mean 0.039,
    mean square 0.017: 23 tokens each at least 0.436 below the best) holds;
    two
    tokens of one request altered where they are produced (the next id),
    or one token that is the vocabulary's median choice, do not, though
    the mean gap alone would let them pass."""
    from bench.harness.record import within
    from bench.reference import judge

    wl = load_cell("jamba-rag").workload
    limits = wl["limits"]
    B, n = wl["traffic"]["batch"], wl["traffic"]["cycle"][0]["new"]
    V = load_cell("jamba-rag").config["model"]["vocab_size"]
    g = torch.Generator().manual_seed(24)
    refs = [torch.randn(B, n, V, generator=g)
            for _ in range(wl["judge"]["batches"])]
    sound = [r.argmax(-1) for r in refs]
    for k in range(23):  # the background, spread over batches and slots
        f = k * 11 % (len(refs) * B * n)  # 23 distinct positions
        b, s, p = f // (B * n), f // n % B, f % n
        gaps = refs[b][s, p].max() - refs[b][s, p]
        sound[b][s, p] = torch.where(gaps >= 0.436, gaps, torch.inf).argmin()

    def held(tokens):
        nums = judge.gap_numbers(refs, tokens)
        return within({k: (nums[k], lim) for k, lim in limits.items()}), nums

    ok, nums = held(sound)
    assert ok, nums
    assert nums["served_token_gap_mean"] >= 0.039
    assert nums["served_token_gap_sq_mean"] >= 0.017

    two = [t.clone() for t in sound]
    two[1][2, 7] = (two[1][2, 7] + 1) % V
    two[1][2, 11] = (two[1][2, 11] + 1) % V
    median = [t.clone() for t in sound]
    median[3][0, 9] = refs[3][0, 9].argsort()[V // 2]
    for faulty in (two, median):
        ok, nums = held(faulty)
        assert not ok, nums
        assert nums["served_token_gap_mean"] <= limits["served_token_gap_mean"]
