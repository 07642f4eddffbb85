"""The port's ``CarbonAwareTrainer`` (``repro_torch.train.carbon_aware``, a
copy of the numpy-only reference module over the port's own grids),
mirroring the reference's ``tests/test_carbon_trainer.py``, and its
ledger equal to the reference's, row for row and float for float, on
every schedule those tests use (the grids are bit-identical, ROADMAP C3)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Grid as RGrid  # noqa: E402
from repro.core import grid_trace as r_grid_trace  # noqa: E402
from repro.train import carbon_aware as r_ca  # noqa: E402

from repro_torch.core import Grid, grid_trace  # noqa: E402
from repro_torch.train.carbon_aware import (  # noqa: E402
    CarbonAwareTrainer,
    CarbonSchedule,
    PodSpec,
)

#: (schedule kwargs, pods used, steps_per_hour_full, total_steps, start)
CASES = [({}, 2, 500, 5000, 0),
         (dict(pause_threshold=100.0, elastic=False), 1, 500, 2000, 20),
         (dict(migrate_min_ci_gap=10.0), 2, 1000, 8000, 18),
         (dict(pause_threshold=50.0, deadline_h=12, min_dp_frac=0.25), 1,
          1000, 6000, 0),
         ({}, 1, 500, 4000, 0)]


def _pods():
    return [PodSpec(name="ciso", trace=grid_trace(Grid.CISO, device="cpu"),
                    chips=64, embodied_g=64 * 0.9e6),
            PodSpec(name="rural", trace=grid_trace(Grid.RURAL, device="cpu"),
                    chips=64, embodied_g=64 * 0.9e6)]


def _r_pods():
    return [r_ca.PodSpec(name="ciso", trace=r_grid_trace(RGrid.CISO),
                         chips=64, embodied_g=64 * 0.9e6),
            r_ca.PodSpec(name="rural", trace=r_grid_trace(RGrid.RURAL),
                         chips=64, embodied_g=64 * 0.9e6)]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_ledger_equals_reference(case):
    kw, n_pods, sph, total, start = case
    mine = CarbonAwareTrainer(pods=_pods()[:n_pods],
                              schedule=CarbonSchedule(**kw),
                              steps_per_hour_full=sph)
    ref = r_ca.CarbonAwareTrainer(pods=_r_pods()[:n_pods],
                                  schedule=r_ca.CarbonSchedule(**kw),
                                  steps_per_hour_full=sph)
    got = mine.run(total_steps=total, start_hour=start)
    want = ref.run(total_steps=total, start_hour=start)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert mine.total_carbon(got) == ref.total_carbon(want)
    assert mine.baseline_carbon(total, start) == ref.baseline_carbon(total,
                                                                     start)


def test_carbon_aware_beats_always_on():
    tr = CarbonAwareTrainer(pods=_pods(), steps_per_hour_full=500)
    ledger = tr.run(total_steps=5000, start_hour=0)
    assert sum(r.steps for r in ledger) == 5000
    aware = tr.total_carbon(ledger)
    base, _ = tr.baseline_carbon(5000)
    assert 1 - aware / base > 0.10


def test_pauses_on_dirty_hours():
    tr = CarbonAwareTrainer(pods=_pods()[:1], schedule=CarbonSchedule(
        pause_threshold=100.0, elastic=False), steps_per_hour_full=500)
    ledger = tr.run(total_steps=2000, start_hour=20)
    assert "pause" in [r.action for r in ledger]
    assert sum(r.steps for r in ledger) == 2000


def test_migrates_to_cleaner_pod():
    tr = CarbonAwareTrainer(pods=_pods(), schedule=CarbonSchedule(
        migrate_min_ci_gap=10.0), steps_per_hour_full=1000)
    ledger = tr.run(total_steps=8000, start_hour=18)
    assert "rural" in {r.pod for r in ledger if r.action != "pause"}


def test_deadline_forces_progress():
    tr = CarbonAwareTrainer(pods=_pods()[:1], schedule=CarbonSchedule(
        pause_threshold=50.0, deadline_h=12, min_dp_frac=0.25),
        steps_per_hour_full=1000)
    ledger = tr.run(total_steps=6000, start_hour=0)
    assert sum(r.steps for r in ledger) == 6000
    assert len(ledger) <= 14


def test_elastic_width_tracks_ci():
    tr = CarbonAwareTrainer(pods=_pods()[:1], steps_per_hour_full=500)
    rows = [r for r in tr.run(total_steps=4000, start_hour=0)
            if r.action != "pause"]
    clean = [r.dp_frac for r in rows if r.ci < 150]
    dirty = [r.dp_frac for r in rows if r.ci > 350]
    if clean and dirty:
        assert np.mean(clean) > np.mean(dirty)


def test_step_hook_drives_real_training():
    seen = []

    def hook(pod_idx, n_steps, dp_frac):
        seen.append((pod_idx, n_steps, dp_frac))
        return n_steps

    tr = CarbonAwareTrainer(pods=_pods(), steps_per_hour_full=100)
    ledger = tr.run(total_steps=500, step_hook=hook)
    assert sum(n for _, n, _ in seen) == 500
    assert len(seen) == len([r for r in ledger if r.action != "pause"])


def test_module_is_a_copy_of_the_reference():
    """The port's module is the reference's text with the imports of the
    carbon core pointed at ``repro_torch.core``."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"
    ref = (root / "repro/train/carbon_aware.py").read_text()
    mine = (root / "repro_torch/train/carbon_aware.py").read_text()
    assert mine == ref.replace("repro.core", "repro_torch.core")
