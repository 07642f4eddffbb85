"""GreenScale applied to the ten LM architectures, on the port:
``python -m repro_torch.launch.lm_design_space [--device cuda]``.

The counterpart of the reference's ``benchmarks/lm_design_space.py``,
printing the same CSV rows (``name,us_per_call,derived``):

  * ``lm_routing`` — per-arch serving-tier decisions across a day of grid
    hours (``GreenScaleRouter`` on the TPU fleet): the carbon-optimal tier
    shifting with CI, per architecture size class; ``us_per_call`` is the
    mean wall time of one ``route`` call after a warm one.
  * ``lm_carbon_training`` — the ``CarbonAwareTrainer`` ledger of three
    ``CarbonSchedule``s against an always-on run: the paper's temporal,
    spatial and elastic levers on a training fleet.

``main`` returns the rows and each row's numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import (
    ChargingBehavior,
    Grid,
    grid_trace,
    mobile_carbon_intensity,
)
from repro_torch.core.carbon_model import Environment
from repro_torch.device import resolve_device
from repro_torch.serve.router import GreenScaleRouter, Request
from repro_torch.train.carbon_aware import (
    CarbonAwareTrainer,
    CarbonSchedule,
    PodSpec,
)

TARGET_NAMES = ("Mobile", "EdgeDC", "DC")
TIMING_REPS = 20


@dataclasses.dataclass
class BenchRow:
    name: str
    us_per_call: float
    derived: str
    values: dict = dataclasses.field(default_factory=dict)

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.2f},{self.derived}"


def _time_us(fn, dev: torch.device, reps: int = TIMING_REPS) -> float:
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e6


def lm_routing(dev: torch.device) -> list[BenchRow]:
    ciso = grid_trace(Grid.CISO, device=dev)
    rural = grid_trace(Grid.RURAL, device=dev)
    ci_mobile = float(mobile_carbon_intensity(ChargingBehavior.AVERAGE, ciso))
    ciso_mean = float(ciso.ci_mean)
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        router = GreenScaleRouter(cfg, device=dev)
        # on-device only plausible under ~8B params
        fits_device = cfg.active_param_count() < 9e9
        req = Request(prompt_tokens=512, max_new_tokens=128,
                      latency_budget_s=5.0,
                      available=(fits_device, True, True))
        picks, t = [], None
        for hour in range(0, 24, 2):
            env = Environment.make(
                ci_mobile, float(rural.ci_hourly[hour]), ciso_mean,
                float(ciso.ci_hourly[hour]), device=dev)
            picks.append(router.route(req, env).target)
            if t is None:
                t = _time_us(lambda: router.route(req, env), dev)
        hist = {TARGET_NAMES[i]: picks.count(i) for i in range(3)}
        rows.append(BenchRow(
            f"lm_routing/{arch}", t,
            f"tier_picks_over_day={hist};"
            f"active_params={cfg.active_param_count() / 1e9:.1f}B",
            values={"picks": picks, "hist": hist}))
    return rows


SCHEDULES = (("greedy", CarbonSchedule()),
             ("deadline72h", CarbonSchedule(deadline_h=72)),
             ("no-elastic", CarbonSchedule(elastic=False)))


def lm_carbon_training(dev: torch.device) -> list[BenchRow]:
    pods = [
        PodSpec(name="ciso-pod", trace=grid_trace(Grid.CISO, device=dev),
                chips=256, embodied_g=256 * 0.9e6),
        PodSpec(name="rural-pod", trace=grid_trace(Grid.RURAL, device=dev),
                chips=256, embodied_g=256 * 0.9e6),
    ]
    rows = []
    for label, sched in SCHEDULES:
        tr = CarbonAwareTrainer(pods=pods, schedule=sched,
                                steps_per_hour_full=2000)
        ledger = tr.run(total_steps=100_000, start_hour=0)
        aware = tr.total_carbon(ledger)
        base, base_h = tr.baseline_carbon(100_000)
        hours = len(ledger)
        migrations = sum(1 for r in ledger if r.action == "migrate+train")
        pauses = sum(1 for r in ledger if r.action == "pause")
        rows.append(BenchRow(
            f"lm_carbon_training/{label}", 0.0,
            f"saving={(1 - aware / base) * 100:.1f}%;hours={hours}"
            f"(baseline {base_h});migrations={migrations};pauses={pauses};"
            f"carbon={aware / 1e3:.1f}kg_vs_{base / 1e3:.1f}kg",
            values={"aware_g": aware, "base_g": base, "hours": hours,
                    "base_hours": base_h, "migrations": migrations,
                    "pauses": pauses, "ledger": ledger}))
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[BenchRow]:
    dev = resolve_device(parse_args(argv).device)
    rows = lm_routing(dev) + lm_carbon_training(dev)
    for r in rows:
        print(r.csv())
    return rows


if __name__ == "__main__":
    main()
