"""CarbonAwareTrainer — GreenScale's scheduling as a first-class training
feature (the paper's Table-1/§5 decision process driving a training fleet).

Three levers, all consuming the carbon core (repro_torch.core):

  * **Temporal shifting** — pause (atomic checkpoint) when every region's
    carbon intensity exceeds ``pause_threshold``; resume when it drops. The
    deadline mechanism is the same checkpoint/restart substrate as fault
    tolerance.
  * **Spatial shifting** — each scheduling window, run on the region whose
    grid has the lowest CI, *if* the projected migration cost (checkpoint
    transfer bytes over the inter-DC path) is amortized by the CI gap —
    the paper's geographical trade-off (§3.2) applied to pods.
  * **Elastic scaling** — DP width scales with renewable availability:
    more chips when energy is green, fewer when it is dirty, subject to a
    deadline constraint (must finish ``total_steps`` within ``deadline_h``).

The trainer emits a per-hour carbon ledger (operational + amortized embodied
gCO2, per the paper's Table-1 accounting for the Hyperscale-DC target) and
the savings vs. an always-on single-region baseline — reproduced as a
benchmark (benchmarks/lm_carbon_training.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.carbon_intensity import GridTrace
from repro_torch.core.embodied import amortized_g_per_hour
from repro_torch.core.constants import (
    J_PER_KWH,
    SECONDS_PER_YEAR,
    TPU_V5E_IDLE_W,
    TPU_V5E_TDP_W,
)


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """One schedulable pod (region + hardware)."""

    name: str
    trace: GridTrace  # hourly CI of the powering grid
    chips: int = 256
    chip_power_w: float = TPU_V5E_TDP_W
    chip_idle_w: float = TPU_V5E_IDLE_W
    pue: float = 1.1
    embodied_g: float = 256 * 0.9e6  # pod embodied CF (ACT-style estimate)
    lifetime_s: float = 4 * SECONDS_PER_YEAR


@dataclasses.dataclass(frozen=True)
class CarbonSchedule:
    pause_threshold: float = 450.0  # gCO2/kWh above which we pause
    migrate_min_ci_gap: float = 40.0  # min CI advantage to justify migration
    migration_cost_gb: float = 150.0  # checkpoint transfer size
    migration_energy_j_per_gb: float = 2.0e3  # network+storage energy
    elastic: bool = True
    min_dp_frac: float = 0.25  # lowest elastic width (fraction of chips)
    deadline_h: int = 0  # 0 = no deadline (pure carbon-greedy)


@dataclasses.dataclass
class LedgerRow:
    hour: int
    pod: str
    action: str  # "train" | "pause" | "migrate+train"
    dp_frac: float
    steps: int
    op_g: float
    emb_g: float
    ci: float


@dataclasses.dataclass
class CarbonAwareTrainer:
    """Hour-granularity control plane over (train_step, checkpoint).

    ``step_hook(pod_idx, n_steps, dp_frac)`` performs the actual training
    (real steps on TPU; smoke steps or nothing in simulation) and returns
    the number of steps completed. The trainer owns the *decisions* and the
    *ledger* — the separation keeps the policy testable without hardware.
    """

    pods: Sequence[PodSpec]
    schedule: CarbonSchedule = dataclasses.field(default_factory=CarbonSchedule)
    steps_per_hour_full: int = 1000  # throughput at dp_frac=1

    def ci_at(self, pod: int, hour: int) -> float:
        return float(self.pods[pod].trace.ci_hourly[hour % 24])

    def _hour_carbon(self, pod: PodSpec, ci: float, active_frac: float,
                     hours: float = 1.0) -> tuple[float, float]:
        """(operational g, embodied g) for one hour at given activity."""
        active = pod.chips * active_frac
        idle = pod.chips * (1 - active_frac)
        watts = (active * pod.chip_power_w + idle * pod.chip_idle_w) * pod.pue
        op = watts * 3600.0 * hours / J_PER_KWH * ci
        emb = hours * amortized_g_per_hour(pod.embodied_g,
                                           pod.lifetime_s / 3600.0)
        return op, emb

    def plan_hour(self, hour: int, current_pod: int,
                  steps_left: int, hours_left: int) -> tuple[str, int, float]:
        """Decide (action, pod, dp_frac) for this hour."""
        s = self.schedule
        cis = [self.ci_at(i, hour) for i in range(len(self.pods))]
        best = int(np.argmin(cis))
        cur_ci = cis[current_pod]
        best_ci = cis[best]

        # deadline pressure: minimum average throughput needed
        must_run = False
        dp_needed = 0.0
        if s.deadline_h and hours_left > 0:
            dp_needed = steps_left / max(hours_left, 1) / self.steps_per_hour_full
            must_run = dp_needed > 0

        if min(cis) > s.pause_threshold and not (must_run and dp_needed > s.min_dp_frac):
            return "pause", current_pod, 0.0

        pod = current_pod
        action = "train"
        if best != current_pod and (cur_ci - best_ci) > s.migrate_min_ci_gap:
            pod = best
            action = "migrate+train"

        dp = 1.0
        if s.elastic:
            ci = cis[pod]
            # scale down on dirty energy, floor at min_dp_frac / deadline need
            span = max(s.pause_threshold - 50.0, 1.0)
            dp = float(np.clip(1.0 - (ci - 50.0) / span, s.min_dp_frac, 1.0))
            dp = max(dp, min(dp_needed, 1.0))
        return action, pod, dp

    def run(self, total_steps: int, start_hour: int = 0, *,
            step_hook: Callable[[int, int, float], int] | None = None,
            max_hours: int = 24 * 14) -> list[LedgerRow]:
        """Simulate (or drive) training until ``total_steps`` are done."""
        s = self.schedule
        ledger: list[LedgerRow] = []
        done = 0
        pod = 0
        hour = start_hour
        while done < total_steps and (hour - start_hour) < max_hours:
            hours_left = (s.deadline_h - (hour - start_hour)
                          if s.deadline_h else 10 ** 9)
            action, new_pod, dp = self.plan_hour(hour, pod,
                                                 total_steps - done,
                                                 hours_left)
            ci = self.ci_at(new_pod, hour)
            steps = 0
            op = emb = 0.0
            if action == "pause":
                op, emb = self._hour_carbon(self.pods[pod], self.ci_at(pod, hour),
                                            0.0)
            else:
                planned = int(self.steps_per_hour_full * dp)
                planned = min(planned, total_steps - done)
                if step_hook is not None:
                    steps = step_hook(new_pod, planned, dp)
                else:
                    steps = planned
                op, emb = self._hour_carbon(self.pods[new_pod], ci, dp)
                if action == "migrate+train":
                    mig_j = s.migration_cost_gb * s.migration_energy_j_per_gb
                    op += mig_j / J_PER_KWH * ci
                done += steps
            ledger.append(LedgerRow(hour=hour, pod=self.pods[new_pod].name,
                                    action=action, dp_frac=dp, steps=steps,
                                    op_g=op, emb_g=emb, ci=ci))
            pod = new_pod
            hour += 1
        return ledger

    @staticmethod
    def total_carbon(ledger: list[LedgerRow]) -> float:
        return sum(r.op_g + r.emb_g for r in ledger)

    def baseline_carbon(self, total_steps: int, start_hour: int = 0,
                        pod: int = 0) -> tuple[float, int]:
        """Always-on, single-region, full-width baseline (what a carbon-
        unaware trainer does). Returns (gCO2, hours)."""
        hours = int(np.ceil(total_steps / self.steps_per_hour_full))
        total = 0.0
        for h in range(start_hour, start_hour + hours):
            op, emb = self._hour_carbon(self.pods[pod], self.ci_at(pod, h), 1.0)
            total += op + emb
        return total, hours
