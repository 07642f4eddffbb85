"""Quickstart: the GreenScale carbon design space on the port,
``python -m repro_torch.launch.quickstart [--device cuda]``.

The counterpart of the reference's ``examples/quickstart.py``, printing
the same lines: the paper's Table-1 carbon model for a ResNet-50
inference request across the edge-cloud spectrum, then a slice of the
design space (every AI workload x 24 hours) and the carbon-optimal
execution target per scenario. ``main`` returns a ``QuickstartResult``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import (
    ChargingBehavior,
    Environment,
    Grid,
    build_scenarios,
    carbon_model,
    explore,
    grid_trace,
    mobile_carbon_intensity,
    pack_infra,
    paper_fleet,
)
from repro_torch.core.design_space import ScenarioAxes, scenario_mask
from repro_torch.core.workloads import AI_WORKLOADS, Workload, by_name
from repro_torch.device import resolve_device

TARGETS = ("Mobile", "Edge DC", "Hyperscale DC")


@dataclasses.dataclass
class QuickstartResult:
    """ResNet-50's per-target carbon and latency (s, g), its carbon-optimal
    target, and the design-space slice's carbon-optimal picks by hour."""

    total_cf: np.ndarray  # (3,)
    latency: np.ndarray  # (3,)
    op_total: np.ndarray  # (3,)
    emb_total: np.ndarray  # (3,)
    optimal: int
    n_points: int
    picks: dict  # {workload name: {target name: hours}}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> QuickstartResult:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    fleet = paper_fleet()
    infra = pack_infra(fleet, "act", device=dev)

    # --- one workload, one environment ---------------------------------------
    ciso = grid_trace(Grid.CISO, device=dev)
    urban = grid_trace(Grid.URBAN, device=dev)
    env = Environment.make(
        ci_mobile=mobile_carbon_intensity(ChargingBehavior.NIGHTTIME, ciso),
        ci_edge=float(urban.ci_mean),
        ci_core=280.0,
        ci_hyper=float(ciso.ci_mean),
        device=dev,
    )
    wl = by_name("resnet50").workload  # held on the CPU
    w = Workload(*[getattr(wl, f.name).to(dev)
                   for f in dataclasses.fields(Workload)])
    b = carbon_model.evaluate(w, infra, env)
    print("ResNet-50, nighttime charger / urban edge / grid-mix DC:")
    for t in range(3):
        print(f"  {TARGETS[t]:14s} carbon={float(b.total_cf[t]) * 1e3:7.3f} mg"
              f"  latency={float(b.latency[t]) * 1e3:6.1f} ms"
              f"  (op {float(b.op_total[t]) * 1e3:6.3f} /"
              f" emb {float(b.emb_total[t]) * 1e3:6.3f})")
    opt = int(carbon_model.optimal_target(b, w))
    print(f"  -> carbon-optimal: {TARGETS[opt]}\n")

    # --- a design-space slice: all AI workloads x 24 hours --------------------
    axes = ScenarioAxes(charging=(ChargingBehavior.NIGHTTIME,),
                        mobile_grid=(Grid.CISO,),
                        edge_location=(Grid.URBAN,),
                        dc_carbon_free=(False,),
                        embodied=("act",))
    table = build_scenarios(fleet, axes, device=dev)
    res = explore(AI_WORKLOADS, table)
    print(f"explored {res.n_points} design-space cells "
          f"({len(res.workload_names)} workloads x {len(table.rows)} "
          f"scenarios x 3 targets)")
    mask = scenario_mask(table.rows, variance="NONE")
    picks = {}
    for i, name in enumerate(res.workload_names):
        chosen = res.carbon_opt[i][mask]
        hist = {TARGETS[t]: int((chosen == t).sum()) for t in range(3)}
        picks[name] = hist
        print(f"  {name:14s} carbon-optimal by hour: {hist}")
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    return QuickstartResult(
        total_cf=host(b.total_cf), latency=host(b.latency),
        op_total=host(b.op_total), emb_total=host(b.emb_total),
        optimal=opt, n_points=res.n_points, picks=picks)


if __name__ == "__main__":
    main()
