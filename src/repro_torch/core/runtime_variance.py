"""Runtime variance models (paper §3.2 "Runtime variance", §4.3, §5.3).

Port of the reference ``core/runtime_variance.py``. Two families of
stochastic disturbance, each a multiplicative slowdown consumed by
``Environment``: co-located workload interference (computation, per tier)
and network instability (weak wireless signal at the edge, congestion in
the core). The deterministic presets reproduce the paper's figures; the
stochastic model powers the RL scheduler's environment. The reference's
``sample`` draws with ``jax.random``; here the draws are arguments.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.device import resolve_device


class VarianceScenario(enum.IntEnum):
    NONE = 0
    COLOCATED = 1  # co-located workloads on every compute tier
    UNSTABLE_EDGE = 2  # weak wireless signal
    UNSTABLE_CORE = 3  # congested core network


#: Deterministic per-scenario multipliers, calibrated to the paper's Fig 10
#: jointly with paper_fleet(): under co-location the optimum shifts Edge DC
#: -> DC; under network instability it shifts -> Mobile.
_INTERFERENCE = {
    VarianceScenario.NONE: (1.0, 1.0, 1.0),
    VarianceScenario.COLOCATED: (4.126, 2.820, 1.188),
    VarianceScenario.UNSTABLE_EDGE: (1.0, 1.0, 1.0),
    VarianceScenario.UNSTABLE_CORE: (1.0, 1.0, 1.0),
}
_NET_SLOWDOWN = {
    VarianceScenario.NONE: (1.0, 1.0),
    VarianceScenario.COLOCATED: (1.0, 1.0),
    VarianceScenario.UNSTABLE_EDGE: (8.0, 1.0),
    VarianceScenario.UNSTABLE_CORE: (1.0, 6.0),
}


def scenario_multipliers(s: VarianceScenario | int, *,
                         device: str | torch.device = "cuda"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(3,) interference and (2,) network slowdown of one preset."""
    dev = resolve_device(device)
    s = VarianceScenario(int(s))
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return f(_INTERFERENCE[s]), f(_NET_SLOWDOWN[s])


def all_scenario_multipliers(*, device: str | torch.device = "cuda"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked (n_scenarios, 3) interference and (n_scenarios, 2)
    slowdowns."""
    pairs = [scenario_multipliers(s, device=device) for s in VarianceScenario]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


@dataclasses.dataclass(frozen=True)
class StochasticVariance:
    """Parameters of the random-disturbance model (lognormal slowdowns).

    ``sigma_comp`` per-tier lognormal sigma of the interference multiplier;
    ``p_weak``     probability a request sees weak wireless signal;
    ``weak_scale`` edge slowdown under weak signal;
    ``sigma_core`` lognormal sigma of core-network queueing delay.
    """

    sigma_comp: torch.Tensor  # (3,)
    p_weak: torch.Tensor  # ()
    weak_scale: torch.Tensor  # ()
    sigma_core: torch.Tensor  # ()

    @staticmethod
    def default(*, device: str | torch.device = "cuda"
                ) -> "StochasticVariance":
        dev = resolve_device(device)
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        return StochasticVariance(sigma_comp=f([0.35, 0.20, 0.06]),
                                  p_weak=f(0.43), weak_scale=f(3.2),
                                  sigma_core=f(0.25))


def sample(sv: StochasticVariance, z_comp: torch.Tensor, weak: torch.Tensor,
           z_core: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One draw of (interference (3,), net_slowdown (2,)), each >= 1, from
    explicit draws: ``z_comp`` (3,) and ``z_core`` () standard normals,
    ``weak`` () a Bernoulli(``sv.p_weak``) outcome (the reference's
    ``sample`` draws the same three with ``jax.random``)."""
    dev = sv.sigma_comp.device
    f = lambda x: torch.as_tensor(x, device=dev)
    interf = torch.exp(torch.abs(f(z_comp).float()) * sv.sigma_comp)
    edge = torch.where(f(weak).bool(), sv.weak_scale,
                       torch.ones_like(sv.weak_scale))
    core = torch.exp(torch.abs(f(z_core).float()) * sv.sigma_core)
    return interf, torch.stack([edge, core])
