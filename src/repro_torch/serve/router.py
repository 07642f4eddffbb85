"""GreenScaleRouter — carbon-aware execution-target selection (paper Table 1
applied to LM serving) in one environment.

Port of ``Request``, ``RouteDecision``, ``RequestBatch``,
``request_workload`` and ``GreenScaleRouter`` from the reference
``serve/router.py``. Each request becomes a workload descriptor (FLOPs from
its prefill+decode token counts and the model's active params, payload
bytes from the token counts) and the Table-1 model picks the carbon-optimal
feasible tier among {on-device, edge DC, hyperscale DC} under the current
carbon intensities. Only the default Table-1 oracle decides here: the
pluggable policies arrive with ``serve/policy.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import carbon_model
from repro_torch.core.carbon_model import Environment, RouteOutputs
from repro_torch.core.infrastructure import Fleet, pack_infra, tpu_fleet
from repro_torch.core.workloads import Workload, batch_workloads
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request."""

    prompt_tokens: int
    max_new_tokens: int
    latency_budget_s: float = 2.0
    bytes_per_token: float = 4.0
    #: which tiers can hold this model at all (e.g. 72B never fits on-device)
    available: tuple[bool, bool, bool] = (True, True, True)
    #: deferral allowance in hours (consumed only by temporal policies)
    slack_hours: float = 0.0


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    target: int  # Target enum value
    carbon_g: float
    latency_s: float
    feasible: bool
    per_target_carbon: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """Columnar request batch: (N,) float64 columns + (N, 3) availability."""

    prompt_tokens: np.ndarray
    max_new_tokens: np.ndarray
    latency_budget_s: np.ndarray
    bytes_per_token: np.ndarray
    available: np.ndarray  # (N, 3) bool
    slack_hours: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.prompt_tokens)

    @classmethod
    def from_requests(cls, reqs: list[Request]) -> "RequestBatch":
        n = len(reqs)
        col = lambda attr: np.fromiter(
            (getattr(r, attr) for r in reqs), np.float64, n)
        return cls(
            prompt_tokens=col("prompt_tokens"),
            max_new_tokens=col("max_new_tokens"),
            latency_budget_s=col("latency_budget_s"),
            bytes_per_token=col("bytes_per_token"),
            available=np.array([r.available for r in reqs],
                               bool).reshape(n, 3),
            slack_hours=col("slack_hours"),
        )

    def workload(self, cfg: ModelConfig, *,
                 device: str | torch.device = "cuda") -> Workload:
        """Stacked descriptors, products taken in float64 on the host."""
        n_active = cfg.active_param_count()
        total_tokens = self.prompt_tokens + self.max_new_tokens
        return batch_workloads(
            flops=2.0 * n_active * total_tokens,
            mem_bytes=2.0 * n_active * np.maximum(self.max_new_tokens, 1),
            data_in=self.bytes_per_token * self.prompt_tokens,
            data_out=self.bytes_per_token * self.max_new_tokens,
            latency_req=self.latency_budget_s,
            device=device,
        )

    def avail(self, *, device: str | torch.device = "cuda") -> torch.Tensor:
        return torch.as_tensor(self.available, device=resolve_device(device))


def request_workload(cfg: ModelConfig, req: Request, *,
                     device: str | torch.device = "cuda") -> Workload:
    """Descriptor for one LM request: 2·N_active FLOPs per token over the
    prefill + decode tokens; decode re-reads the active params every
    generated token."""
    n_active = cfg.active_param_count()
    total_tokens = req.prompt_tokens + req.max_new_tokens
    return Workload.make(
        flops=2.0 * n_active * total_tokens,
        mem_bytes=2.0 * n_active * max(req.max_new_tokens, 1),
        data_in=req.bytes_per_token * req.prompt_tokens,
        data_out=req.bytes_per_token * req.max_new_tokens,
        latency_req=req.latency_budget_s,
        device=device,
    )


def _decisions_from_outputs(out: RouteOutputs) -> list[RouteDecision]:
    """Unpack batched RouteOutputs into per-request RouteDecision objects."""
    target = out.target.cpu().numpy()
    cf = out.total_cf.cpu().numpy()
    lat = out.latency.cpu().numpy()
    ok = out.ok.cpu().numpy()
    idx = np.arange(len(target))
    carbon = cf[idx, target]
    latency = lat[idx, target]
    feas = ok[idx, target]
    return [
        RouteDecision(target=int(t), carbon_g=float(c), latency_s=float(l),
                      feasible=bool(f), per_target_carbon=tuple(map(float, row)))
        for t, c, l, f, row in zip(target, carbon, latency, feas, cf)
    ]


@dataclasses.dataclass
class GreenScaleRouter:
    """Carbon-aware tier selection for a serving fleet (one environment),
    deciding with the Table-1 carbon oracle."""

    cfg: ModelConfig
    fleet: Fleet = dataclasses.field(default_factory=tpu_fleet)
    embodied_model: str = "act"
    policy: object | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.policy is not None:
            raise NotImplementedError(
                "routing policies are not ported yet; use policy=None "
                "(the Table-1 carbon oracle)")
        self.device = resolve_device(self.device)
        self._infra = pack_infra(self.fleet, self.embodied_model,
                                 device=self.device)

    @property
    def infra(self):
        """Packed ``InfraParams`` of this router's fleet."""
        return self._infra

    def route(self, req: Request, env: Environment) -> RouteDecision:
        w = request_workload(self.cfg, req, device=self.device)
        avail = torch.as_tensor(req.available, device=self.device)
        out = carbon_model.route_one(w, self._infra, env, avail)
        t = int(out.target)
        cf = out.total_cf.cpu().numpy()
        return RouteDecision(
            target=t,
            carbon_g=float(cf[t]),
            latency_s=float(out.latency[t]),
            feasible=bool(out.ok[t]),
            per_target_carbon=tuple(float(x) for x in cf),
        )

    def route_batch(self, reqs: list[Request], env: Environment
                    ) -> list[RouteDecision]:
        """All requests in one batched evaluation (no per-request loop)."""
        if not reqs:
            return []
        out = self.route_batch_arrays(RequestBatch.from_requests(reqs), env)
        return _decisions_from_outputs(out)

    def route_batch_arrays(self, batch: RequestBatch, env: Environment
                           ) -> RouteOutputs:
        """Array-in/array-out batched routing."""
        w = batch.workload(self.cfg, device=self.device)
        return carbon_model.route_many(w, self._infra, env,
                                       batch.avail(device=self.device))
