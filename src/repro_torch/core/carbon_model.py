"""GreenScale carbon emission model — paper Table 1 on torch tensors.

Port of ``Environment``, ``CFBreakdown``, ``evaluate``, the QoS checks,
``pick_target``, ``evaluate_energy``, ``RouteOutputs``, ``route_one`` and
``route_many`` from the reference ``core/carbon_model.py``.

Every function broadcasts over leading batch dimensions of the workload
(and of ``env.ci``), which takes the place of the reference's ``jax.vmap``:
``route_many`` is ``route_one`` on a workload with a leading (N,) axis. The
arithmetic follows the reference term by term and in the same order, in
float32.

Unit discipline: time s, power W, energy J, carbon g, CI g/kWh.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.constants import J_PER_KWH, Component, Target
from repro_torch.core.infrastructure import InfraParams
from repro_torch.core.workloads import Workload
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Environment:
    """Scenario-dependent state: carbon intensities + runtime variance.

    ``ci``            (..., 5) gCO2/kWh per Component (edge network and
                      edge DC share CI_E).
    ``interference``  (3,) computation-slowdown multiplier per compute tier.
    ``net_slowdown``  (2,) communication-slowdown multiplier per network.
    """

    ci: torch.Tensor
    interference: torch.Tensor
    net_slowdown: torch.Tensor

    @staticmethod
    def make(ci_mobile, ci_edge, ci_core, ci_hyper,
             interference=(1.0, 1.0, 1.0), net_slowdown=(1.0, 1.0), *,
             device: str | torch.device = "cuda") -> "Environment":
        dev = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        ci = torch.stack([f(ci_mobile), f(ci_edge), f(ci_edge), f(ci_core),
                          f(ci_hyper)])
        return Environment(ci=ci, interference=f(interference),
                           net_slowdown=f(net_slowdown))


@dataclasses.dataclass(frozen=True)
class CFBreakdown:
    """Model output: per-(target, component) carbon + per-target latency."""

    op_cf: torch.Tensor  # (..., 3, 5) grams CO2e, operational
    emb_cf: torch.Tensor  # (..., 3, 5) grams CO2e, embodied (amortized)
    latency: torch.Tensor  # (..., 3) seconds end-to-end
    t_comp: torch.Tensor  # (..., 3) computation time on each tier
    t_comm: torch.Tensor  # (..., 2) [edge, core] network times

    @property
    def total_cf(self) -> torch.Tensor:  # (..., 3)
        return self.op_cf.sum(-1) + self.emb_cf.sum(-1)

    @property
    def op_total(self) -> torch.Tensor:  # (..., 3)
        return self.op_cf.sum(-1)

    @property
    def emb_total(self) -> torch.Tensor:  # (..., 3)
        return self.emb_cf.sum(-1)


def _cf(energy_j: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Operational CF in grams from energy (J) and carbon intensity (g/kWh)."""
    return energy_j / J_PER_KWH * ci


def compute_times(w: Workload, infra: InfraParams,
                  env: Environment) -> torch.Tensor:
    """T_comp per tier (..., 3): roofline max of compute- and memory-bound
    times; tier 0 honours the workload's client-device efficiency."""
    eff0 = infra.eff_flops[0] * w.mobile_eff_scale
    eff = torch.cat([eff0[..., None],
                     infra.eff_flops[1:].expand(eff0.shape + (2,))], dim=-1)
    t = torch.maximum(w.flops[..., None] / eff,
                      w.mem_bytes[..., None] / infra.eff_mem_bw)
    return t * env.interference


def comm_times(w: Workload, infra: InfraParams,
               env: Environment) -> torch.Tensor:
    """[T_comm_E, T_comm_R] (..., 2): transfer + base latency, degraded."""
    payload = w.data_in + w.data_out
    t = payload[..., None] / infra.net_bw + infra.net_lat
    return t * env.net_slowdown


def evaluate(w: Workload, infra: InfraParams, env: Environment) -> CFBreakdown:
    """Table 1, all three execution targets at once."""
    t_comp = compute_times(w, infra, env)
    t_comm = comm_times(w, infra, env)

    t_m = t_comp[..., Target.MOBILE]
    t_e = t_comp[..., Target.EDGE_DC]
    t_h = t_comp[..., Target.HYPERSCALE_DC]
    t_ce = t_comm[..., 0]  # edge network
    t_cr = t_comm[..., 1]  # core network

    # Streaming workloads keep the radio, base station and core path active
    # for the full frame interval: energy uses max(transfer, frame) time,
    # latency/feasibility the raw transfer times.
    frame = torch.where(w.fps_req > 0,
                        1.0 / torch.clamp_min(w.fps_req, 1e-6), 0.0)
    is_stream = w.continuous > 0
    t_ce_e = torch.where(is_stream, torch.maximum(t_ce, frame), t_ce)
    t_cr_e = torch.where(is_stream, torch.maximum(t_cr, frame), t_cr)

    ci = env.ci
    ci_m = ci[..., Component.MOBILE]
    ci_en = ci[..., Component.EDGE_NETWORK]
    ci_ed = ci[..., Component.EDGE_DC]
    ci_cn = ci[..., Component.CORE_NETWORK]
    ci_hd = ci[..., Component.HYPERSCALE_DC]
    p_comp, p_idle, ecf, life = (infra.p_comp, infra.p_idle, infra.ecf_g,
                                 infra.lifetime_s)
    n_e, n_dc, n_b = infra.n_user_edge, infra.n_user_dc, infra.n_batch_dc
    zero = torch.zeros_like(t_m)

    # rows: targets [MOBILE, EDGE_DC, HYPERSCALE_DC]; columns: components
    # [MOBILE, EDGE_NETWORK, EDGE_DC, CORE_NETWORK, HYPERSCALE_DC]
    op = [
        [_cf(t_m * p_comp[0], ci_m),
         zero,
         _cf(t_m * p_idle[1] / n_e, ci_ed),
         zero,
         _cf(t_m * p_idle[2] / n_dc, ci_hd)],
        [_cf(t_ce_e * infra.p_comm_mobile + t_e * p_idle[0], ci_m),
         _cf(t_ce_e * infra.net_p[0] / infra.net_n_user[0], ci_en),
         _cf(t_e * p_comp[1] / n_e, ci_ed),
         zero,
         _cf((t_ce + t_e) * p_idle[2] / n_dc, ci_hd)],
        [_cf(t_ce_e * infra.p_comm_mobile + (t_cr + t_h) * p_idle[0], ci_m),
         _cf(t_ce_e * infra.net_p[0] / infra.net_n_user[0], ci_en),
         _cf((t_ce + t_cr + t_h) * p_idle[1] / n_e, ci_ed),
         _cf(t_cr_e * infra.net_p[1] / infra.net_n_user[1], ci_cn),
         _cf(t_h * p_comp[2] / n_b, ci_hd)],
    ]
    emb = [
        [ecf[0] * t_m / life[0],
         zero,
         ecf[1] / n_e * t_m / life[1],
         zero,
         ecf[2] / n_dc * t_m / life[2]],
        [ecf[0] * (t_ce + t_e) / life[0],
         infra.net_ecf_g[0] / infra.net_n_user[0] * t_ce
         / infra.net_lifetime_s[0],
         ecf[1] / n_e * t_e / life[1],
         zero,
         ecf[2] / n_dc * (t_ce + t_e) / life[2]],
        [ecf[0] * (t_ce + t_cr + t_h) / life[0],
         infra.net_ecf_g[0] / infra.net_n_user[0] * t_ce
         / infra.net_lifetime_s[0],
         ecf[1] / n_e * (t_ce + t_cr + t_h) / life[1],
         infra.net_ecf_g[1] / infra.net_n_user[1] * t_cr
         / infra.net_lifetime_s[1],
         ecf[2] / n_b * t_h / life[2]],
    ]

    def table(rows):
        flat = torch.broadcast_tensors(*[c for row in rows for c in row])
        cells = torch.stack(flat, dim=-1)
        return cells.reshape(cells.shape[:-1] + (3, 5))

    latency = torch.stack([t_m, t_ce + t_e, t_ce + t_cr + t_h], dim=-1)
    return CFBreakdown(op_cf=table(op), emb_cf=table(emb), latency=latency,
                       t_comp=t_comp, t_comm=t_comm)


def stream_feasible(t_comm: torch.Tensor, w: Workload) -> torch.Tensor:
    """(..., 3) bool — per-frame transfer fits the frame interval on every
    network hop the target uses; True for non-streaming workloads."""
    frame_time = torch.where(w.fps_req > 0,
                             1.0 / torch.clamp_min(w.fps_req, 1e-6),
                             float("inf"))
    edge_ok = t_comm[..., 0] <= frame_time
    stream_ok = torch.stack([torch.ones_like(edge_ok), edge_ok,
                             edge_ok & (t_comm[..., 1] <= frame_time)], dim=-1)
    return torch.where((w.continuous > 0)[..., None], stream_ok, True)


def qos_feasible(latency: torch.Tensor, t_comm: torch.Tensor, w: Workload,
                 extra_latency: torch.Tensor | float = 0.0) -> torch.Tensor:
    """(..., 3) bool QoS check; ``extra_latency`` adds a WAN hop."""
    ok = latency + extra_latency <= w.latency_req[..., None]
    return ok & stream_feasible(t_comm, w)


def feasible(b: CFBreakdown, w: Workload) -> torch.Tensor:
    """(..., 3) bool — does each target satisfy the QoS latency constraint?"""
    return qos_feasible(b.latency, b.t_comm, w)


def pick_target(score: torch.Tensor, ok: torch.Tensor, fallback: torch.Tensor,
                avail: torch.Tensor | None = None) -> torch.Tensor:
    """argmin(score) over feasible+available targets (last axis).

    With no feasible available target, falls back to argmin(fallback) over
    the available ones. An all-False ``avail`` resolves to MOBILE (index 0):
    every masked score is +inf and ``torch.argmin``, like ``jnp.argmin``,
    returns the first index of a constant row.
    """
    if avail is None:
        avail = torch.ones_like(ok)
    ok = ok & avail
    best = torch.argmin(torch.where(ok, score, float("inf")), dim=-1)
    fall = torch.argmin(torch.where(avail, fallback, float("inf")), dim=-1)
    return torch.where(ok.any(dim=-1), best, fall)


def evaluate_energy(w: Workload, infra: InfraParams,
                    env: Environment) -> torch.Tensor:
    """(..., 3) operational energy (J) per target: ``evaluate`` with CI := 1
    for every component, times J_PER_KWH to undo the unit conversion."""
    unit_env = Environment(ci=torch.ones_like(env.ci),
                           interference=env.interference,
                           net_slowdown=env.net_slowdown)
    return evaluate(w, infra, unit_env).op_cf.sum(-1) * J_PER_KWH


@dataclasses.dataclass(frozen=True)
class RouteOutputs:
    """Routing result (leading batch dimensions as the inputs had them).

    ``target`` is the carbon-optimal feasible pick; ``target_latency`` /
    ``target_energy`` the latency- and energy-optimal baseline picks.
    """

    target: torch.Tensor  # (...) int64
    target_latency: torch.Tensor  # (...) int64
    target_energy: torch.Tensor  # (...) int64
    total_cf: torch.Tensor  # (..., 3) gCO2 per execution target
    latency: torch.Tensor  # (..., 3) s per execution target
    ok: torch.Tensor  # (..., 3) bool, feasible & available


def route_one(w: Workload, infra: InfraParams, env: Environment,
              avail: torch.Tensor) -> RouteOutputs:
    """Routing core for one request, or for a batch along leading axes."""
    b = evaluate(w, infra, env)
    ok = feasible(b, w) & avail
    energy = evaluate_energy(w, infra, env)
    total_cf = b.total_cf
    return RouteOutputs(
        target=pick_target(total_cf, ok, total_cf, avail),
        target_latency=pick_target(b.latency, ok, total_cf, avail),
        target_energy=pick_target(energy, ok, total_cf, avail),
        total_cf=total_cf,
        latency=b.latency,
        ok=ok,
    )


def route_many(w: Workload, infra: InfraParams, env: Environment,
               avail: torch.Tensor) -> RouteOutputs:
    """(N,)-batched requests against ONE environment: ``w`` leaves (N,),
    ``avail`` (N, 3), ``env.ci`` (5,)."""
    if w.flops.dim() != 1 or avail.shape != w.flops.shape + (3,):
        raise ValueError(f"route_many wants (N,) workloads and (N, 3) avail, "
                         f"got {tuple(w.flops.shape)} and {tuple(avail.shape)}")
    return route_one(w, infra, env, avail)
