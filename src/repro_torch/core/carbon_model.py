"""GreenScale carbon emission model — paper Table 1 on torch tensors.

Port of ``Environment``, ``CFBreakdown``, ``evaluate``, the QoS checks,
``pick_target``, ``optimal_target``, ``evaluate_energy``, ``RouteOutputs``,
``route_one``, ``route_many``, ``route_many_envs``, the factorized evaluator
(``EnergyFactors``, ``energy_factors[_batch]``, ``total_cf_from_factors``,
``route_many_from_factors`` and its QoS checks), the forecast-risk helpers
and ``optimal_targets_all_metrics`` from the reference
``core/carbon_model.py``.

Every function broadcasts over leading batch dimensions of the workload
(and of ``env.ci``), which takes the place of the reference's ``jax.vmap``:
``route_many`` is ``route_one`` on a workload with a leading (N,) axis. The
arithmetic follows the reference term by term and in the same order, in
float32. The reference's 5-component sums and einsums are written as
explicit left-to-right elementwise sums (``_sum_last``), never a
reduction kernel or a matmul, so the card and the CPU add in one order and
their decisions agree to the bit.

Unit discipline: time s, power W, energy J, carbon g, CI g/kWh.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.constants import (
    J_PER_KWH,
    N_COMPONENTS,
    Component,
    Target,
)
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
        return _sum_last(self.op_cf) + _sum_last(self.emb_cf)

    @property
    def op_total(self) -> torch.Tensor:  # (..., 3)
        return _sum_last(self.op_cf)

    @property
    def emb_total(self) -> torch.Tensor:  # (..., 3)
        return _sum_last(self.emb_cf)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over a short last axis, left to right in elementwise adds: the
    same bits on the card and the CPU (a reduction kernel may reassociate
    differently on each, and a one-ulp flip moves a tied decision)."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum('...c,...c->...', a, b)`` as ordered elementwise
    multiply-adds (see ``_sum_last``); broadcasts like ``a * b``."""
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * b[..., k]
    return out


def _cf(energy_j: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Operational CF in grams from energy (J) and carbon intensity (g/kWh).
    The divisor is a tensor on the operand's device: PyTorch's CUDA kernel
    divides by a CPU scalar as a multiply by its reciprocal, which may be
    one ulp off the CPU's (and XLA's) true division."""
    return energy_j / energy_j.new_tensor(J_PER_KWH) * ci


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


def optimal_target(b: CFBreakdown, w: Workload, metric: str = "carbon",
                   avail: torch.Tensor | None = None) -> torch.Tensor:
    """argmin over feasible targets of the chosen metric (paper Fig 5
    stars). The energy metric needs the infra and environment: use
    ``optimal_targets_all_metrics``."""
    if metric == "carbon":
        score = b.total_cf
    elif metric == "latency":
        score = b.latency
    else:
        raise ValueError(metric)
    return pick_target(score, feasible(b, w), b.total_cf, avail)


def evaluate_energy(w: Workload, infra: InfraParams,
                    env: Environment) -> torch.Tensor:
    """(..., 3) operational energy (J) per target: ``evaluate`` with CI := 1
    for every component, times J_PER_KWH to undo the unit conversion."""
    unit_env = Environment(ci=torch.ones_like(env.ci),
                           interference=env.interference,
                           net_slowdown=env.net_slowdown)
    return _sum_last(evaluate(w, infra, unit_env).op_cf) * J_PER_KWH


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


def route_many_envs(w: Workload, infra: InfraParams, env: Environment,
                    avail: torch.Tensor) -> RouteOutputs:
    """(N,)-batched requests, each against ITS OWN environment: ``env.ci``
    (N, 5) per-request CI rows; interference / net_slowdown stay shared."""
    if env.ci.shape != w.flops.shape + (N_COMPONENTS,):
        raise ValueError(f"route_many_envs wants (N, {N_COMPONENTS}) CI rows "
                         f"for {tuple(w.flops.shape)} workloads, got "
                         f"{tuple(env.ci.shape)}")
    return route_one(w, infra, env, avail)


# ---------------------------------------------------------------------------
# Factorized evaluator: operational carbon is LINEAR in carbon intensity, so
# one Table-1 evaluation at unit CI scores every candidate (region, hour) as
# an ordered dot against a CarbonGrid CI row.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyFactors:
    """CI-independent factorization of Table 1, batched over requests.

    ``op_unit``  (..., 3, 5) grams per (g/kWh): operational CF at unit CI.
    ``emb_cf``   (..., 3, 5) grams, embodied (CI-free).
    ``latency``  (..., 3) s end-to-end; ``t_comm`` (..., 2) network times.
    """

    op_unit: torch.Tensor
    emb_cf: torch.Tensor
    latency: torch.Tensor
    t_comm: torch.Tensor

    @property
    def emb_total(self) -> torch.Tensor:  # (..., 3)
        return _sum_last(self.emb_cf)

    @property
    def energy_j(self) -> torch.Tensor:
        """(..., 3) operational energy per target."""
        return _sum_last(self.op_unit) * J_PER_KWH


def energy_factors(w: Workload, infra: InfraParams, interference,
                   net_slowdown) -> EnergyFactors:
    """One Table-1 evaluation at unit CI; interference / net_slowdown shape
    the times exactly as in ``evaluate``. Batches over ``w``'s leading
    axes (the reference's ``energy_factors_batch`` vmap)."""
    dev = w.flops.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    unit_env = Environment(ci=torch.ones((N_COMPONENTS,), dtype=torch.float32,
                                         device=dev),
                           interference=f32(interference),
                           net_slowdown=f32(net_slowdown))
    b = evaluate(w, infra, unit_env)
    return EnergyFactors(op_unit=b.op_cf, emb_cf=b.emb_cf, latency=b.latency,
                         t_comm=b.t_comm)


#: (N,)-batched factorization: ``energy_factors`` already batches.
energy_factors_batch = energy_factors


def total_cf_from_factors(f: EnergyFactors, ci: torch.Tensor) -> torch.Tensor:
    """(N, 3) total CF rows under per-request CI rows ``ci`` (N, 5)."""
    return _dot_last(f.op_unit, ci[..., None, :]) + f.emb_total


# --- Forecast-error risk on the factorized scorer ------------------------------

#: grid-trace-driven components of the 5-component CI row
_HOME_CI_RISK = (0.0, 1.0, 1.0, 0.0, 1.0)
#: ... and of the relocating [edge_dc, core_net, hyper_dc] columns
_DC_CI_RISK = (1.0, 0.0, 1.0)


def forecast_risk_scale(lead_h, sigma_h: float,
                        risk_lambda: float) -> torch.Tensor:
    """``1 + lambda * sigma_h * sqrt(lead)``: the mean-plus-lambda-std score
    multiplier on forecast-driven CI at ``lead_h`` hours ahead."""
    lead = torch.clamp_min(torch.as_tensor(lead_h, dtype=torch.float32), 0.0)
    return 1.0 + risk_lambda * sigma_h * torch.sqrt(lead)


def inflate_ci_risk(home_ci: torch.Tensor, cand_ci_dc: torch.Tensor, scale
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply a ``forecast_risk_scale`` multiplier to the forecast-driven
    components of ``home_ci`` (..., 5) and ``cand_ci_dc`` (..., 3)."""
    dev = home_ci.device
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    mask = lambda m: torch.tensor(m, dtype=torch.float32, device=dev)
    home = home_ci * (1.0 + (s - 1.0) * mask(_HOME_CI_RISK))
    dc = cand_ci_dc * (1.0 + (s - 1.0) * mask(_DC_CI_RISK))
    return home, dc


#: (N, 3) fps-sustain feasibility over batched factors
stream_feasible_batch = stream_feasible


def qos_feasible_from_factors(f: EnergyFactors, w: Workload,
                              extra_latency=0.0) -> torch.Tensor:
    """(N, 3) QoS feasibility from batched factors (+ optional WAN hop,
    scalar or (N,))."""
    extra = torch.as_tensor(extra_latency, dtype=torch.float32,
                            device=f.latency.device)
    extra = extra.expand(w.flops.shape)[:, None]
    return qos_feasible(f.latency, f.t_comm, w, extra)


def pair_qos_feasible_from_factors(f: EnergyFactors, w: Workload,
                                   extra_latency: torch.Tensor
                                   ) -> torch.Tensor:
    """(R, N, 3) QoS feasibility of every candidate placement under
    per-candidate WAN hops ``extra_latency`` (R, N)."""
    lat = f.latency[None] + extra_latency.to(torch.float32)[:, :, None]
    return ((lat <= w.latency_req[None, :, None])
            & stream_feasible_batch(f.t_comm, w)[None])


def route_many_from_factors(f: EnergyFactors, w: Workload, ci: torch.Tensor,
                            avail: torch.Tensor) -> RouteOutputs:
    """``route_many_envs`` rebuilt from precomputed factors and the
    per-request home CI rows — no Table-1 re-evaluation."""
    total_cf = total_cf_from_factors(f, ci)
    ok = qos_feasible_from_factors(f, w) & avail
    energy = f.energy_j
    return RouteOutputs(
        target=pick_target(total_cf, ok, total_cf, avail),
        target_latency=pick_target(f.latency, ok, total_cf, avail),
        target_energy=pick_target(energy, ok, total_cf, avail),
        total_cf=total_cf,
        latency=f.latency,
        ok=ok,
    )


def optimal_targets_all_metrics(w: Workload, infra: InfraParams,
                                env: Environment,
                                avail: torch.Tensor | None = None) -> dict:
    """Carbon/energy/latency-optimal targets, feasibility-aware (Fig 5)."""
    b = evaluate(w, infra, env)
    ok = feasible(b, w)
    out = route_one(w, infra, env,
                    torch.ones_like(ok) if avail is None else avail)
    return {
        "carbon": out.target,
        "energy": out.target_energy,
        "latency": out.target_latency,
        "breakdown": b,
        "feasible": ok,
    }
