"""Pluggable routing policies: one decision interface from the Table-1 oracle
to capacity-capped fleet simulation (port of ``src/repro/serve/policy.py``).

  * ``OraclePolicy``    — exhaustive Table-1 evaluation per request, with
    ``metric="carbon"/"latency"/"energy"``.
  * ``LearnedPolicy``   — a fitted scheduler of ``repro_torch.core.
    schedulers`` scoring live streams from feature rows (``feature_rows``,
    ``policy_features``); fitted on the host, scored on the router's device.
  * ``CapacityLimiter`` — per-(region, tier) request caps per hourly window,
    spilling each over-cap request to its next-best feasible tier. The
    reference folds windows with ``lax.scan``; here a Python loop over
    windows carries the counts on the device.

Protocol, as in the reference (``env.ci`` is per-request (N, 5)):

  ``scores(w, env, avail, hour=None) -> (N, 3)`` — lower is better, +inf
      marks tiers the policy would never pick.
  ``decide(w, env, avail, state, *, region, hour, outputs, order,
      inv_order, slack, factors, fc_table, cap_scale, used0, axis_name)
      -> (targets, new_state)``.
  ``initial_state(n_regions, n_requests)``.

Factorized hooks (``OraclePolicy``, ``LearnedPolicy``):
``scores_from_factors`` and ``pair_scores_from_factors`` score arbitrary
candidate CI rows from one ``carbon_model.EnergyFactors`` batch. The
einsums of the reference are ordered elementwise sums here
(``carbon_model._dot_last``), so the card and the CPU score to the bit.

The routers refuse any policy that is not a ``RoutingPolicy`` of this
package. ``axis_name`` is the process group of a sharded stream
(``repro_torch.serve.distributed``): per-row policies ignore it, and
``CapacityLimiter`` refuses it.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import carbon_model
from repro_torch.core.carbon_model import Environment, RouteOutputs
from repro_torch.core.constants import N_TARGETS
from repro_torch.core.infrastructure import InfraParams
from repro_torch.core.schedulers import SchedulerDataset, load_fitted_params
from repro_torch.core.workloads import Workload
from repro_torch.device import resolve_device

INF = float("inf")

#: why ``CapacityLimiter`` refuses a sharded stream; the pointer is the
#: reference's
CAPACITY_LIMITER_UNSHARDED = (
    "CapacityLimiter's admission walks windows sequentially per device and "
    "cannot reconcile caps across a sharded stream — use PlacementPolicy "
    "(identity adjacency reproduces CapacityLimiter bit-for-bit) on the "
    "sharded path")


def one_hot_i32(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int32 one-hot by comparison: an index outside [0, n) gives
    a zero row, as ``jax.nn.one_hot`` does. ``torch.nn.functional.one_hot``
    raises on -1 and returns int64."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def take_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, None], axis=1)[:, 0]``; ``torch.gather``
    wants int64 indices."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def nan_to_inf(s: torch.Tensor) -> torch.Tensor:
    """NaN scores as +inf: a NaN candidate is never picked. ``argmin``
    picks a NaN (in torch and in jnp alike) while ``argsort`` ranks it
    last, so the admission programs, which use both, count it as
    infeasible instead of relying on either."""
    return torch.where(torch.isnan(s), torch.full_like(s, INF), s)


def scores_with_reuse(inner: "RoutingPolicy", w: Workload, env: Environment,
                      avail: torch.Tensor, hour, outputs: RouteOutputs | None
                      ) -> torch.Tensor:
    """``inner.scores``, or its reconstruction from a precomputed
    ``RouteOutputs`` when the inner policy offers ``scores_from_outputs``."""
    if outputs is not None:
        reuse = getattr(inner, "scores_from_outputs", None)
        if reuse is not None:
            s = reuse(outputs, avail)
            if s is not None:
                return s
    return inner.scores(w, env, avail, hour=hour)


class RoutingPolicy(abc.ABC):
    """Base class: a policy is ``scores`` + (optionally stateful) ``decide``.
    The default ``decide`` is the stateless argmin over ``scores``."""

    name = "policy"

    def initial_state(self, n_regions: int, n_requests: int) -> Any:
        return ()

    @abc.abstractmethod
    def scores(self, w: Workload, env: Environment, avail: torch.Tensor, *,
               hour=None) -> torch.Tensor:
        """(N, 3) per-tier scores, lower is better, +inf = never pick."""

    def decide(self, w, env, avail, state, *, region=None, hour=None,
               outputs=None, order=None, inv_order=None, slack=None,
               factors=None, fc_table=None, cap_scale=None, used0=None,
               axis_name=None):
        s = nan_to_inf(self.scores(w, env, avail, hour=hour))
        return torch.argmin(s, dim=-1).to(torch.int32), state


# ---------------------------------------------------------------------------
# Oracle (Table-1 search)
# ---------------------------------------------------------------------------


def _masked_scores(ok, score, avail, fallback, any_base=None):
    """The oracle's +inf encoding: feasible tiers carry the metric; a row
    with no feasible tier falls back to ``fallback`` over available tiers,
    unless ``any_base`` says it was feasible without a WAN hop (then the
    hop alone broke it, and the whole row is refused)."""
    inf = torch.full_like(score, INF)
    fall = torch.where(avail, fallback, inf)
    if any_base is not None:
        fall = torch.where(any_base, inf, fall)
    return torch.where(ok.any(dim=-1, keepdim=True),
                       torch.where(ok, score, inf), fall)


@dataclasses.dataclass
class OraclePolicy(RoutingPolicy):
    """Exhaustive Table-1 evaluation per request (the paper's explorer).

    ``metric``: ``"carbon"`` is GreenScale, ``"latency"`` / ``"energy"`` the
    paper's baselines. ``decide`` reproduces ``route_many_envs``'s
    per-metric targets."""

    infra: InfraParams
    metric: str = "carbon"

    def __post_init__(self):
        if self.metric not in ("carbon", "latency", "energy"):
            raise ValueError(f"unknown metric {self.metric!r}")
        self.name = f"oracle-{self.metric}"

    def scores(self, w, env, avail, *, hour=None):
        """(N, 3) metric scores (gCO2 / s / J per request) from one batched
        Table-1 evaluation."""
        b = carbon_model.evaluate(w, self.infra, env)
        ok = carbon_model.feasible(b, w) & avail
        if self.metric == "carbon":
            score = b.total_cf
        elif self.metric == "latency":
            score = b.latency
        else:
            score = carbon_model.evaluate_energy(w, self.infra, env)
        return _masked_scores(ok, score, avail, b.total_cf)

    def scores_from_outputs(self, out: RouteOutputs, avail):
        """``scores`` from a precomputed ``RouteOutputs`` of the same
        (w, env, avail); None for the energy metric."""
        if self.metric == "energy":
            return None
        score = out.total_cf if self.metric == "carbon" else out.latency
        return _masked_scores(out.ok, score, avail, out.total_cf)

    def scores_from_factors(self, factors, w, ci, avail, extra_latency=0.0,
                            *, hour=None, interference=None,
                            net_slowdown=None):
        """``scores`` under arbitrary per-request CI rows ``ci`` (N, 5) from
        an ``EnergyFactors`` batch; ``extra_latency`` (scalar or (N,)) is a
        remote candidate's WAN hop. A candidate infeasible only because of
        the hop is refused outright (all +inf)."""
        total_cf = carbon_model.total_cf_from_factors(factors, ci)
        ok_base = carbon_model.qos_feasible_from_factors(factors, w) & avail
        ok = carbon_model.qos_feasible_from_factors(
            factors, w, extra_latency) & avail
        if self.metric == "carbon":
            score = total_cf
        elif self.metric == "latency":
            extra = torch.as_tensor(extra_latency, dtype=torch.float32,
                                    device=total_cf.device)
            score = factors.latency + (extra.reshape(-1, 1) if extra.ndim
                                       else extra)
        else:
            score = factors.energy_j
        return _masked_scores(ok, score, avail, total_cf,
                              ok_base.any(dim=-1, keepdim=True))

    def pair_scores_from_factors(self, factors, w, home_ci, cand_ci_dc,
                                 avail, extra_latency=None, *, hour=None,
                                 interference=None, net_slowdown=None):
        """(C, N, 3) ``scores_from_factors`` over candidate regions:
        ``home_ci`` (N, 5) bills [mobile, edge_net] at home, ``cand_ci_dc``
        (C, N, 3) holds each candidate's [edge_dc, core_net, hyper_dc],
        ``extra_latency`` (C, N) its WAN hop (None = no hop anywhere)."""
        hp = carbon_model._dot_last(factors.op_unit[..., :2],
                                    home_ci[:, None, :2])  # (N, 3)
        cp = carbon_model._dot_last(factors.op_unit[None, ..., 2:],
                                    cand_ci_dc[:, :, None, :])  # (C, N, 3)
        total_cf = hp[None] + cp + factors.emb_total[None]
        ok_base = carbon_model.qos_feasible_from_factors(factors, w) & avail
        any_base = ok_base.any(dim=-1, keepdim=True)  # (N, 1)
        if extra_latency is None:
            ok = ok_base[None]
            lat = factors.latency[None]
        else:
            extra = extra_latency.to(torch.float32)  # (C, N)
            lat = factors.latency[None] + extra[:, :, None]
            ok = (carbon_model.pair_qos_feasible_from_factors(
                factors, w, extra) & avail[None])
        if self.metric == "carbon":
            score = total_cf
        elif self.metric == "latency":
            score = lat.expand(total_cf.shape)
        else:
            score = factors.energy_j[None].expand(total_cf.shape)
        return _masked_scores(ok.expand(total_cf.shape), score,
                              avail[None].expand(total_cf.shape), total_cf,
                              any_base[None])

    def decide(self, w, env, avail, state, *, region=None, hour=None,
               outputs=None, order=None, inv_order=None, slack=None,
               factors=None, fc_table=None, cap_scale=None, used0=None,
               axis_name=None):
        """(N,) int32 targets straight from the Table-1 search (reusing the
        router's ``RouteOutputs`` when given)."""
        out = outputs if outputs is not None else \
            carbon_model.route_many_envs(w, self.infra, env, avail)
        t = {"carbon": out.target, "latency": out.target_latency,
             "energy": out.target_energy}[self.metric]
        return t.to(torch.int32), state


def _gate_hop_broken(s, factors, w, extra_latency):
    """+inf for candidates whose WAN hop breaks an otherwise-feasible tier;
    ``s`` is (N, 3) with scalar/(N,) hops or (C, N, 3) with (C, N). No-hop
    calls (None / literal 0) return ``s`` unchanged."""
    if extra_latency is None or (
            not isinstance(extra_latency, torch.Tensor)
            and float(extra_latency) == 0.0):
        return s
    ok_base = carbon_model.qos_feasible_from_factors(factors, w)  # (N, 3)
    inf = torch.full_like(s, INF)
    if s.ndim == 3:
        ok_hop = carbon_model.pair_qos_feasible_from_factors(
            factors, w, extra_latency)
        return torch.where(ok_base[None] & ~ok_hop, inf, s)
    ok_hop = carbon_model.qos_feasible_from_factors(factors, w, extra_latency)
    return torch.where(ok_base & ~ok_hop, inf, s)


#: feature columns of the 3 CI components that relocate with a cross-region
#: placement, [edge_dc, core_net, hyper_dc] (the 5 CI columns follow the 6
#: workload columns)
_CI_DC_COLS = slice(8, 11)


#: float32(1 / ln 10): XLA's float32 ``log10`` is ``log(x)`` times this
_INV_LN10 = float(np.float32(1.0 / math.log(10.0)))


def _log10_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log10`` formed as the reference's XLA forms it, ``log(x) *
    float32(1/ln 10)``, with ``log`` evaluated in float64 and rounded once:
    the card's and the CPU's float32 ``log`` may differ by an ulp, their
    float64 results rounded to float32 practically never do."""
    return torch.log(x.double()).float() * _INV_LN10


def feature_rows(w: Workload, ci: torch.Tensor,
                 interference: torch.Tensor | None = None,
                 net_slowdown: torch.Tensor | None = None,
                 hour: torch.Tensor | None = None,
                 emb_lca: bool = False) -> torch.Tensor:
    """(N, 19) raw (un-standardized) float32 feature rows from explicit CI
    rows, column for column as ``schedulers.build_dataset``: workload
    descriptor, scenario CI/variance, hour-of-day harmonics, embodied-model
    flag. ``ci`` is (5,) shared or (N, 5) per request; ``hour`` any absolute
    horizon hour (the harmonics wrap daily). Every division is by a tensor
    (CUDA divides by a Python scalar through its reciprocal) and the
    transcendentals are rounded from float64 (``_log10_f32``), so the card
    and the CPU build the same rows."""
    n = w.flops.shape[0]
    dev = w.flops.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    f_w = torch.stack([
        _log10_f32(w.flops + 1.0),
        _log10_f32(w.mem_bytes + 1.0),
        _log10_f32(w.data_in + 1.0),
        _log10_f32(w.data_out + 1.0),
        _log10_f32(w.latency_req + 1e-6),
        w.continuous,
    ], dim=-1)
    bcast = lambda a, k: f32(a).reshape(-1, k).expand(n, k)
    if interference is None:
        interference = torch.ones((3,), dtype=torch.float32, device=dev)
    if net_slowdown is None:
        net_slowdown = torch.ones((2,), dtype=torch.float32, device=dev)
    h = (torch.zeros((n,), dtype=torch.float32, device=dev) if hour is None
         else f32(hour).expand(n))
    ang = (h * float(2.0 * math.pi)) / f32(24.0)
    return torch.cat([
        f_w,
        bcast(ci, 5) / f32(100.0),
        bcast(interference, 3),
        bcast(net_slowdown, 2),
        torch.sin(ang.double()).float()[:, None],
        torch.cos(ang.double()).float()[:, None],
        torch.full((n, 1), 1.0 if emb_lca else 0.0, dtype=torch.float32,
                   device=dev),
    ], dim=-1)


def policy_features(w: Workload, env: Environment, hour=None,
                    emb_lca: bool = False) -> torch.Tensor:
    """``feature_rows`` of a live stream's Environment (the sweep path)."""
    return feature_rows(w, env.ci, env.interference, env.net_slowdown,
                        hour, emb_lca)


@dataclasses.dataclass
class LearnedPolicy(RoutingPolicy):
    """A fitted scheduler routing live streams.

    Built with ``LearnedPolicy.fit(scheduler, train, device=...)``: the
    scheduler's ``fit_params`` runs on the host (CPU float32, the same fit
    for every device), its static ``torch_scores(params, X)`` becomes the
    per-request scorer, and the training set's standardization statistics
    travel along. The factorized hooks score candidate (region, hour)
    placements by re-featurizing their CI rows; CI-linear schedulers
    (``ci_linear``) collapse the candidate axis to one ordered sum against
    the probed per-column sensitivities ``ci_sens``, others re-run the
    scorer per candidate region (the reference's ``jax.vmap``). ``infra``
    is only needed to build ``EnergyFactors`` outside a ``FleetRouter``."""

    params: Any
    score_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    feat_mean: torch.Tensor
    feat_std: torch.Tensor
    emb_lca: bool = False
    name: str = "learned"
    infra: Any = None
    #: (F, 3) score sensitivity to each standardized feature column, probed
    #: on the host at fit time for CI-linear schedulers; None = generic
    #: per-candidate inference in the pair hook
    ci_sens: torch.Tensor | None = None

    @classmethod
    def fit(cls, scheduler, train: SchedulerDataset, emb_lca: bool = False,
            infra: Any = None, *, device: str | torch.device = "cuda"
            ) -> "LearnedPolicy":
        """Fit ``scheduler`` on the host and wrap the fitted scorer as a
        policy on ``device``. CI-linear schedulers get ``ci_sens`` probed
        on the host too: ``s[1:] - s[:1]`` over the zero row and the unit
        rows, in float32 as the reference does."""
        dev = resolve_device(device)
        if train.feat_mean is None or train.feat_std is None:
            raise ValueError(
                "dataset has no feature statistics — rebuild it with "
                "schedulers.build_dataset (feat_mean/feat_std are required "
                "to featurize live streams)")
        params = load_fitted_params(scheduler.fit_params(train),
                                    device="cpu")
        ci_sens = None
        if getattr(scheduler, "ci_linear", False):
            n_feat = int(np.asarray(train.feat_mean).shape[0])
            probes = torch.cat([torch.zeros((1, n_feat)), torch.eye(n_feat)])
            s = type(scheduler).torch_scores(params, probes)
            ci_sens = s[1:] - s[:1]
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        return cls(name=f"learned-{scheduler.name}", params=params,
                   score_fn=type(scheduler).torch_scores,
                   feat_mean=f32(train.feat_mean),
                   feat_std=f32(train.feat_std), emb_lca=emb_lca,
                   infra=infra, ci_sens=ci_sens).to(dev)

    def to(self, device: str | torch.device) -> "LearnedPolicy":
        """A copy with params, statistics and sensitivities on ``device``."""
        dev = resolve_device(device)
        mv = lambda t: None if t is None else t.to(dev)
        return dataclasses.replace(
            self, params={k: v.to(dev) for k, v in self.params.items()},
            feat_mean=mv(self.feat_mean), feat_std=mv(self.feat_std),
            ci_sens=mv(self.ci_sens))

    def _score_rows(self, w, ci, interference, net_slowdown, hour
                    ) -> torch.Tensor:
        """(N, 3) raw scheduler scores under explicit CI rows + context."""
        X = feature_rows(w, ci, interference, net_slowdown, hour,
                         self.emb_lca)
        X = (X - self.feat_mean) / self.feat_std
        return self.score_fn(self.params, X)

    def scores(self, w, env, avail, *, hour=None):
        s = self._score_rows(w, env.ci, env.interference, env.net_slowdown,
                             hour)
        return torch.where(avail, s, torch.full_like(s, INF))

    def scores_from_factors(self, factors, w, ci, avail, extra_latency=0.0,
                            *, hour=None, interference=None,
                            net_slowdown=None):
        """``scores`` under arbitrary per-request CI rows; ``factors`` only
        enters through the WAN-hop gate (a candidate whose hop breaks an
        otherwise-feasible tier is refused)."""
        s = self._score_rows(w, ci, interference, net_slowdown, hour)
        s = torch.where(avail, s, torch.full_like(s, INF))
        return _gate_hop_broken(s, factors, w, extra_latency)

    def pair_scores_from_factors(self, factors, w, home_ci, cand_ci_dc,
                                 avail, extra_latency=None, *, hour=None,
                                 interference=None, net_slowdown=None):
        """(R, N, 3) ``scores_from_factors`` over candidate regions:
        ``home_ci`` (N, 5) anchors [mobile, edge_net], ``cand_ci_dc``
        (R, N, 3) carries each candidate's relocating columns. CI-linear
        schedulers score the home row once and add ``delta_ci . ci_sens``
        (the reference's einsum, as an ordered sum over the 3 columns);
        others re-run the scorer per candidate region."""
        if self.ci_sens is not None:
            s0 = self._score_rows(w, home_ci, interference, net_slowdown,
                                  hour)  # (N, 3)
            # features carry ci/100 standardized by feat_std: a candidate
            # differs from home only in the relocating CI columns
            std = self.feat_std[_CI_DC_COLS]
            scale = std.new_tensor(1.0) / (100.0 * std)  # (3,)
            delta = (cand_ci_dc - home_ci[None, :, 2:]) * scale  # (R, N, 3)
            sens = self.ci_sens[_CI_DC_COLS]  # (3, 3)
            s = s0[None] + _rowdot3(delta, sens)
        else:
            s = torch.stack([
                self._score_rows(w, torch.cat([home_ci[:, :2], ci_dc], dim=1),
                                 interference, net_slowdown, hour)
                for ci_dc in cand_ci_dc])  # (R, N, 3)
        s = torch.where(avail[None], s, torch.full_like(s, INF))
        return _gate_hop_broken(s, factors, w, extra_latency)


def _rowdot3(delta: torch.Tensor, sens: torch.Tensor) -> torch.Tensor:
    """``einsum("rnc,ct->rnt", delta, sens)`` as an ordered sum over c."""
    out = delta[..., 0:1] * sens[0]
    for c in range(1, delta.shape[-1]):
        out = out + delta[..., c:c + 1] * sens[c]
    return out


# ---------------------------------------------------------------------------
# Capacity-capped routing (CASPER-style per-tier load caps)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapacityState:
    """Threaded state of a ``CapacityLimiter`` decision.

    ``counts`` (R, 3) int32 capacity-admitted assignments (shed and
    unroutable requests excluded); ``shed`` (N,) bool routable requests
    whose every finite-score tier was at cap in their window."""

    counts: torch.Tensor
    shed: torch.Tensor


def _caps_tensor(caps) -> torch.Tensor:
    t = torch.as_tensor(caps.cpu() if isinstance(caps, torch.Tensor)
                        else caps, dtype=torch.float32)
    if t.ndim != 2 or t.shape[1] != N_TARGETS:
        raise ValueError(f"caps must be (n_regions, {N_TARGETS}), got "
                         f"{tuple(t.shape)}")
    return t


@dataclasses.dataclass
class CapacityLimiter(RoutingPolicy):
    """Wrap any policy with per-(region, tier) request caps per window.

    Each window gets a fresh budget of ``caps[r, t]`` requests; requests
    are admitted greedily in stream order against the inner policy's
    ranking, spilling to the next finite-score tier; a routable request
    whose every finite-score tier is full is shed (it keeps its first
    choice but consumes no cap). ``PlacementPolicy`` with identity
    adjacency reproduces these decisions bit for bit."""

    inner: RoutingPolicy
    caps: Any  # array-like (R, 3); inf = uncapped
    n_windows: int = 24

    def __post_init__(self):
        self._caps = _caps_tensor(self.caps)
        self.name = f"capped-{self.inner.name}"

    def initial_state(self, n_regions: int, n_requests: int) -> CapacityState:
        if self._caps.shape[0] != n_regions:
            raise ValueError(f"caps cover {self._caps.shape[0]} regions, "
                             f"fleet has {n_regions}")
        dev = self._caps.device
        return CapacityState(
            counts=torch.zeros((n_regions, N_TARGETS), dtype=torch.int32,
                               device=dev),
            shed=torch.zeros((n_requests,), dtype=torch.bool, device=dev))

    def scores(self, w, env, avail, *, hour=None):
        return self.inner.scores(w, env, avail, hour=hour)

    def decide(self, w, env, avail, state, *, region=None, hour=None,
               outputs=None, order=None, inv_order=None, slack=None,
               factors=None, fc_table=None, cap_scale=None, used0=None,
               axis_name=None):
        """(N,) int32 targets under greedy per-window cap admission. Each
        window's three spill rounds rank competitors with an int32 prefix
        count over the (N, R*3) one-hot (the reference accumulates the same
        integers in float32)."""
        if axis_name is not None:
            raise NotImplementedError(CAPACITY_LIMITER_UNSHARDED)
        n = w.flops.shape[0]
        dev = w.flops.device
        caps_flat = self._caps.to(dev).reshape(-1)
        n_cols = caps_flat.numel()
        region = (torch.zeros((n,), dtype=torch.long, device=dev)
                  if region is None else torch.as_tensor(region, device=dev)
                  .long())
        win = (torch.zeros((n,), dtype=torch.long, device=dev) if hour is None
               else torch.as_tensor(hour, device=dev).to(torch.int32).long()
               % self.n_windows)
        scores = nan_to_inf(scores_with_reuse(self.inner, w, env, avail,
                                              hour, outputs))
        pref = torch.argsort(scores, dim=1, stable=True)  # best-first
        valid = torch.isfinite(torch.gather(scores, 1, pref))
        counts = state.counts.to(dev)
        targets = torch.zeros((n,), dtype=torch.long, device=dev)
        shed = torch.zeros((n,), dtype=torch.bool, device=dev)
        for h in range(self.n_windows):
            in_win = win == h
            target = torch.zeros((n,), dtype=torch.long, device=dev)
            placed = torch.zeros((n,), dtype=torch.bool, device=dev)
            win_counts = torch.zeros((n_cols,), dtype=torch.float32,
                                     device=dev)
            for k in range(N_TARGETS):  # spill rounds: 1st..3rd choice
                choice = pref[:, k]
                want = in_win & ~placed & valid[:, k]
                col = region * N_TARGETS + choice
                oh = one_hot_i32(col, n_cols) * want[:, None]
                # 1-based arrival rank among this round's competitors for
                # the same (region, tier) column
                rank = take_cols(prefix_count(oh), col)
                fits = want & (win_counts[col] + rank <= caps_flat[col])
                target = torch.where(fits, choice, target)
                win_counts = win_counts + (oh * fits[:, None]).sum(dim=0)
                placed = placed | fits
            # only routable leftovers are shed; a request with no
            # finite-score tier keeps the uncapped degenerate fallback
            shed = shed | (in_win & ~placed & valid[:, 0])
            target = torch.where(in_win & ~placed, pref[:, 0], target)
            targets = torch.where(in_win, target, targets)
            counts = counts + win_counts.reshape(self._caps.shape).to(
                torch.int32)
        return targets.to(torch.int32), CapacityState(counts=counts,
                                                      shed=shed)


def prefix_count(oh: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive int32 prefix sum of (N, P) counts down the rows.

    ``torch.cumsum`` of int32 returns int64 unless given ``dtype``, so the
    dtype is pinned. The scan runs in two levels (within row blocks of
    ``block``, then over the block totals): integer adds give the same
    bits in any grouping, and a single scan down 10^6 rows of a few hundred
    columns is one sequential walk per column on CUDA."""
    n, p = oh.shape
    if n <= block:
        return torch.cumsum(oh, dim=0, dtype=torch.int32)
    nb = -(-n // block)
    pad = nb * block - n
    x = oh if pad == 0 else torch.cat(
        [oh, oh.new_zeros((pad, p))], dim=0)
    cs = torch.cumsum(x.reshape(nb, block, p), dim=1, dtype=torch.int32)
    tot = cs[:, -1, :]
    cs += (torch.cumsum(tot, dim=0, dtype=torch.int32) - tot)[:, None, :]
    return cs.reshape(nb * block, p)[:n]
