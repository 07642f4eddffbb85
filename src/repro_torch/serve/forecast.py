"""Rolling forecast-native re-planning: plan on forecasts, settle on actuals
(port of ``src/repro/serve/forecast.py``).

The one-shot ``FleetRouter.route_stream`` plans the whole horizon at once
against the grid's CI view; with a real forecast attached that view is wrong
in proportion to hours ahead. ``route_stream_rolling`` drives the temporal
deferral engine the way a production scheduler would:

  * the stream is planned in ``step_h``-hour steps; at each step the grid's
    forecast is re-anchored (``CarbonGrid.roll(now)``): hours that have
    arrived are revealed as actuals, the tail stays noisy;
  * deferred work is held in a carry-over queue and re-scored at the next
    step under the fresher forecast (its slack re-anchored to the hours it
    has left); work planned into the current step, or shed work whose
    deadline expires within it, is committed;
  * committed capacity persists across steps through the temporal engine's
    ``used0`` seam, so no later step double-books a cell;
  * an optional ``EmissionsLedger`` scales per-region capacity each step
    (conserve ahead of a predicted clean stretch, spend banked credit ahead
    of a dirty one); credits spent never exceed credits earned.

Routed carbon is charged at the actual table at each request's committed
(region, hour). The plan/commit bookkeeping is host numpy, as in the
reference; each step's route runs on the router's device and syncs once to
read its decisions back. The reference pads each step's sub-batch to a
power of two to bound its jit shapes; eager torch needs no such bound, but
the padding is kept: pad rows enter the prefix counts, and the decisions
must be the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import carbon_model
from repro_torch.core.constants import N_TARGETS
from repro_torch.serve.policy import take_cols


@dataclasses.dataclass
class EmissionsLedger:
    """Per-region credit/debt emissions budget over the rolling plan.

    Each step compares the mean forecast CI over the ``lookahead_h`` hours
    after the current step against the current step's mean (``trend =
    future / present``): a trend below ``clean_threshold`` means cleaner
    hours are coming — conserve capacity now (scale caps by
    ``conserve_scale`` < 1) and bank the difference as credit; a trend
    above ``dirty_threshold`` means the grid is about to worsen — spend
    banked credit (scale caps up to ``spend_scale``) to drain deferrable
    work before it does. The balance is capped at ``max_credit_h`` and can
    never go negative, so credits spent <= credits earned by construction.

    With a DEMAND forecast attached (``demand_fc``, requests/hour over
    the same absolute horizon), the ledger is additionally flash-crowd
    aware: a predicted spike — the lookahead's peak demand exceeding the
    current step's mean by ``spike_threshold``x — forces the CONSERVE
    branch regardless of the CI trend ('spike expected: strongly conserve
    credit'), banking capacity credit ahead of the crowd; once the spike
    ARRIVES (current demand at ``spike_threshold``x the horizon mean) the
    banked credit is spent, raising the caps exactly when the crowd needs
    them. ``demand_fc = None`` (the default) reproduces the CI-only
    behaviour bit-for-bit; the spent-<=-earned property is unchanged
    (spending is still bounded by the balance).

    Units: CI tables are gCO2/kWh, demand is requests/hour, the balance
    is in cap-scale-hours (one unit = one step of fully-conserved caps).
    """

    clean_threshold: float = 0.95
    dirty_threshold: float = 1.05
    conserve_scale: float = 0.8
    spend_scale: float = 1.25
    max_credit_h: float = 4.0
    lookahead_h: int = 12
    #: optional (H,) or (R, H) demand forecast (requests/hour, absolute
    #: horizon hours — e.g. ``spike_demand_forecast``'s hourly totals).
    demand_fc: np.ndarray | None = None
    #: demand ratio that counts as a flash crowd (peak-ahead / current
    #: mean, or current / horizon mean once it lands).
    spike_threshold: float = 1.5

    def __post_init__(self):
        if not 0.0 < self.conserve_scale <= 1.0:
            raise ValueError("conserve_scale must be in (0, 1]")
        if self.spend_scale < 1.0:
            raise ValueError("spend_scale must be >= 1")
        if self.spike_threshold <= 1.0:
            raise ValueError("spike_threshold must be > 1")

    def cap_scales(self, fc_ci: np.ndarray, now: int, step_h: int,
                   balance: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(cap_scale, new_balance, earned, spent) per region for the step
        starting at ``now``; ``fc_ci`` is the (R, H) forecast grid-CI table
        of the current roll (gCO2/kWh). Pure — the caller threads
        ``balance``. Finite even at CI exactly 0 (a curtailment window):
        the trend denominator is floored, so a zero-CI present reads as a
        strong spend-now signal instead of dividing by zero."""
        h = fc_ci.shape[1]
        cur = fc_ci[:, now:min(now + step_h, h)].mean(axis=1)
        fut_lo = min(now + step_h, h)
        fut_hi = min(fut_lo + self.lookahead_h, h)
        if fut_hi <= fut_lo:  # horizon tail: nothing ahead to plan for
            r = fc_ci.shape[0]
            return (np.ones(r), balance.copy(), np.zeros(r), np.zeros(r))
        trend = fc_ci[:, fut_lo:fut_hi].mean(axis=1) / np.maximum(cur, 1e-9)
        conserve = trend < self.clean_threshold
        spend = trend > self.dirty_threshold
        if self.demand_fc is not None:
            d = np.asarray(self.demand_fc, np.float64)
            if d.ndim == 1:
                d = np.broadcast_to(d[None, :], fc_ci.shape)
            if d.shape != fc_ci.shape:
                raise ValueError(
                    f"demand_fc must be ({fc_ci.shape[0]}, {h}) or ({h},), "
                    f"got {d.shape}")
            cur_d = d[:, now:fut_lo].mean(axis=1)
            peak_ahead = d[:, fut_lo:fut_hi].max(axis=1)
            spike_ahead = (peak_ahead
                           > self.spike_threshold * np.maximum(cur_d, 1e-9))
            spike_now = (cur_d > self.spike_threshold
                         * np.maximum(d.mean(axis=1), 1e-9))
            conserve = (conserve | spike_ahead) & ~spike_now
            spend = (spend | spike_now) & ~spike_ahead
        earned = np.where(conserve, 1.0 - self.conserve_scale, 0.0)
        spendable = np.where(
            spend, np.minimum(self.spend_scale - 1.0, balance), 0.0)
        scale = np.where(conserve, self.conserve_scale, 1.0 + spendable)
        new_balance = np.minimum(balance + earned - spendable,
                                 self.max_credit_h)
        return scale, new_balance, earned, spendable


@dataclasses.dataclass(frozen=True)
class LedgerStep:
    """One rolling-plan step's record (diagnostics + property tests)."""

    now: int  # step start (absolute horizon hour)
    planned: int  # rows scored this step (arrived or carried)
    committed: int  # rows committed (executing this step / expired shed)
    held: int  # rows carried to the next step
    shed: int  # committed rows that shed
    trend: np.ndarray  # (R,) forecast future/present CI ratio (1s w/o ledger)
    cap_scale: np.ndarray  # (R,) capacity multiplier applied (1s w/o ledger)
    earned: np.ndarray  # (R,) ledger credit earned this step
    spent: np.ndarray  # (R,) ledger credit spent this step


@dataclasses.dataclass(frozen=True)
class RollingRouteResult:
    """Outcome of ``route_stream_rolling`` — per-request commitments plus
    the step-by-step plan trace. Carbon is charged at ACTUAL CI."""

    target: np.ndarray  # (N,) int32 committed tier
    exec_region: np.ndarray  # (N,) int32 committed executing region
    exec_hour: np.ndarray  # (N,) int32 committed absolute execution hour
    defer_hours: np.ndarray  # (N,) int32 exec_hour - arrival hour (0 if shed)
    shed: np.ndarray  # (N,) bool committed as shed
    carbon_g: np.ndarray  # (N,) gCO2 at actual CI of the committed cell
    total_carbon_g: float  # sum of carbon_g (shed at nominal placement)
    routed_carbon_g: float  # sum over non-shed rows
    steps: tuple[LedgerStep, ...]

    @property
    def shed_count(self) -> int:
        return int(self.shed.sum())

    @property
    def deferred_count(self) -> int:
        return int(((self.defer_hours > 0) & ~self.shed).sum())


def pad_pow2(n: int, lo: int = 16) -> int:
    """Sub-batch bucket size: next power of two >= max(n, lo). The
    reference bounds its jit shapes with it; here it keeps the pad rows,
    and with them the decisions, the reference's."""
    p = lo
    while p < n:
        p *= 2
    return p


def slice_batch(batch, idx: np.ndarray, pad_to: int):
    """Row-slice a ``RequestBatch`` and pad it to ``pad_to`` rows with
    unroutable dummies (no tier available -> they bypass capacity and are
    dropped on unpad)."""
    n = len(idx)
    extra = pad_to - n

    def take(col, fill):
        a = np.asarray(col)[idx]
        if extra == 0:
            return a
        pad = np.full((extra,) + a.shape[1:], fill, dtype=a.dtype)
        return np.concatenate([a, pad])

    return dataclasses.replace(
        batch,
        prompt_tokens=take(batch.prompt_tokens, 16.0),
        max_new_tokens=take(batch.max_new_tokens, 16.0),
        latency_budget_s=take(batch.latency_budget_s, 10.0),
        bytes_per_token=take(batch.bytes_per_token, 4.0),
        available=take(batch.available, False),
        slack_hours=(None if batch.slack_hours is None
                     else take(batch.slack_hours, 0.0)))


def route_stream_rolling(fr, batch, region, t_hours, *, step_h: int = 6,
                         ledger: EmissionsLedger | None = None
                         ) -> RollingRouteResult:
    """Drive ``fr`` (a ``FleetRouter`` with a ``TemporalPolicy``) over the
    stream in rolling ``step_h``-hour plan steps (see the module
    docstring). ``t_hours`` must lie inside the grid horizon: the rolling
    planner owns the time axis and never wraps."""
    from repro_torch.serve.temporal import TemporalPolicy

    policy = fr.policy
    if not isinstance(policy, TemporalPolicy):
        raise ValueError(
            "route_stream_rolling needs a TemporalPolicy (the carry-over "
            f"queue re-plans deferrals), got {type(policy).__name__}")
    if step_h < 1:
        raise ValueError(f"step_h must be >= 1, got {step_h}")
    horizon = fr._horizon_h
    n = len(batch)
    arr_hour = np.floor(np.asarray(t_hours)).astype(np.int32)
    if n and (arr_hour.min() < 0 or arr_hour.max() >= horizon):
        raise ValueError(
            f"t_hours must lie in [0, {horizon}) — the rolling planner's "
            f"time axis is the grid horizon and never wraps")
    region_np = np.asarray(region).astype(np.int32)
    slack = np.minimum(batch.slack_h, policy.max_defer_h).astype(np.int32)
    deadline = arr_hour + slack

    W = policy.n_windows or horizon
    n_regions = fr.grid.n_regions
    n_pairs = n_regions * N_TARGETS
    routable = np.asarray(batch.available).any(axis=1)

    # committed per-request outcome
    tgt = np.zeros(n, np.int32)
    er = region_np.copy()
    eh = arr_hour.copy()
    shed = np.zeros(n, bool)
    done = np.zeros(n, bool)
    # capacity already committed, keyed like the temporal engine's cells
    used_committed = np.zeros(W * n_pairs, np.float32)

    balance = np.zeros(n_regions)
    steps: list[LedgerStep] = []
    ones = np.ones(n_regions)
    dev = fr.device
    host = lambda t: t.cpu().numpy()

    for now in range(0, horizon, step_h):
        last = now + step_h >= horizon
        fc_k = fr.grid.roll(now).table_forecast

        if ledger is not None:
            fc_ci = host(fc_k[..., 1])  # raw grid-CI forecast column
            scale, balance, earned, spent = ledger.cap_scales(
                fc_ci, now, step_h, balance)
            # the trend, again, for the step trace
            h = fc_ci.shape[1]
            fut_lo = min(now + step_h, h)
            fut_hi = min(fut_lo + ledger.lookahead_h, h)
            cur = fc_ci[:, now:fut_lo].mean(axis=1)
            trend = (fc_ci[:, fut_lo:fut_hi].mean(axis=1)
                     / np.maximum(cur, 1e-9) if fut_hi > fut_lo else ones)
            cap_scale = torch.as_tensor(np.asarray(scale, np.float32),
                                        device=dev)
        else:
            scale, earned, spent, trend = ones, ones * 0, ones * 0, ones
            cap_scale = None

        # plan everything that has arrived (or arrives this step) and is
        # not yet committed — carried holds are re-scored under this roll
        idx = np.nonzero(~done & (arr_hour < now + step_h))[0]
        if len(idx) == 0:
            steps.append(LedgerStep(
                now=now, planned=0, committed=0, held=0, shed=0,
                trend=np.asarray(trend), cap_scale=np.asarray(scale),
                earned=np.asarray(earned), spent=np.asarray(spent)))
            continue

        eff_hour = np.maximum(arr_hour[idx], now).astype(np.int32)
        eff_slack = np.maximum(deadline[idx] - eff_hour, 0).astype(np.int32)
        pad_to = pad_pow2(len(idx))
        sub = slice_batch(batch, idx, pad_to)
        sub_region = np.concatenate(
            [region_np[idx], np.zeros(pad_to - len(idx), np.int32)])
        sub_hour = np.concatenate(
            [eff_hour, np.full(pad_to - len(idx), now, np.int32)])
        sub_slack = np.concatenate(
            [eff_slack, np.zeros(pad_to - len(idx), np.int32)])

        res, state = fr._route_arrays(
            sub, sub_region, sub_hour, ci_fc=fc_k, cap_scale=cap_scale,
            used0=torch.as_tensor(used_committed, device=dev),
            slack_np=sub_slack)

        k = len(idx)
        p_tgt = host(res.target)[:k]
        p_er = host(state.exec_region)[:k]
        p_eh = host(state.exec_hour)[:k]
        p_shed = host(state.shed)[:k]

        # commit: executes within this step, or shed with an expired
        # deadline, or the final step (nothing left to re-plan into)
        commit = (p_eh < now + step_h) | (p_shed & (deadline[idx]
                                                    < now + step_h))
        if last:
            commit = np.ones(k, bool)
        hold = ~commit

        ci = idx[commit]
        done[ci] = True
        tgt[ci] = p_tgt[commit]
        er[ci] = p_er[commit]
        eh[ci] = p_eh[commit]
        shed[ci] = p_shed[commit]

        # consume committed capacity for future plan steps
        live = commit & ~p_shed & routable[idx]
        cells = ((p_eh[live] % W).astype(np.int64) * n_pairs
                 + p_er[live] * N_TARGETS + p_tgt[live])
        np.add.at(used_committed, cells, 1.0)

        steps.append(LedgerStep(
            now=now, planned=int(k), committed=int(commit.sum()),
            held=int(hold.sum()), shed=int((p_shed & commit).sum()),
            trend=np.asarray(trend), cap_scale=np.asarray(scale),
            earned=np.asarray(earned), spent=np.asarray(spent)))

    carbon = _settle_carbon(fr, batch, region_np, er, eh, tgt)
    defer = np.where(shed, 0, eh - arr_hour).astype(np.int32)
    return RollingRouteResult(
        target=tgt, exec_region=er, exec_hour=eh, defer_hours=defer,
        shed=shed, carbon_g=carbon,
        total_carbon_g=float(carbon.sum()),
        routed_carbon_g=float(carbon[~shed].sum()),
        steps=tuple(steps))


def _settle_carbon(fr, batch, home: np.ndarray, er: np.ndarray,
                   eh: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """(N,) float32 gCO2 of each committed (target, region, hour) at ACTUAL
    CI, on ``fr``'s device: the factorized settle, home [mobile, edge_net]
    billed in the home region at the execution hour and [edge_dc,
    core_net, hyper_dc] at the executing region. Returned on the host,
    where callers sum it as the reference does. The reference jits it with
    its per-row buffers donated; eager torch has no donation (N/A)."""
    if len(tgt) == 0:
        return np.zeros(0, np.float32)
    dev = fr.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()
    factors = carbon_model.energy_factors_batch(
        batch.workload(fr.cfg, device=dev), fr.infra, fr._interference,
        fr._net_slowdown)
    actual = fr._ci_table
    home_t, er_t, eh_t = t(home), t(er), t(eh)
    ci_exec = torch.cat([actual[home_t, eh_t][:, :2],
                         actual[er_t, eh_t][:, 2:]], dim=1)
    cf = carbon_model.total_cf_from_factors(factors, ci_exec)
    return take_cols(cf, t(tgt)).cpu().numpy()
