"""Temporal deferral: time-shifted (region, tier, hour) placement (port of
``src/repro/serve/temporal.py``).

``TemporalPolicy`` scores every (defer d, region r', tier t) candidate — the
inner policy's factorized score under region r''s CI at hour ``arrival +
d`` (home device/access-network components billed at the home region, same
hour), times the latency penalty, with the WAN hop in the QoS check — and
admits greedily against per-(window, region, tier) caps. Admission reuses
the segment-rank machinery with a per-round prior-count matrix for the
cross-window contention of deferred candidates. The reference's
``lax.while_loop`` becomes a Python loop with one device-side ``any()`` per
round; ``last_rounds`` counts them. A sharded stream (``axis_name``, a
process group) reconciles its ranks through the placement module's hooks,
before the cross-window shift, so the shift sees the fleet-wide totals.

The horizon does not wrap: candidate hours past the grid's last hour are
refused. Zero slack reproduces ``PlacementPolicy`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import carbon_model
from repro_torch.core.constants import HOURS_PER_DAY, N_TARGETS
from repro_torch.serve.placement import (
    PlacementPolicy,
    _admitted,
    _segment_bounds,
    _shed_pair,
    _global_any,
    _used_init,
    device_prefix_ranks,
    windowed_segment_ranks,
)
from repro_torch.serve.policy import INF, nan_to_inf, take_cols


@dataclasses.dataclass(frozen=True)
class TemporalState:
    """Threaded state of a ``TemporalPolicy`` decision: the placement fields
    plus ``exec_hour`` (N,) int32 absolute execution hour and
    ``defer_hours`` (N,) int32 hours deferred past arrival."""

    counts: torch.Tensor
    shed: torch.Tensor
    exec_region: torch.Tensor
    shed_pair: torch.Tensor
    exec_hour: torch.Tensor
    defer_hours: torch.Tensor


@dataclasses.dataclass
class TemporalPolicy(PlacementPolicy):
    """Joint (region, tier, hour) placement under per-cell caps.

    ``max_defer_h`` bounds the candidate enumeration (< ``n_windows``);
    per-request ``slack`` is clipped to it. ``risk_lambda`` inflates the
    forecast-driven CI of a candidate ``d`` hours out by ``1 + risk_lambda *
    forecast_sigma_h * sqrt(d)`` (0 = the error-blind scores, bit for
    bit)."""

    max_defer_h: int = 12
    risk_lambda: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        self.name = f"temporal-{self.inner.name}"
        if not self._factorizable:
            raise ValueError(
                "TemporalPolicy scores candidate hours via the factorized "
                "evaluator — the inner policy must expose "
                "scores_from_factors (OraclePolicy does) and factorized "
                "must stay True")
        if self.n_windows is not None:
            self._check_windows(self.n_windows)

    def _check_windows(self, n_windows: int) -> None:
        if (HOURS_PER_DAY % n_windows != 0
                and n_windows % HOURS_PER_DAY != 0):
            raise ValueError(
                f"n_windows must divide {HOURS_PER_DAY} (sub-daily "
                f"windows) or be a multiple of it (multi-day horizons) so "
                f"deferred hours map consistently onto capacity windows, "
                f"got {n_windows}")
        if not 0 <= self.max_defer_h < n_windows:
            raise ValueError(
                f"max_defer_h must be in [0, n_windows), got "
                f"{self.max_defer_h} with n_windows={n_windows}")

    def _check_grid(self, grid) -> None:
        super()._check_grid(grid)
        self._check_windows(self.n_windows)

    @property
    def wants_factors(self) -> bool:
        return True

    def initial_state(self, n_regions: int, n_requests: int) -> TemporalState:
        base = super().initial_state(n_regions, n_requests)
        zeros = torch.zeros((n_requests,), dtype=torch.int32,
                            device=base.counts.device)
        return TemporalState(counts=base.counts, shed=base.shed,
                             exec_region=zeros, shed_pair=base.shed_pair,
                             exec_hour=zeros.clone(),
                             defer_hours=zeros.clone())

    def candidate_scores(self, factors, w, env, avail, home, hr,
                         fc_table=None) -> torch.Tensor:
        """Scores of every (defer[, region], tier) candidate: (S+1, N, R, 3)
        with cross-region spill, (S+1, N, C, 3) on a sparse grid,
        (S+1, N, 3) tier-only. Execution hours past the horizon's last hour
        are clamped here only to keep the gathers in range (a CUDA gather
        out of range is a device assert); ``decide`` masks them out."""
        table = (self.grid.table_forecast if fc_table is None
                 else fc_table)  # (R, H, 5)
        table_dc = table[..., 2:]
        sparse = self._sparse
        cand_r = self._cand_idx[home] if sparse else None  # (N, C)
        extra = (None if not self._has_rtt else
                 (self._cand_rtt[home].T if sparse
                  else self.grid.rtt_s.T[:, home]))
        ctx = dict(interference=env.interference,
                   net_slowdown=env.net_slowdown)
        sigma = float(self.grid.forecast_sigma_h)
        lam = float(self.risk_lambda)
        risky = sigma > 0.0 and lam != 0.0
        S = self.max_defer_h
        rscales = carbon_model.forecast_risk_scale(
            torch.arange(S + 1, dtype=torch.float32), sigma, lam)

        def scores_at(he_d, rscale):
            home_ci = table[home, he_d]  # (N, 5)
            if self._diag_only:
                ci_dc = table_dc[home, he_d][None]  # (1, N, 3)
                if risky:
                    home_ci, ci_dc = carbon_model.inflate_ci_risk(
                        home_ci, ci_dc, rscale)
                return self._inner_pair_scores(factors, w, home_ci, ci_dc,
                                               avail, None, hour=he_d,
                                               **ctx)[0]
            if sparse:
                ci_dc = table_dc[cand_r, he_d[:, None]].transpose(0, 1)
                if risky:
                    home_ci, ci_dc = carbon_model.inflate_ci_risk(
                        home_ci, ci_dc, rscale)
                s = self._inner_pair_scores(factors, w, home_ci, ci_dc,
                                            avail, extra, hour=he_d, **ctx)
                return self._mask_sparse(s.transpose(0, 1), home, cand_r)
            ci_dc = table_dc[:, he_d, :]  # (R, N, 3)
            if risky:
                home_ci, ci_dc = carbon_model.inflate_ci_risk(
                    home_ci, ci_dc, rscale)
            s = self._inner_pair_scores(factors, w, home_ci, ci_dc, avail,
                                        extra, hour=he_d, **ctx)
            return self._mask_pairs(s.transpose(0, 1), home)

        return torch.stack([
            scores_at(torch.clamp(hr + d, 0, self._horizon_h - 1),
                      rscales[d]) for d in range(S + 1)])

    def decide(self, w, env, avail, state, *, region=None, hour=None,
               outputs=None, order=None, inv_order=None, slack=None,
               factors=None, fc_table=None, cap_scale=None, used0=None,
               axis_name=None):
        """(N,) int32 tier targets + ``TemporalState`` under joint (defer,
        region, tier) admission; ``axis_name`` as in
        ``PlacementPolicy.decide``."""
        n = w.flops.shape[0]
        dev = w.flops.device
        n_regions, n_pairs = self._caps.shape[0], self._caps.numel()
        self.last_rounds = 0
        if n == 0:
            return torch.zeros((0,), dtype=torch.int32, device=dev), state
        home, hr = self._arrival(w, region, hour)
        W, S = self.n_windows, self.max_defer_h
        win = hr % W
        slack_w = (torch.zeros((n,), dtype=torch.long, device=dev)
                   if slack is None else torch.clamp(
                       torch.as_tensor(slack, device=dev).to(torch.int32)
                       .long(), 0, S))
        if factors is None:
            infra = getattr(self.inner, "infra", None)
            if infra is None:
                raise ValueError(
                    "TemporalPolicy needs an EnergyFactors batch: route via "
                    "a FleetRouter or give the inner policy an infra")
            factors = carbon_model.energy_factors_batch(
                w, infra, env.interference, env.net_slowdown)

        s_all = self.candidate_scores(factors, w, env, avail, home, hr,
                                      fc_table=fc_table)
        # within slack AND inside the horizon (the non-wrapping tail)
        d_idx = torch.arange(S + 1, device=dev)[:, None]
        d_ok = (d_idx <= slack_w[None, :]) & (hr[None, :] + d_idx
                                              < self._horizon_h)
        sparse = self._sparse
        if self._diag_only:
            sub_p = N_TARGETS
            d_ok = d_ok[:, :, None]
        else:
            sub_p = self._cand_pair.shape[1] if sparse else n_pairs
            d_ok = d_ok[:, :, None, None]
        s_all = torch.where(d_ok, nan_to_inf(s_all),
                            torch.full_like(s_all, INF))
        width = (S + 1) * sub_p
        s = s_all.transpose(0, 1).reshape(n, width)
        del s_all

        order, inv = self._to_stream_order(n, win, home, order, inv_order)
        win_s, home_s, hr_s, s_s = win[order], home[order], hr[order], \
            s[order]
        cand_pair_s = self._cand_pair[home_s] if sparse else None
        finite_s = torch.isfinite(s_s)
        routable = finite_s.any(dim=1)
        # ties break by column: earlier execution, then region, then tier
        col0 = torch.argmin(s_s, dim=1)
        if self._diag_only:
            seg_s = win_s * n_regions + home_s
            n_segments = W * n_regions
        else:
            seg_s = win_s
            n_segments = W
        starts, ends = _segment_bounds(seg_s, n_segments)
        caps_rt = self._caps_runtime(cap_scale)
        caps_flat = caps_rt.reshape(-1)
        caps_cell = caps_flat.repeat(W)
        limit = W * n_pairs + 1

        # d_map[s, e]: the defer an arrival in window s needs to execute in
        # window e; valid_map masks defers beyond S (S < W, so injective)
        s_idx = torch.arange(W, device=dev)
        d_map = (s_idx[None, :] - s_idx[:, None]) % W
        valid_map = (d_map <= S).to(torch.int32)
        # XLA clamps the out-of-range defers of d_map in its gather; CUDA
        # would assert, so clamp them here before valid_map zeroes them
        d_take = torch.clamp(d_map, max=S)
        d_ar = torch.arange(S + 1, device=dev)
        shift_idx = (s_idx[:, None] + d_ar[None, :]) % W  # (W, S+1)
        inf = torch.full_like(s_s, INF)

        def open_mask(used, placed):
            open_w = (torch.floor(caps_cell - used) >= 1.0).reshape(
                W, n_pairs)
            shifted_w = open_w[shift_idx]  # (W, S+1, pairs)
            if self._diag_only:
                look = shifted_w.reshape(W, S + 1, n_regions, N_TARGETS)
                rows = look[win_s, :, home_s, :].reshape(n, width)
            elif sparse:
                rows = shifted_w[win_s[:, None, None], d_ar[None, :, None],
                                 cand_pair_s[:, None, :]].reshape(n, width)
            else:
                rows = shifted_w[win_s].reshape(n, width)
            return rows & finite_s & ~placed[:, None]

        used_init = _used_init(used0, W * n_pairs, dev)
        used = used_init
        placed = torch.zeros((n,), dtype=torch.bool, device=dev)
        exec_pair = torch.zeros((n,), dtype=torch.long, device=dev)
        exec_d = torch.zeros((n,), dtype=torch.long, device=dev)
        mask = open_mask(used, placed)
        rounds = 0
        while rounds < limit and _global_any(mask, axis_name):
            active = mask.any(dim=1)
            choice = torch.argmin(torch.where(mask, s_s, inf), dim=1)
            d = choice // sub_p
            sub = choice % sub_p
            if self._diag_only:
                pair = home_s * N_TARGETS + sub
                local_cell = seg_s * width + choice
                rank_w, totals = windowed_segment_ranks(
                    choice, active, local_cell, starts, ends, width)
            else:
                # rank on the dense-equivalent (defer, global pair) column
                pair = sub if cand_pair_s is None else take_cols(
                    cand_pair_s, sub)
                rank_col = d * n_pairs + pair
                rank_width = (S + 1) * n_pairs
                local_cell = seg_s * rank_width + rank_col
                rank_w, totals = windowed_segment_ranks(
                    rank_col, active, local_cell, starts, ends, rank_width)
            rank_w, totals = device_prefix_ranks(rank_w, totals, local_cell,
                                                 axis_name)
            e = (win_s + d) % W
            cell = e * n_pairs + pair
            # shift each arrival window's per-(defer, column) totals onto
            # their execution cells and prefix-sum over arrival windows: a
            # row's rank = its within-window rank + earlier windows'
            # contenders for the same cell (int32 throughout)
            if self._diag_only:
                t4 = totals.reshape(W, n_regions, S + 1, N_TARGETS)
                t4 = t4.permute(0, 2, 1, 3)  # (W, S+1, R, 3)
                shifted = (t4[s_idx[:, None], d_take]
                           * valid_map[:, :, None, None])  # [s, e, r, t]
                prior = torch.cumsum(shifted, dim=0,
                                     dtype=torch.int32) - shifted
                prior_i = prior.reshape(W, W * n_pairs)[win_s, cell]
            else:
                t3 = totals.reshape(W, S + 1, n_pairs)
                shifted = (t3[s_idx[:, None], d_take]
                           * valid_map[:, :, None])  # [s, e, pair]
                prior = torch.cumsum(shifted, dim=0,
                                     dtype=torch.int32) - shifted
                prior_i = prior.reshape(W, W * n_pairs)[seg_s, cell]
            totals_cell = shifted.sum(dim=0).reshape(-1)
            rank = rank_w + prior_i
            fits = active & (used[cell] + rank + 1.0 <= caps_flat[pair])
            exec_pair = torch.where(fits, pair, exec_pair)
            exec_d = torch.where(fits, d, exec_d)
            placed = placed | fits
            used = used + _admitted(caps_cell, used, totals_cell)
            mask = open_mask(used, placed)
            rounds += 1
        self.last_rounds = rounds

        # --- shed / unroutable fallback (PlacementPolicy semantics) -------
        shed_s = routable & ~placed
        rows = torch.arange(n, device=dev)
        if self._diag_only:
            pair0 = home_s * N_TARGETS + col0 % sub_p
            home_row_s = s_s.reshape(n, S + 1, N_TARGETS)[:, 0]
        elif sparse:
            pair0 = take_cols(cand_pair_s, col0 % sub_p)
            home_row_s = s_s.reshape(n, S + 1, sub_p // N_TARGETS,
                                     N_TARGETS)[:, 0][
                rows, self._cand_home_slot[home_s]]
        else:
            pair0 = col0 % sub_p
            home_row_s = s_s.reshape(n, S + 1, n_regions, N_TARGETS)[:, 0][
                rows, home_s]
        fb_pair = torch.where(routable, pair0,
                              home_s * N_TARGETS
                              + torch.argmin(home_row_s, dim=1))
        exec_pair = torch.where(placed, exec_pair, fb_pair)
        exec_d = torch.where(placed, exec_d, torch.zeros_like(exec_d))

        exec_region = torch.where(shed_s, home_s, exec_pair // N_TARGETS)
        counts = (used - used_init).reshape(
            W, n_regions, N_TARGETS).sum(dim=0)
        i32 = lambda x: x.to(torch.int32)[inv]
        return i32(exec_pair % N_TARGETS), TemporalState(
            counts=state.counts + counts.to(torch.int32),
            shed=shed_s[inv],
            exec_region=i32(exec_region),
            shed_pair=state.shed_pair + _shed_pair(pair0, shed_s, n_regions,
                                                   axis_name),
            # admitted candidates satisfy hr + d < horizon: no modulo
            exec_hour=i32(hr_s + exec_d),
            defer_hours=i32(exec_d))
