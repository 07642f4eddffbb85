"""Geo-temporal placement: joint (region, tier) decisions under capacity
(port of ``src/repro/serve/placement.py``).

``PlacementPolicy`` scores every (region, tier) pair — the inner policy's
score under each candidate region's CI, times the grid's latency penalty,
masked by its adjacency — and admits requests greedily against
per-(window, region, tier) caps with segment-rank admission: the stream is
sorted by arrival window once (the fleet router's host-side stable sort),
and each round ranks every request within its (window, cell) by one
segmented int32 prefix count. ``adjacency == I`` is tier-only spill and
reproduces ``CapacityLimiter`` bit for bit.

Cross-region admission runs skip-full best-open attempts: the reference's
``lax.while_loop`` becomes a Python loop whose condition is one device-side
``any()`` per round (one host sync); the policy counts its rounds in
``last_rounds``.

Sharded streams (``repro_torch.serve.distributed``): ``axis_name`` is the
``torch.distributed`` process group the segment-sorted stream is sharded
over, contiguously, one shard a rank. Each round lifts the local ranks and
per-cell totals to global ones (``device_prefix_ranks``: one all-gather of
the int32 totals), the loop condition is an all-reduced any
(``_global_any``) so every rank runs the same rounds, and the shed
histogram is summed over the ranks: the decisions are the single-rank
program's, bit for bit. NCCL groups reduce on the card; gloo groups on
the host (the small int32 tensors are copied there and back).

Semantics: each cell has a fresh budget of ``caps[r, t]`` per window;
priority is (round, stream order); a routable request whose every
finite-score pair is full is shed (it keeps its first-choice pair but
consumes no cap); a request with no finite-score pair at all takes the
uncapped fallback on its home region.

Index handling against the reference: indices are int64 here
(``torch.gather`` needs them); a negative index wraps in both packages, and
every gather index is in range by construction — CUDA turns an
out-of-range gather into a device-side assert, where XLA clamps it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import carbon_model
from repro_torch.core.carbon_intensity import CarbonGrid
from repro_torch.core.carbon_model import EnergyFactors, Environment
from repro_torch.core.constants import N_TARGETS
from repro_torch.serve.policy import (
    INF,
    RoutingPolicy,
    _caps_tensor,
    nan_to_inf,
    one_hot_i32,
    prefix_count,
    scores_with_reuse,
    take_cols,
)


@dataclasses.dataclass(frozen=True)
class PlacementState:
    """Threaded state of a ``PlacementPolicy`` decision.

    ``counts`` (R, 3) int32 capacity-admitted assignments per executed
    pair; ``shed`` (N,) bool; ``exec_region`` (N,) int32 executing region
    (home for shed rows), or None under identity adjacency (execution never
    leaves home); ``shed_pair`` (R, 3) int32 shed demand keyed by
    first-choice pair."""

    counts: torch.Tensor
    shed: torch.Tensor
    exec_region: torch.Tensor | None
    shed_pair: torch.Tensor


def windowed_segment_ranks(choice: torch.Tensor, active: torch.Tensor,
                           cell: torch.Tensor, starts: torch.Tensor,
                           ends: torch.Tensor, n_pairs: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment-rank core of one spill round, on a stream already stably
    sorted by admission segment.

    ``choice`` is the in-segment column (width ``n_pairs``), ``cell =
    segment * n_pairs + choice`` the flat capacity cell, ``starts`` /
    ``ends`` the segment boundaries in the sorted stream. Returns
    ``(rank, totals)``, both int32: ``rank[i]`` is the 0-based arrival rank
    of active row i among active rows of its cell, ``totals`` the per-cell
    active count. The prefix counts accumulate per column over the whole
    stream in int32 (``torch.cumsum`` would widen to int64 unless pinned),
    exact up to 2**31 active rows per column per round."""
    act_i = active.to(torch.int32)
    cs = prefix_count(one_hot_i32(choice, n_pairs) * act_i[:, None])

    def prefix(idx):  # cs rows before each index, (W, P)
        idx = idx.long()
        rows = cs[torch.clamp_min(idx - 1, 0)]
        return torch.where((idx > 0)[:, None], rows, torch.zeros_like(rows))

    base = prefix(starts).reshape(-1)  # flat (n_segments * n_pairs,)
    own = take_cols(cs, choice)
    rank = own - act_i - base[cell.long()]
    totals = prefix(ends).reshape(-1) - base
    return rank, totals


def _host_staged(group) -> bool:
    """Whether ``group``'s collectives take host tensors: NCCL reduces on
    the card, gloo on the host."""
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"sharded routing runs over an nccl or a gloo "
                         f"process group, got {backend!r}")
    return backend == "gloo"


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` (equal shapes), stacked in rank
    order, on ``x``'s device."""
    src = x.cpu() if _host_staged(group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size())]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The element-wise sum of ``x`` over the ranks of ``group``."""
    buf = x.to("cpu", copy=True) if _host_staged(group) else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


def device_prefix_ranks(rank: torch.Tensor, totals: torch.Tensor,
                        cell: torch.Tensor, axis_name
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lift one round's local ``(rank, totals)`` to their global values
    over a stream sharded contiguously across the ranks of the process
    group ``axis_name``: every row of an earlier rank precedes every local
    row in stream order, so a row's global rank is its local rank plus the
    earlier ranks' active count in its cell (one all-gather of the totals
    to (D, n_cells), an exclusive cumsum over ranks), and the global
    totals are the column sums. All int32, so exact. ``None`` is the
    single-rank identity."""
    if axis_name is None:
        return rank, totals
    all_totals = all_gather_rows(totals, axis_name)
    prior = (torch.cumsum(all_totals, dim=0, dtype=torch.int32)[
        axis_name.rank()] - totals)
    return (rank + prior[cell.long()],
            all_totals.sum(dim=0, dtype=torch.int32))


def _global_any(pred: torch.Tensor, axis_name) -> bool:
    """``pred.any()`` over every rank of ``axis_name`` as a host bool: the
    admission loops' condition, one host sync per round. The ranks must
    agree on it, or one would leave the loop's collectives while another
    still waits in them."""
    if axis_name is None:
        return bool(pred.any())
    flag = pred.any().to(torch.int32).reshape(1)
    return bool(_all_sum(flag, axis_name).item() > 0)


def _segment_bounds(seg_s: torch.Tensor, n_segments: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Start/end row of every segment in the sorted stream
    (``jnp.searchsorted`` defaults to the left side, as ``right=False``)."""
    starts = torch.searchsorted(
        seg_s, torch.arange(n_segments, device=seg_s.device), right=False)
    ends = torch.cat([starts[1:], starts.new_tensor([seg_s.shape[0]])])
    return starts, ends


def _used_init(used0, size: int, dev) -> torch.Tensor:
    if used0 is None:
        return torch.zeros((size,), dtype=torch.float32, device=dev)
    return torch.as_tensor(used0, dtype=torch.float32, device=dev).reshape(-1)


def _admitted(caps_cell, used, totals):
    """Per-cell admissions of one round: ranks are contiguous per cell, so
    it is min(remaining integral budget, contenders)."""
    return torch.minimum(torch.clamp_min(torch.floor(caps_cell - used), 0.0),
                         totals.to(torch.float32))


@dataclasses.dataclass
class PlacementPolicy(RoutingPolicy):
    """Wrap any policy with joint (region, tier) placement under per-pair
    window caps and cross-region spill (see the module docstring).

    ``caps`` (R, 3) per window (inf = uncapped); ``grid`` the candidate
    regions' CI tables and adjacency / penalty matrices (None: the
    ``FleetRouter`` binds its own); ``n_windows`` None = one per horizon
    hour; ``factorized=False`` forces the legacy per-region sweep."""

    inner: RoutingPolicy
    caps: Any
    grid: CarbonGrid | None = None
    n_windows: int | None = None
    factorized: bool = True

    def __post_init__(self):
        self._caps_host = _caps_tensor(self.caps)
        self._caps = self._caps_host
        self.name = f"placed-{self.inner.name}"
        self._factorizable = (self.factorized
                              and hasattr(self.inner, "scores_from_factors"))
        self._auto_windows = self.n_windows is None
        #: admission rounds (host syncs) of the last ``decide``
        self.last_rounds = 0
        if self.grid is not None:
            self._check_grid(self.grid)

    def _check_grid(self, grid: CarbonGrid) -> None:
        if grid.n_regions != self._caps_host.shape[0]:
            raise ValueError(f"caps cover {self._caps_host.shape[0]} regions, "
                             f"grid has {grid.n_regions}")
        dev = grid.device
        self._caps = self._caps_host.to(dev)
        self._horizon_h = grid.horizon_h
        if self._auto_windows:
            self.n_windows = self._horizon_h
        if self._horizon_h % self.n_windows != 0:
            raise ValueError(
                f"n_windows must divide the grid horizon "
                f"({self._horizon_h} h) so every capacity window covers a "
                f"whole number of hours, got {self.n_windows}")
        adjacency = grid.adjacency.cpu().numpy()
        self._n_rounds = int(adjacency.sum(axis=1).max()) * N_TARGETS
        self._diag_only = bool((adjacency == np.eye(len(adjacency),
                                                    dtype=bool)).all())
        # tier-only requests compete only within their (window, home)
        # segment; cross-region cells mix homes, so sort by window only
        self.stream_order_key = ("window_region" if self._diag_only
                                 else "window")
        self._has_rtt = bool(grid.rtt_s.cpu().numpy().any())
        # Sparse grids: each home's candidate list [home] + neighbours in
        # ascending region order, so argmin tie-breaking over the gathered
        # C = K+1 columns matches the dense program's column order. Pad
        # slots (-1 in nbr_idx) alias the home region (a safe gather) and
        # are masked invalid.
        self._sparse = (grid.nbr_idx is not None) and not self._diag_only
        if self._sparse:
            if not self._factorizable:
                raise ValueError(
                    "sparse neighbor-list grids route through the "
                    "factorized einsum scorer — the inner policy offers no "
                    "scores_from_factors (or factorized=False)")
            r = grid.n_regions
            nbr = grid.nbr_idx.cpu().numpy()
            if nbr.ndim != 2 or nbr.shape[0] != r:
                raise ValueError(f"nbr_idx must be ({r}, K), got {nbr.shape}")
            cand = np.concatenate(
                [np.arange(r, dtype=np.int64)[:, None],
                 np.where(nbr >= 0, nbr.astype(np.int64), r)], axis=1)
            cand.sort(axis=1)  # ascending; pads (value r) land at the end
            valid = cand < r
            rows = np.arange(r)[:, None]
            cand_idx = np.where(valid, cand, rows)
            adj_sparse = np.zeros((r, r), bool)
            adj_sparse[np.repeat(np.arange(r), cand_idx.shape[1]),
                       cand_idx.reshape(-1)] = True
            if not np.array_equal(adj_sparse, adjacency):
                raise ValueError(
                    "grid.nbr_idx disagrees with the dense adjacency — the "
                    "sparse neighbor lists must enumerate exactly the "
                    "off-diagonal True entries of each adjacency row")
            t = lambda a, dt: torch.as_tensor(a.astype(dt), device=dev)
            self._cand_idx = t(cand_idx, np.int64)
            self._cand_ok = t(valid, bool)
            self._cand_pen = t(grid.latency_penalty.cpu().numpy()[
                rows, cand_idx], np.float32)
            self._cand_rtt = t(grid.rtt_s.cpu().numpy()[rows, cand_idx],
                               np.float32)
            self._cand_home_slot = t(np.argmax(cand_idx == rows, axis=1),
                                     np.int64)
            tiers = np.arange(N_TARGETS, dtype=np.int64)
            self._cand_pair = t((cand_idx[:, :, None] * N_TARGETS
                                 + tiers).reshape(r, -1), np.int64)
        if not self._diag_only and not self._factorizable and self._has_rtt:
            raise ValueError(
                "grid has a non-zero rtt_s but the inner policy offers no "
                "scores_from_factors (or factorized=False) — the WAN-hop "
                "QoS check needs the factorized evaluator")

    @property
    def wants_factors(self) -> bool:
        """Ask the fleet router for a precomputed ``EnergyFactors`` batch
        (tier-only placement reuses the router's Table-1 outputs)."""
        return self._factorizable and not getattr(self, "_diag_only", True)

    def bind_grid(self, grid: CarbonGrid) -> None:
        """Adopt the fleet's grid, or verify an explicit one matches it."""
        if self.grid is None:
            self._check_grid(grid)
            self.grid = grid
            return
        self._check_grid(self.grid)
        if self.grid is grid:
            return
        for field in ("ci_hourly", "ci_mobile", "ci_core", "pue",
                      "adjacency", "latency_penalty", "rtt_s",
                      "ci_forecast", "forecast_sigma_h",
                      "nbr_idx", "nbr_rtt_s"):
            a, b = getattr(self.grid, field), getattr(grid, field)
            host = lambda x: x.cpu().numpy() if isinstance(
                x, torch.Tensor) else np.asarray(x)
            same = ((a is None) == (b is None)) and (
                a is None or np.array_equal(host(a), host(b)))
            if not same:
                raise ValueError(
                    f"policy grid disagrees with the router's grid on "
                    f"{field!r} — pass the same CarbonGrid to both (or "
                    f"leave the policy's grid unset to adopt the "
                    f"router's)")

    def initial_state(self, n_regions: int, n_requests: int) -> PlacementState:
        if self._caps.shape[0] != n_regions:
            raise ValueError(f"caps cover {self._caps.shape[0]} regions, "
                             f"fleet has {n_regions}")
        if self.grid is None:
            raise ValueError(
                "PlacementPolicy has no CarbonGrid — pass grid= at "
                "construction or route via a FleetRouter (which binds its "
                "own grid)")
        dev = self.grid.device
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        return PlacementState(
            counts=zeros((n_regions, N_TARGETS), torch.int32),
            shed=zeros((n_requests,), torch.bool),
            exec_region=(None if self._diag_only
                         else zeros((n_requests,), torch.int32)),
            shed_pair=zeros((n_regions, N_TARGETS), torch.int32))

    def scores(self, w, env, avail, *, hour=None):
        return self.inner.scores(w, env, avail, hour=hour)

    def pair_scores(self, w, env, avail, home, hour) -> torch.Tensor:
        """(N, R, 3) effective scores of every (region, tier) pair by the
        legacy sweep: the inner score under each candidate region's CI
        (home [mobile, edge_net] mixed with the candidate's [edge_dc,
        core_net, hyper_dc]), penalized and masked."""
        table = self.grid.table_forecast  # (R, H, 5)
        hr = hour.long() % table.shape[1]
        home_ci = env.ci
        cols = []
        for r in range(table.shape[0]):
            ci_mixed = torch.cat([home_ci[:, :2], table[r, hr, 2:]], dim=1)
            env_r = Environment(ci=ci_mixed, interference=env.interference,
                                net_slowdown=env.net_slowdown)
            cols.append(self.inner.scores(w, env_r, avail, hour=hour))
        return self._mask_pairs(torch.stack(cols, dim=1), home)

    def _mask_pairs(self, s: torch.Tensor, home: torch.Tensor
                    ) -> torch.Tensor:
        """Latency penalty (sign-aware: ``s * pen`` for s >= 0, ``s / pen``
        otherwise), +inf where not adjacent and at remote MOBILE pairs."""
        pen = self.grid.latency_penalty[home][:, :, None]  # (N, R, 1)
        adj = self.grid.adjacency[home]  # (N, R)
        n_regions = self._caps.shape[0]
        dev = s.device
        remote = (torch.arange(n_regions, device=dev)[None, :]
                  != home[:, None])
        mobile = (torch.arange(N_TARGETS, device=dev) == 0)[None, None, :]
        allowed = adj[:, :, None] & ~(remote[:, :, None] & mobile)
        penalized = torch.where(s >= 0.0, s * pen, s / pen)
        return torch.where(allowed, penalized, torch.full_like(s, INF))

    def pair_scores_from_factors(self, factors: EnergyFactors, w, env, avail,
                                 home, hour, fc_table=None) -> torch.Tensor:
        """``pair_scores`` on the factorized evaluator plus the WAN hop
        ``rtt_s[home, r']`` in each candidate's QoS check."""
        table = self.grid.table_forecast if fc_table is None else fc_table
        ci_dc = table[:, hour.long() % table.shape[1], 2:]  # (R, N, 3)
        extra = None if not self._has_rtt else self.grid.rtt_s.T[:, home]
        s = self._inner_pair_scores(factors, w, env.ci, ci_dc, avail, extra,
                                    hour=hour,
                                    interference=env.interference,
                                    net_slowdown=env.net_slowdown)
        return self._mask_pairs(s.transpose(0, 1), home)

    def _inner_pair_scores(self, factors, w, home_ci, cand_ci_dc, avail,
                           extra, *, hour=None, interference=None,
                           net_slowdown=None) -> torch.Tensor:
        """(C, N, 3) candidate scores via the inner policy's vectorized
        ``pair_scores_from_factors``, else one ``scores_from_factors`` per
        candidate."""
        vectorized = getattr(self.inner, "pair_scores_from_factors", None)
        if vectorized is not None:
            return vectorized(factors, w, home_ci, cand_ci_dc, avail,
                              extra_latency=extra, hour=hour,
                              interference=interference,
                              net_slowdown=net_slowdown)
        if extra is None:
            extra = torch.zeros(cand_ci_dc.shape[:2], dtype=torch.float32,
                                device=cand_ci_dc.device)
        return torch.stack([
            self.inner.scores_from_factors(
                factors, w, torch.cat([home_ci[:, :2], ci_rows], dim=1),
                avail, extra_latency=ex, hour=hour,
                interference=interference, net_slowdown=net_slowdown)
            for ci_rows, ex in zip(cand_ci_dc, extra)])

    def sparse_pair_scores_from_factors(self, factors, w, env, avail, home,
                                        hour, fc_table=None) -> torch.Tensor:
        """(N, C, 3) scores over each request's C = K+1 candidate sites
        (home plus sparse neighbours, ascending): O(N·K) scoring, each
        candidate row arithmetic-identical to the dense row."""
        table = self.grid.table_forecast if fc_table is None else fc_table
        h = table.shape[1]
        cand_r = self._cand_idx[home]  # (N, C)
        ci_dc = table[cand_r, (hour.long() % h)[:, None], 2:]  # (N, C, 3)
        extra = None if not self._has_rtt else self._cand_rtt[home].T
        s = self._inner_pair_scores(factors, w, env.ci,
                                    ci_dc.transpose(0, 1), avail, extra,
                                    hour=hour,
                                    interference=env.interference,
                                    net_slowdown=env.net_slowdown)
        return self._mask_sparse(s.transpose(0, 1), home, cand_r)

    def _mask_sparse(self, s, home, cand_r) -> torch.Tensor:
        """``_mask_pairs`` on the gathered candidate axis: +inf at pad
        slots and remote MOBILE columns, the same sign-aware penalty."""
        pen = self._cand_pen[home][:, :, None]  # (N, C, 1)
        ok = self._cand_ok[home]  # (N, C)
        mobile = (torch.arange(N_TARGETS, device=s.device) == 0)[None, None]
        remote = cand_r != home[:, None]
        allowed = ok[:, :, None] & ~(remote[:, :, None] & mobile)
        penalized = torch.where(s >= 0.0, s * pen, s / pen)
        return torch.where(allowed, penalized, torch.full_like(s, INF))

    def _use_factors(self, factors) -> bool:
        return self._factorizable and (
            factors is not None
            or getattr(self.inner, "infra", None) is not None)

    def _factors(self, factors, w, env):
        if factors is None:
            factors = carbon_model.energy_factors_batch(
                w, self.inner.infra, env.interference, env.net_slowdown)
        return factors

    def _to_stream_order(self, n, win, home, order, inv_order):
        """The host-provided stream-order hint (or a stable device argsort)
        and its inverse permutation."""
        n_regions = self._caps.shape[0]
        dev = win.device
        if order is None:
            key = win * n_regions + home if self._diag_only else win
            order = torch.argsort(key, stable=True)
            inv_order = None
        else:
            order = torch.as_tensor(order, device=dev).long()
        if inv_order is None:
            inv = torch.empty_like(order)
            inv[order] = torch.arange(n, device=dev)
        else:
            inv = torch.as_tensor(inv_order, device=dev).long()
        return order, inv

    def _caps_runtime(self, cap_scale) -> torch.Tensor:
        """(R, 3) effective caps: the configured caps scaled by an (R,) or
        (R, 3) ``cap_scale`` (None = the configured caps, bit for bit)."""
        if cap_scale is None:
            return self._caps
        cs = torch.as_tensor(cap_scale, dtype=torch.float32,
                             device=self._caps.device)
        return self._caps * (cs[:, None] if cs.ndim == 1 else cs)

    def _arrival(self, w, region, hour):
        n = w.flops.shape[0]
        dev = w.flops.device
        home = (torch.zeros((n,), dtype=torch.long, device=dev)
                if region is None
                else torch.as_tensor(region, device=dev).long())
        hr = (torch.zeros((n,), dtype=torch.long, device=dev) if hour is None
              else torch.as_tensor(hour, device=dev).to(torch.int32).long())
        return home, hr

    def decide(self, w, env, avail, state, *, region=None, hour=None,
               outputs=None, order=None, inv_order=None, slack=None,
               factors=None, fc_table=None, cap_scale=None, used0=None,
               axis_name=None):
        """(N,) int32 tier targets + ``PlacementState`` under segment-rank
        (region, tier) admission. ``axis_name`` (a process group) shards
        the admission; a sharded caller gives every rank at least one row,
        since an early return here would skip the ranks' collectives."""
        n = w.flops.shape[0]
        n_pairs = self._caps.numel()
        self.last_rounds = 0
        if n == 0:
            return torch.zeros((0,), dtype=torch.int32,
                               device=w.flops.device), state
        home, hr = self._arrival(w, region, hour)
        win = hr % self.n_windows
        order, inv = self._to_stream_order(n, win, home, order, inv_order)
        caps_rt = self._caps_runtime(cap_scale)
        if self._diag_only:
            # tier-only: the home region is the only candidate, and the
            # diagonal penalty (1.0) never reorders a row
            s = scores_with_reuse(self.inner, w, env, avail, hour, outputs)
            return self._decide_diag(nan_to_inf(s), win, home, order, inv,
                                     state, caps_rt, used0, axis_name)
        if self._sparse:
            if not self._use_factors(factors):
                raise ValueError(
                    "sparse neighbor-list grids need EnergyFactors — route "
                    "via a FleetRouter (which precomputes them) or give "
                    "the inner policy an infra")
            s = self.sparse_pair_scores_from_factors(
                self._factors(factors, w, env), w, env, avail, home, hr,
                fc_table=fc_table).reshape(n, -1)
            return self._decide_cross(nan_to_inf(s), win, home, order, inv,
                                      state, caps_rt, used0, axis_name,
                                      cand_pair=self._cand_pair)
        if self._use_factors(factors):
            s = self.pair_scores_from_factors(
                self._factors(factors, w, env), w, env, avail, home, hr,
                fc_table=fc_table).reshape(n, n_pairs)
            return self._decide_cross(nan_to_inf(s), win, home, order, inv,
                                      state, caps_rt, used0, axis_name)
        if self._has_rtt:
            raise ValueError(
                "grid has a non-zero rtt_s but no EnergyFactors are "
                "available for the WAN-hop QoS gate — route via a "
                "FleetRouter (which precomputes factors) or give the "
                "inner policy an infra")
        s = self.pair_scores(w, env, avail, home, hr).reshape(n, n_pairs)
        return self._decide_cross_legacy(nan_to_inf(s), win, home, order,
                                         inv, state, caps_rt, used0,
                                         axis_name)

    def _decide_diag(self, s, win, home, order, inv, state, caps_rt,
                     used0=None, axis_name=None):
        """Tier-only admission: 3 spill rounds down each request's
        preference list within its (window, home) segment of width 3."""
        n = s.shape[0]
        dev = s.device
        n_regions, n_pairs = self._caps.shape[0], self._caps.numel()
        win_s, home_s, s_s = win[order], home[order], s[order]
        # stable argsort breaks score ties by tier index
        pref_s = torch.argsort(s_s, dim=1, stable=True)
        valid_s = torch.isfinite(torch.gather(s_s, 1, pref_s))
        width = N_TARGETS
        seg_s = win_s * n_regions + home_s
        starts, ends = _segment_bounds(seg_s, self.n_windows * n_regions)
        col_base_s = home_s * N_TARGETS
        caps_flat = caps_rt.reshape(-1)
        caps_cell = caps_flat.repeat(self.n_windows)

        used_init = _used_init(used0, self.n_windows * n_pairs, dev)
        used = used_init
        placed = torch.zeros((n,), dtype=torch.bool, device=dev)
        exec_pair = torch.zeros((n,), dtype=torch.long, device=dev)
        for k in range(N_TARGETS):
            choice = pref_s[:, k]
            active = valid_s[:, k] & ~placed
            col = col_base_s + choice
            cell = seg_s * width + choice  # == win * n_pairs + col
            rank, totals = device_prefix_ranks(*windowed_segment_ranks(
                choice, active, cell, starts, ends, width), cell, axis_name)
            # 1-based rank vs <= cap: fractional caps admit floor(cap)
            fits = active & (used[cell] + rank + 1.0 <= caps_flat[col])
            exec_pair = torch.where(fits, col, exec_pair)
            placed = placed | fits
            used = used + _admitted(caps_cell, used, totals)
        self.last_rounds = N_TARGETS

        shed_s = valid_s[:, 0] & ~placed
        first_col_s = col_base_s + pref_s[:, 0]
        fb_pair = torch.where(valid_s[:, 0], first_col_s,
                              col_base_s + torch.argmin(s_s, dim=1))
        exec_pair = torch.where(placed, exec_pair, fb_pair)
        counts = (used - used_init).reshape(
            self.n_windows, n_regions, N_TARGETS).sum(dim=0)
        return (exec_pair % N_TARGETS).to(torch.int32)[inv], PlacementState(
            counts=state.counts + counts.to(torch.int32),
            shed=shed_s[inv],
            exec_region=None,
            shed_pair=state.shed_pair + _shed_pair(first_col_s, shed_s,
                                                   n_regions, axis_name))

    def _decide_cross(self, s, win, home, order, inv, state, caps_rt,
                      used0=None, axis_name=None, cand_pair=None):
        """Cross-region admission by skip-full best-open attempts: each
        round every unplaced request targets its best candidate whose cell
        still has budget (a masked argmin) and competes by stream order; a
        rejected request's cell is full afterwards, so the loop ends with
        exhaustive shed semantics. ``cand_pair`` (R, C*3) maps a sparse
        grid's local columns to global pairs (None = dense)."""
        n = s.shape[0]
        dev = s.device
        n_pairs = self._caps.numel()
        W = self.n_windows
        win_s, home_s, s_s = win[order], home[order], s[order]
        finite_s = torch.isfinite(s_s)
        routable = finite_s.any(dim=1)
        col_pair_s = None if cand_pair is None else cand_pair[home_s]
        to_pair = (lambda col: col if col_pair_s is None
                   else take_cols(col_pair_s, col))
        first_col = to_pair(torch.argmin(s_s, dim=1))
        home_row_s = None
        if col_pair_s is not None:
            c = s_s.shape[1] // N_TARGETS
            home_row_s = s_s.reshape(n, c, N_TARGETS)[
                torch.arange(n, device=dev), self._cand_home_slot[home_s]]
        seg_s = win_s
        starts, ends = _segment_bounds(seg_s, W)
        caps_flat = caps_rt.reshape(-1)
        caps_cell = caps_flat.repeat(W)
        limit = W * n_pairs + 1  # closable cells + 1
        inf = torch.full_like(s_s, INF)

        def open_mask(used, placed):
            open_flat = torch.floor(caps_cell - used) >= 1.0
            if col_pair_s is None:
                open_s = open_flat.reshape(W, n_pairs)[win_s]
            else:
                open_s = open_flat[win_s[:, None] * n_pairs + col_pair_s]
            return open_s & finite_s & ~placed[:, None]

        used_init = _used_init(used0, W * n_pairs, dev)
        used = used_init
        placed = torch.zeros((n,), dtype=torch.bool, device=dev)
        exec_pair = torch.zeros((n,), dtype=torch.long, device=dev)
        mask = open_mask(used, placed)
        rounds = 0
        while rounds < limit and _global_any(mask, axis_name):
            active = mask.any(dim=1)
            choice = to_pair(torch.argmin(torch.where(mask, s_s, inf), dim=1))
            cell = seg_s * n_pairs + choice
            rank, totals = device_prefix_ranks(*windowed_segment_ranks(
                choice, active, cell, starts, ends, n_pairs), cell, axis_name)
            fits = active & (used[cell] + rank + 1.0 <= caps_flat[choice])
            exec_pair = torch.where(fits, choice, exec_pair)
            placed = placed | fits
            used = used + _admitted(caps_cell, used, totals)
            mask = open_mask(used, placed)
            rounds += 1
        self.last_rounds = rounds
        return self._finalize_cross(s_s, home_s, routable, first_col,
                                    placed, exec_pair, used, inv, state,
                                    used_init, axis_name,
                                    home_row_s=home_row_s)

    def _finalize_cross(self, s_s, home_s, routable, first_col, placed,
                        exec_pair, used, inv, state, used_init,
                        axis_name=None, home_row_s=None):
        """Shed / fallback and back to stream order, shared by both
        cross-region programs. A request with no finite-score pair takes
        the uncapped fallback on its home region (argmin of an all-inf row
        is MOBILE, as the uncapped router gives)."""
        n = s_s.shape[0]
        n_regions = self._caps.shape[0]
        shed_s = routable & ~placed
        if home_row_s is None:
            home_row_s = s_s.reshape(n, n_regions, N_TARGETS)[
                torch.arange(n, device=s_s.device), home_s]
        fb_pair = torch.where(routable, first_col,
                              home_s * N_TARGETS
                              + torch.argmin(home_row_s, dim=1))
        exec_pair = torch.where(placed, exec_pair, fb_pair)
        # a shed request executes nowhere: it reports its HOME region
        exec_region = torch.where(shed_s, home_s, exec_pair // N_TARGETS)
        counts = (used - used_init).reshape(
            self.n_windows, n_regions, N_TARGETS).sum(dim=0)
        return (exec_pair % N_TARGETS).to(torch.int32)[inv], PlacementState(
            counts=state.counts + counts.to(torch.int32),
            shed=shed_s[inv],
            exec_region=exec_region.to(torch.int32)[inv],
            shed_pair=state.shed_pair + _shed_pair(first_col, shed_s,
                                                   n_regions, axis_name))

    def _decide_cross_legacy(self, s, win, home, order, inv, state, caps_rt,
                             used0=None, axis_name=None):
        """The legacy cross-region admission for inner policies without a
        factorized scorer: best-first preference by a stable (N, pairs)
        argsort, then ``adjacency degree x 3`` fixed spill rounds."""
        n = s.shape[0]
        dev = s.device
        n_pairs = self._caps.numel()
        W = self.n_windows
        win_s, home_s, s_s = win[order], home[order], s[order]
        pref_s = torch.argsort(s_s, dim=1, stable=True)
        valid_s = torch.isfinite(torch.gather(s_s, 1, pref_s))
        seg_s = win_s
        starts, ends = _segment_bounds(seg_s, W)
        caps_flat = caps_rt.reshape(-1)
        caps_cell = caps_flat.repeat(W)

        used_init = _used_init(used0, W * n_pairs, dev)
        used = used_init
        placed = torch.zeros((n,), dtype=torch.bool, device=dev)
        exec_pair = torch.zeros((n,), dtype=torch.long, device=dev)
        rounds = min(self._n_rounds, n_pairs)
        for k in range(rounds):
            choice = pref_s[:, k]
            active = valid_s[:, k] & ~placed
            cell = seg_s * n_pairs + choice
            rank, totals = device_prefix_ranks(*windowed_segment_ranks(
                choice, active, cell, starts, ends, n_pairs), cell, axis_name)
            fits = active & (used[cell] + rank + 1.0 <= caps_flat[choice])
            exec_pair = torch.where(fits, choice, exec_pair)
            placed = placed | fits
            used = used + _admitted(caps_cell, used, totals)
        self.last_rounds = rounds
        return self._finalize_cross(s_s, home_s, valid_s[:, 0], pref_s[:, 0],
                                    placed, exec_pair, used, inv, state,
                                    used_init, axis_name)


def _shed_pair(first_col, shed, n_regions: int, axis_name=None
               ) -> torch.Tensor:
    """(R, 3) int32 histogram of the shed rows' first-choice pairs, summed
    over the ranks of ``axis_name`` when sharded."""
    counts = torch.bincount(first_col[shed], minlength=n_regions * N_TARGETS)
    counts = counts.to(torch.int32).reshape(n_regions, N_TARGETS)
    return counts if axis_name is None else _all_sum(counts, axis_name)
