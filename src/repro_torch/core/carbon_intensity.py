"""Time-varying carbon intensity (paper §3.2, Fig 4): hourly grid traces and
the device-battery CI under a charging behaviour.

Port of ``Grid``, ``ChargingBehavior``, the numpy mix builders,
``GridTrace``, ``grid_trace``, ``all_grid_traces``, ``charging_profile``,
``mobile_carbon_intensity``, ``RegionSpec``, ``DEFAULT_REGIONS``,
``region_power_budgets``, ``CarbonGrid``, ``site_regions``, ``perturb_mix``
and ``ci_of_mix`` from the reference ``core/carbon_intensity.py``. The mixes are built in float64
numpy exactly as there and then held as float32 tensors, as
``jnp.asarray`` stores them with x64 off.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings

import numpy as np
import torch

from repro_torch.core.constants import HOURS_PER_DAY, SOURCE_CI_LIST, EnergySource
from repro_torch.device import resolve_device

_N_SOURCES = len(EnergySource)


class Grid(enum.IntEnum):
    CISO = 0
    NYISO = 1
    URBAN = 2
    RURAL = 3


class ChargingBehavior(enum.IntEnum):
    """Mobile battery-charging behaviour models (paper §4.3, refs [34,93,103])."""

    NIGHTTIME = 0  # charges only during the night
    AVERAGE = 1  # charges uniformly on demand through the day
    INTELLIGENT = 2  # charges only when renewable energy is available


def _solar_curve(hours: np.ndarray) -> np.ndarray:
    """Daylight bell centered at 13:00, zero at night."""
    x = np.clip(np.cos((hours - 13.0) / 7.0 * np.pi / 2.0), 0.0, None)
    return x**1.5


def _mix_ciso() -> np.ndarray:
    """California-like: big solar hump midday, gas (+imported coal) at night."""
    h = np.arange(HOURS_PER_DAY, dtype=np.float64)
    solar = 0.70 * _solar_curve(h)
    wind = 0.08 + 0.04 * np.sin((h - 2.0) / 24.0 * 2 * np.pi)
    hydro = np.full_like(h, 0.07)
    nuclear = np.full_like(h, 0.07)
    other = np.full_like(h, 0.03)
    night = ((h >= 21) | (h < 6)).astype(np.float64)
    coal = 0.08 * night  # imported baseload at night
    gas = np.clip(1.0 - (solar + wind + hydro + nuclear + other + coal),
                  0.05, None)
    mix = np.zeros((HOURS_PER_DAY, _N_SOURCES))
    mix[:, EnergySource.COAL] = coal
    mix[:, EnergySource.SOLAR] = solar
    mix[:, EnergySource.WIND] = wind
    mix[:, EnergySource.WATER] = hydro
    mix[:, EnergySource.NUCLEAR] = nuclear
    mix[:, EnergySource.OTHER] = other
    mix[:, EnergySource.NATURAL_GAS] = gas
    return mix / mix.sum(axis=1, keepdims=True)


def _mix_nyiso() -> np.ndarray:
    """New-York-like: intermittent wind on a gas/nuclear/hydro base -> CI fluctuates."""
    h = np.arange(HOURS_PER_DAY, dtype=np.float64)
    wind = 0.12 + 0.10 * np.sin(h / 24.0 * 6 * np.pi) + 0.05 * np.sin(h / 24.0 * 2 * np.pi)
    wind = np.clip(wind, 0.02, None)
    hydro = np.full_like(h, 0.18)
    nuclear = np.full_like(h, 0.22)
    other = np.full_like(h, 0.05)
    gas = np.clip(1.0 - (wind + hydro + nuclear + other), 0.05, None)
    mix = np.zeros((HOURS_PER_DAY, _N_SOURCES))
    mix[:, EnergySource.WIND] = wind
    mix[:, EnergySource.WATER] = hydro
    mix[:, EnergySource.NUCLEAR] = nuclear
    mix[:, EnergySource.OTHER] = other
    mix[:, EnergySource.NATURAL_GAS] = gas
    return mix / mix.sum(axis=1, keepdims=True)


def _mix_urban() -> np.ndarray:
    """Urban area: 'relatively small' renewable generation (paper §4.3)."""
    h = np.arange(HOURS_PER_DAY, dtype=np.float64)
    solar = 0.06 * _solar_curve(h)
    wind = np.full_like(h, 0.03)
    nuclear = np.full_like(h, 0.15)
    coal = np.full_like(h, 0.12)
    other = np.full_like(h, 0.06)
    gas = np.clip(1.0 - (solar + wind + nuclear + coal + other), 0.05, None)
    mix = np.zeros((HOURS_PER_DAY, _N_SOURCES))
    mix[:, EnergySource.SOLAR] = solar
    mix[:, EnergySource.WIND] = wind
    mix[:, EnergySource.NUCLEAR] = nuclear
    mix[:, EnergySource.COAL] = coal
    mix[:, EnergySource.OTHER] = other
    mix[:, EnergySource.NATURAL_GAS] = gas
    return mix / mix.sum(axis=1, keepdims=True)


def _mix_rural() -> np.ndarray:
    """Rural area: 'a plenty of renewable energy sources' (paper §4.3)."""
    h = np.arange(HOURS_PER_DAY, dtype=np.float64)
    solar = 0.40 * _solar_curve(h)
    wind = 0.35 + 0.10 * np.sin(h / 24.0 * 4 * np.pi)
    hydro = np.full_like(h, 0.12)
    other = np.full_like(h, 0.03)
    gas = np.clip(1.0 - (solar + wind + hydro + other), 0.03, None)
    mix = np.zeros((HOURS_PER_DAY, _N_SOURCES))
    mix[:, EnergySource.SOLAR] = solar
    mix[:, EnergySource.WIND] = wind
    mix[:, EnergySource.WATER] = hydro
    mix[:, EnergySource.OTHER] = other
    mix[:, EnergySource.NATURAL_GAS] = gas
    return mix / mix.sum(axis=1, keepdims=True)


_GRID_MIX_BUILDERS = {
    Grid.CISO: _mix_ciso,
    Grid.NYISO: _mix_nyiso,
    Grid.URBAN: _mix_urban,
    Grid.RURAL: _mix_rural,
}


@dataclasses.dataclass(frozen=True)
class GridTrace:
    """Hourly generation mix + derived hourly carbon intensity for one grid."""

    mix: torch.Tensor  # (24, n_sources), rows sum to 1
    ci_hourly: torch.Tensor  # (24,) gCO2eq/kWh

    @property
    def ci_mean(self) -> torch.Tensor:
        # XLA's mean: a left-to-right sum times float32(1 / n)
        n = self.ci_hourly.numel()
        return _seq_sum(self.ci_hourly.reshape(-1)) * (1.0 / n)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum of a short 1-D tensor: the order of the
    reference's XLA reduction over one day of hours."""
    total = x[0]
    for v in x[1:]:
        total = total + v
    return total


def _tree_sum(cols: list[torch.Tensor]) -> torch.Tensor:
    """Balanced pairwise sum of equal-shape tensors (first half, then the
    second): the order in which the reference's XLA dot reduces a short
    row, so the hourly CI holds the reference's bits on either device."""
    if len(cols) == 1:
        return cols[0]
    h = len(cols) // 2
    return _tree_sum(cols[:h]) + _tree_sum(cols[h:])


def grid_trace(grid: Grid | int, *,
               device: str | torch.device = "cuda") -> GridTrace:
    dev = resolve_device(device)
    mix = torch.as_tensor(_GRID_MIX_BUILDERS[Grid(int(grid))](),
                          dtype=torch.float32, device=dev)
    source_ci = torch.tensor(SOURCE_CI_LIST, dtype=torch.float32, device=dev)
    return GridTrace(mix=mix,
                     ci_hourly=_tree_sum(list((mix * source_ci).unbind(-1))))


def all_grid_traces(*, device: str | torch.device = "cuda") -> GridTrace:
    """Stacked traces for every grid, leading axis = Grid."""
    traces = [grid_trace(g, device=device) for g in Grid]
    return GridTrace(mix=torch.stack([t.mix for t in traces]),
                     ci_hourly=torch.stack([t.ci_hourly for t in traces]))


def charging_profile(behavior: ChargingBehavior | int,
                     ci_hourly: torch.Tensor) -> torch.Tensor:
    """Hourly probability (sums to 1) that a unit of battery charge is drawn.

    NIGHTTIME  : uniform over 22:00-06:00 (paper Fig 4, yellow area).
    AVERAGE    : uniform over the day (paper Fig 4, blue area).
    INTELLIGENT: only during the lowest-CI hours of the local grid (bottom
                 third of hours -> when renewable energy is available).
    """
    behavior = ChargingBehavior(int(behavior))
    dev = ci_hourly.device
    hours = torch.arange(HOURS_PER_DAY, device=dev)
    if behavior == ChargingBehavior.NIGHTTIME:
        prof = ((hours >= 22) | (hours < 6)).to(torch.float32)
    elif behavior == ChargingBehavior.AVERAGE:
        prof = torch.ones((HOURS_PER_DAY,), dtype=torch.float32, device=dev)
    else:  # INTELLIGENT
        k = HOURS_PER_DAY // 3
        thresh = torch.sort(ci_hourly).values[k - 1]
        prof = (ci_hourly <= thresh).to(torch.float32)
    return prof / prof.sum()


def mobile_carbon_intensity(behavior: ChargingBehavior | int,
                            trace: GridTrace) -> torch.Tensor:
    """Average CI of the energy stored in the phone battery (gCO2eq/kWh):
    the charge-weighted CI of the grid at charging time (paper §3.2 Fig 4)."""
    prof = charging_profile(behavior, trace.ci_hourly)
    return _seq_sum(prof * trace.ci_hourly)


# --- Regions and the unified carbon-grid abstraction ---------------------------


_day_scale_warned = False


def _warn_day_scale() -> None:
    """Warn ONCE per process that ``day_scale`` is deprecated."""
    global _day_scale_warned
    if not _day_scale_warned:
        _day_scale_warned = True
        warnings.warn(
            "day_scale is deprecated: it scales the ACTUAL grid CI as a "
            "stand-in for a forecast. Build the multi-day actuals "
            "explicitly with CarbonGrid.scaled_days(...) and attach a real "
            "rolling forecast with forecast_from_actual(sigma_h, ...) "
            "instead.", DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One serving region: its grid trace drives edge + hyperscale CI.

    ``charging`` sets the device-battery CI of the region's users;
    ``core_ci`` defaults to the trace's daily mean; ``power_budget_w``
    optionally declares the watts of serving hardware the region can
    energize per tier [mobile, edge_dc, hyper_dc] (None = unconstrained).
    """

    name: str
    grid: Grid
    charging: ChargingBehavior = ChargingBehavior.AVERAGE
    core_ci: float | None = None
    power_budget_w: tuple[float, float, float] | None = None


DEFAULT_REGIONS: tuple[RegionSpec, ...] = (
    RegionSpec("ciso", Grid.CISO),
    RegionSpec("nyiso", Grid.NYISO),
    RegionSpec("urban", Grid.URBAN),
    RegionSpec("rural", Grid.RURAL),
)


def region_power_budgets(regions: tuple[RegionSpec, ...]) -> np.ndarray:
    """(R, 3) float64 per-(region, tier) serving power budgets in watts,
    rows of ``np.inf`` where a ``RegionSpec`` declares none."""
    out = np.full((len(regions), 3), np.inf)
    for i, spec in enumerate(regions):
        if spec.power_budget_w is not None:
            b = np.asarray(spec.power_budget_w, np.float64)
            if b.shape != (3,):
                raise ValueError(
                    f"power_budget_w must have 3 entries, got {b.shape}")
            out[i] = b
    return out


_CPU = torch.device("cpu")


def _stack_day(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return a[:, None].expand(like.shape)


@dataclasses.dataclass(frozen=True)
class CarbonGrid:
    """Stacked geo-temporal carbon state of a serving fleet, as tensors on
    one device: what ``FleetRouter.env_at``, ``route_many_envs`` and the
    placement/temporal policies consume.

    The time axis is a rolling horizon of ``H = n_days * 24`` absolute
    hours; hours at or beyond H do not exist (temporal policies mask them).
    ``ci_hourly`` are the ACTUALS routed carbon is charged at,
    ``ci_forecast`` the rolling FORECAST scheduling policies see (None =
    the forecast equals the actuals).

    Tensors (R regions, H hours): ``ci_hourly`` (R, H), ``ci_mobile`` (R,),
    ``ci_core`` (R,), ``pue`` (R, H), ``adjacency`` (R, R) bool,
    ``latency_penalty`` (R, R), ``rtt_s`` (R, R), ``ci_forecast`` (R, H) or
    None, ``nbr_idx`` (R, K) int32 ascending neighbour lists padded with -1
    (None = dense grid) and ``nbr_rtt_s`` (R, K).

    Every constructor builds the tables on the CPU, with the reference's
    numpy RNG draws reproduced bit for bit, and only then moves them to
    ``device``: a grid built for the card and one built for the CPU hold
    the same bits.
    """

    ci_hourly: torch.Tensor
    ci_mobile: torch.Tensor
    ci_core: torch.Tensor
    pue: torch.Tensor
    adjacency: torch.Tensor
    latency_penalty: torch.Tensor
    rtt_s: torch.Tensor
    ci_forecast: torch.Tensor | None = None
    forecast_sigma_h: float = 0.0
    forecast_seed: int = 0
    nbr_idx: torch.Tensor | None = None
    nbr_rtt_s: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.ci_hourly.device

    @property
    def n_regions(self) -> int:
        return self.ci_hourly.shape[0]

    @property
    def k_neighbors(self) -> int | None:
        """Padded sparse neighbor-list width K, or None on dense grids."""
        return None if self.nbr_idx is None else self.nbr_idx.shape[1]

    @property
    def horizon_h(self) -> int:
        """Total horizon length in hours (H = n_days * 24)."""
        return self.ci_hourly.shape[1]

    @property
    def n_days(self) -> int:
        return self.horizon_h // HOURS_PER_DAY

    def to(self, device: str | torch.device) -> "CarbonGrid":
        """This grid with every tensor on ``device``."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name).to(dev)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)

    def _components(self, ci: torch.Tensor) -> torch.Tensor:
        return torch.stack([
            _stack_day(self.ci_mobile, ci),
            ci,
            ci * self.pue,
            _stack_day(self.ci_core, ci),
            ci * self.pue,
        ], dim=-1)

    @property
    def table(self) -> torch.Tensor:
        """(R, H, 5) per-Component CI table [mobile, edge_net, edge_dc,
        core_net, hyper_dc]; edge network and edge DC share CI_E, and PUE
        scales the two DC components."""
        return self._components(self.ci_hourly)

    @property
    def table_forecast(self) -> torch.Tensor:
        """(R, H, 5) component-CI table as the scheduler sees it: the
        grid-driven components read the forecast, the device-battery and
        core-path ones keep their flat values. ``table`` when no forecast
        is attached."""
        if self.ci_forecast is None:
            return self.table
        return self._components(self.ci_forecast)

    def with_forecast(self, ci_forecast) -> "CarbonGrid":
        """Attach an explicit (R, H) forecast CI table (does not roll)."""
        fc = torch.as_tensor(ci_forecast, dtype=torch.float32,
                             device=self.device)
        if fc.shape != self.ci_hourly.shape:
            raise ValueError(f"ci_forecast must be "
                             f"{tuple(self.ci_hourly.shape)}, got "
                             f"{tuple(fc.shape)}")
        return dataclasses.replace(self, ci_forecast=fc)

    def forecast_from_actual(self, sigma_h: float, seed: int = 0,
                             now_h: int = 0) -> "CarbonGrid":
        """Synthesize a rolling forecast: multiplicative error with relative
        std ``sigma_h * sqrt(lead_hours)`` from a fixed seeded per-(region,
        hour) error field. ``sigma_h = 0`` keeps perfect forecasts."""
        if sigma_h < 0.0:
            raise ValueError(f"sigma_h must be >= 0, got {sigma_h}")
        grid = dataclasses.replace(self, forecast_sigma_h=float(sigma_h),
                                   forecast_seed=int(seed))
        return grid.roll(now_h)

    def roll(self, now_h: int = 0) -> "CarbonGrid":
        """Advance the rolling forecast to ``now_h``: hours at or before
        now are revealed as actuals and each future hour's error shrinks
        with its remaining lead. The identity at ``forecast_sigma_h == 0``.
        The error field is the reference's numpy draw, bit for bit."""
        if now_h < 0:
            raise ValueError(f"now_h must be >= 0, got {now_h}")
        sigma = float(self.forecast_sigma_h)
        if sigma == 0.0:
            return self
        h = self.horizon_h
        rng = np.random.default_rng(int(self.forecast_seed))
        eps = rng.standard_normal((self.n_regions, h)).astype(np.float32)
        lead = np.maximum(np.arange(h, dtype=np.float32) - float(now_h), 0.0)
        scale = np.clip(1.0 + sigma * np.sqrt(lead)[None, :] * eps,
                        0.05, None)
        return dataclasses.replace(
            self, ci_forecast=self.ci_hourly * torch.as_tensor(
                scale, device=self.device))

    def scaled_days(self, day_scale) -> "CarbonGrid":
        """Scale each DAY of the horizon's grid-trace CI (and forecast) by a
        per-day factor ((n_days,) positive floats)."""
        scale = np.asarray(day_scale, np.float32).reshape(-1)
        if scale.shape[0] != self.n_days:
            raise ValueError(f"day_scale must have {self.n_days} entries, "
                             f"got {scale.shape[0]}")
        if (scale <= 0.0).any():
            raise ValueError("day_scale entries must be positive")
        per_h = torch.as_tensor(np.repeat(scale, HOURS_PER_DAY),
                                device=self.device)[None, :]
        fc = None if self.ci_forecast is None else self.ci_forecast * per_h
        return dataclasses.replace(self, ci_hourly=self.ci_hourly * per_h,
                                   ci_forecast=fc)

    def repeat(self, n_days: int, day_scale=None) -> "CarbonGrid":
        """Tile this grid's horizon ``n_days`` times; every repeated day is
        bit for bit the original tables. ``day_scale`` is deprecated (use
        ``scaled_days``)."""
        if n_days < 1:
            raise ValueError(f"n_days must be >= 1, got {n_days}")
        tile = lambda a: torch.cat([a] * n_days, dim=1)
        grid = dataclasses.replace(
            self, ci_hourly=tile(self.ci_hourly), pue=tile(self.pue),
            ci_forecast=(None if self.ci_forecast is None
                         else tile(self.ci_forecast)))
        if day_scale is None:
            return grid
        _warn_day_scale()
        scale = np.asarray(day_scale, np.float32).reshape(-1)
        if scale.shape[0] != n_days:
            raise ValueError(f"day_scale must have {n_days} entries, "
                             f"got {scale.shape[0]}")
        if (scale <= 0.0).any():
            raise ValueError("day_scale entries must be positive")
        # one factor per repeated block (this grid's whole horizon)
        ci = torch.cat([self.ci_hourly * float(s) for s in scale], dim=1)
        fc = (None if self.ci_forecast is None else torch.cat(
            [self.ci_forecast * float(s) for s in scale], dim=1))
        return dataclasses.replace(grid, ci_hourly=ci, ci_forecast=fc)

    @classmethod
    def from_regions(cls, regions: tuple[RegionSpec, ...] = DEFAULT_REGIONS,
                     *, adjacency=None, latency_penalty=None, pue=1.0,
                     rtt_s=None, n_days: int = 1, day_scale=None,
                     forecast_sigma_h: float = 0.0, forecast_seed: int = 0,
                     device: str | torch.device = "cuda") -> "CarbonGrid":
        """Build the stacked grid from per-region specs (see the reference
        for every argument). ``adjacency`` defaults to the identity,
        ``latency_penalty`` to 1 (a scalar sets every off-diagonal hop),
        ``rtt_s`` to 0 (likewise), ``pue`` is a scalar, (R,), (24,) or
        (R, 24) facility multiplier."""
        dev = resolve_device(device)
        n = len(regions)
        ci_rows, mob, core = [], [], []
        for region in regions:
            trace = grid_trace(region.grid, device=_CPU)
            ci_rows.append(trace.ci_hourly)
            mob.append(mobile_carbon_intensity(region.charging, trace))
            core.append(torch.tensor(region.core_ci, dtype=torch.float32)
                        if region.core_ci is not None else trace.ci_mean)
        if adjacency is None:
            adjacency = np.eye(n, dtype=bool)
        adjacency = np.asarray(adjacency, bool)
        if adjacency.shape != (n, n):
            raise ValueError(f"adjacency must be ({n}, {n}), got "
                             f"{adjacency.shape}")
        if not adjacency.diagonal().all():
            raise ValueError("adjacency diagonal must be True — a request's "
                             "home region is always a legal placement")
        if latency_penalty is None:
            penalty = np.ones((n, n), np.float32)
        elif np.ndim(latency_penalty) == 0:
            penalty = np.full((n, n), float(latency_penalty), np.float32)
            np.fill_diagonal(penalty, 1.0)
        else:
            penalty = np.asarray(latency_penalty, np.float32)
            if penalty.shape != (n, n):
                raise ValueError(f"latency_penalty must be ({n}, {n}), got "
                                 f"{penalty.shape}")
            if not (penalty.diagonal() == 1.0).all():
                raise ValueError(
                    "latency_penalty diagonal must be 1.0 — executing at "
                    "home carries no WAN-hop penalty")
        if rtt_s is None:
            rtt = np.zeros((n, n), np.float32)
        elif np.ndim(rtt_s) == 0:
            rtt = np.full((n, n), float(rtt_s), np.float32)
            np.fill_diagonal(rtt, 0.0)
        else:
            rtt = np.asarray(rtt_s, np.float32)
            if rtt.shape != (n, n):
                raise ValueError(f"rtt_s must be ({n}, {n}), got {rtt.shape}")
            if not (rtt.diagonal() == 0.0).all():
                raise ValueError("rtt_s diagonal must be 0.0 — executing at "
                                 "home adds no WAN hop")
            if (rtt < 0.0).any():
                raise ValueError("rtt_s must be non-negative")
        pue_arr = np.asarray(pue, np.float32)
        if pue_arr.ndim == 1 and pue_arr.shape[0] == n:
            pue_arr = pue_arr[:, None]  # (R,) = one facility factor/region
        grid = cls(
            ci_hourly=torch.stack(ci_rows),
            ci_mobile=torch.stack(mob),
            ci_core=torch.stack(core),
            pue=torch.as_tensor(np.ascontiguousarray(
                np.broadcast_to(pue_arr, (n, HOURS_PER_DAY)))),
            adjacency=torch.as_tensor(adjacency),
            latency_penalty=torch.as_tensor(penalty),
            rtt_s=torch.as_tensor(rtt),
        )
        if n_days != 1 or day_scale is not None:
            grid = grid.repeat(n_days, day_scale)
        if forecast_sigma_h:
            grid = grid.forecast_from_actual(forecast_sigma_h,
                                             seed=forecast_seed)
        return grid.to(dev)

    @classmethod
    def fully_connected(cls, regions: tuple[RegionSpec, ...] = DEFAULT_REGIONS,
                        *, latency_penalty: float = 1.05, pue=1.0,
                        rtt_s=None, n_days: int = 1, day_scale=None,
                        forecast_sigma_h: float = 0.0, forecast_seed: int = 0,
                        device: str | torch.device = "cuda") -> "CarbonGrid":
        """Every region may spill to every other at a uniform
        effective-carbon penalty per WAN hop."""
        n = len(regions)
        return cls.from_regions(regions, adjacency=np.ones((n, n), bool),
                                latency_penalty=latency_penalty, pue=pue,
                                rtt_s=rtt_s, n_days=n_days,
                                day_scale=day_scale,
                                forecast_sigma_h=forecast_sigma_h,
                                forecast_seed=forecast_seed, device=device)

    def with_sparse_neighbors(self, k: int | None = None) -> "CarbonGrid":
        """Attach the sparse (R, K) neighbor-list view of the dense
        adjacency: row r lists r's off-diagonal adjacent regions ascending,
        padded with -1, with the matching RTT slice."""
        adj = self.adjacency.cpu().numpy().copy()
        np.fill_diagonal(adj, False)
        counts = adj.sum(axis=1)
        k_min = int(counts.max()) if counts.size else 0
        if k is None:
            k = k_min
        if k < k_min:
            raise ValueError(
                f"k={k} cannot hold the densest adjacency row "
                f"({k_min} neighbors)")
        r = self.n_regions
        idx = np.full((r, max(k, 1)), -1, np.int32)
        rtt = np.zeros((r, max(k, 1)), np.float32)
        rtt_d = self.rtt_s.cpu().numpy().astype(np.float32)
        for i in range(r):
            nbrs = np.nonzero(adj[i])[0].astype(np.int32)  # ascending
            idx[i, :len(nbrs)] = nbrs
            rtt[i, :len(nbrs)] = rtt_d[i, nbrs]
        return dataclasses.replace(
            self, nbr_idx=torch.as_tensor(idx, device=self.device),
            nbr_rtt_s=torch.as_tensor(rtt, device=self.device))

    @classmethod
    def from_sites(cls, n_sites: int, k_neighbors: int, seed: int = 0, *,
                   ci_jitter: float = 0.12, rtt_per_unit_s: float = 0.06,
                   penalty_per_unit: float = 0.10, pue: float = 1.0,
                   n_days: int = 1, forecast_sigma_h: float = 0.0,
                   forecast_seed: int = 0,
                   device: str | torch.device = "cuda") -> "CarbonGrid":
        """Mesoscale site grid: sites anchored round-robin to the four
        canonical grid profiles with a per-site CI jitter, placed uniformly
        in the unit square, each spilling to its ``k_neighbors`` nearest
        sites (directed k-NN) with distance-proportional RTT and penalty.
        Carries the sparse neighbor lists beside the dense matrices. The
        placements and jitter are the reference's numpy draws."""
        dev = resolve_device(device)
        if n_sites < 2:
            raise ValueError(f"n_sites must be >= 2, got {n_sites}")
        if not 1 <= k_neighbors < n_sites:
            raise ValueError(
                f"k_neighbors must be in [1, {n_sites - 1}], "
                f"got {k_neighbors}")
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0.0, 1.0, (n_sites, 2))
        factor = np.clip(1.0 + ci_jitter * rng.standard_normal(n_sites),
                         0.2, None).astype(np.float32)

        traces = [grid_trace(g, device=_CPU) for g in Grid]
        ci_rows, mob, core = [], [], []
        for i in range(n_sites):
            trace = traces[i % len(Grid)]
            ci_rows.append(trace.ci_hourly.numpy().astype(np.float32)
                           * factor[i])
            mob.append(float(mobile_carbon_intensity(
                ChargingBehavior.AVERAGE, trace)) * factor[i])
            core.append(float(trace.ci_mean) * factor[i])

        dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(dist, np.inf)
        order = np.argsort(dist, axis=1, kind="stable")[:, :k_neighbors]
        adjacency = np.eye(n_sites, dtype=bool)
        rows = np.repeat(np.arange(n_sites), k_neighbors)
        adjacency[rows, order.reshape(-1)] = True
        np.fill_diagonal(dist, 0.0)
        rtt = (rtt_per_unit_s * dist).astype(np.float32)
        penalty = (1.0 + penalty_per_unit * dist).astype(np.float32)
        np.fill_diagonal(penalty, 1.0)
        nbr_idx = np.sort(order, axis=1).astype(np.int32)
        nbr_rtt = rtt[np.arange(n_sites)[:, None], nbr_idx]

        grid = cls(
            ci_hourly=torch.as_tensor(np.stack(ci_rows)),
            ci_mobile=torch.as_tensor(np.array(mob, np.float32)),
            ci_core=torch.as_tensor(np.array(core, np.float32)),
            pue=torch.full((n_sites, HOURS_PER_DAY), float(np.float32(pue)),
                           dtype=torch.float32),
            adjacency=torch.as_tensor(adjacency),
            latency_penalty=torch.as_tensor(penalty),
            rtt_s=torch.as_tensor(rtt),
            nbr_idx=torch.as_tensor(nbr_idx),
            nbr_rtt_s=torch.as_tensor(nbr_rtt),
        )
        if n_days != 1:
            grid = grid.repeat(n_days)
        if forecast_sigma_h:
            grid = grid.forecast_from_actual(forecast_sigma_h,
                                             seed=forecast_seed)
        return grid.to(dev)


def site_regions(n_sites: int) -> tuple[RegionSpec, ...]:
    """Per-site ``RegionSpec``s matching ``CarbonGrid.from_sites``'s
    round-robin anchor assignment."""
    return tuple(RegionSpec(f"site{i:03d}", Grid(i % len(Grid)))
                 for i in range(n_sites))


# --- Uncertainty injection (paper §5.2) ---------------------------------------


def perturb_mix(mix: torch.Tensor, beta: torch.Tensor, u: torch.Tensor,
                scale: float = 0.168) -> torch.Tensor:
    """Perturbed generation mixes modelling renewable fluctuation.

    Paper §5.2: solar fluctuation ~ Beta, wind fluctuation ~ Weibull, at
    ~16.8% of carbon-intensity fluctuation. Solar/wind columns are scaled
    by mean-1 factors, natural gas absorbs the imbalance and the mix is
    renormalized. The reference draws with ``jax.random``; here the draws
    are arguments, each of shape ``(n_samples,) + mix.shape[:-1]``:
    ``beta`` Beta(5, 5) and ``u`` uniform on [1e-6, 1) (the Weibull's
    inverse-CDF input). Returns ``(n_samples,) + mix.shape``."""
    dev = mix.device
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev) * 2.0
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    weib = (-torch.log(u)) ** 0.5 / 0.8862
    solar_f = 1.0 + scale * (beta - 1.0) / 0.30
    wind_f = 1.0 + scale * (weib - 1.0) / 0.52
    out = mix.expand(tuple(beta.shape) + (mix.shape[-1],)).clone()
    out[..., EnergySource.SOLAR] *= torch.clamp_min(solar_f, 0.0)
    out[..., EnergySource.WIND] *= torch.clamp_min(wind_f, 0.0)
    gas = EnergySource.NATURAL_GAS
    resid = 1.0 - (out.sum(-1) - out[..., gas])
    out[..., gas] = torch.clamp_min(resid, 0.0)
    return out / out.sum(-1, keepdim=True)


def ci_of_mix(mix: torch.Tensor) -> torch.Tensor:
    """Carbon intensity of a generation mix (last axis = sources), as an
    ordered sum over the sources (the same bits on the card and the CPU)."""
    ci = torch.tensor(SOURCE_CI_LIST, dtype=torch.float32, device=mix.device)
    out = mix[..., 0] * ci[0]
    for k in range(1, mix.shape[-1]):
        out = out + mix[..., k] * ci[k]
    return out
