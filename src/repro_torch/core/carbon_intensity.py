"""Time-varying carbon intensity (paper §3.2, Fig 4): hourly grid traces and
the device-battery CI under a charging behaviour.

Port of ``Grid``, ``ChargingBehavior``, the numpy mix builders,
``GridTrace``, ``grid_trace``, ``charging_profile`` and
``mobile_carbon_intensity`` from the reference ``core/carbon_intensity.py``.
The mixes are built in float64 numpy exactly as there and then held as
float32 tensors, as ``jnp.asarray`` stores them with x64 off.
"""

from __future__ import annotations

import dataclasses
import enum

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
        return self.ci_hourly.mean()


def grid_trace(grid: Grid | int, *,
               device: str | torch.device = "cuda") -> GridTrace:
    dev = resolve_device(device)
    mix = torch.as_tensor(_GRID_MIX_BUILDERS[Grid(int(grid))](),
                          dtype=torch.float32, device=dev)
    source_ci = torch.tensor(SOURCE_CI_LIST, dtype=torch.float32, device=dev)
    return GridTrace(mix=mix, ci_hourly=mix @ source_ci)


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
    return (prof * trace.ci_hourly).sum()
