"""Physical and carbon constants used throughout GreenScale.

Every constant cites the paper table (or external source) it comes from.
All units are SI unless the name says otherwise:
  time      -> seconds
  power     -> watts
  energy    -> joules
  carbon    -> grams CO2e  (gCO2eq)
  intensity -> gCO2eq / kWh  (converted via J_PER_KWH when applied to joules)
"""

from __future__ import annotations

import enum

J_PER_KWH: float = 3.6e6
HOURS_PER_DAY: int = 24
SECONDS_PER_YEAR: float = 365.25 * 24 * 3600.0


class EnergySource(enum.IntEnum):
    """Energy generation sources (paper Table 3)."""

    WIND = 0
    SOLAR = 1
    WATER = 2
    OIL = 3
    NATURAL_GAS = 4
    COAL = 5
    NUCLEAR = 6
    OTHER = 7


#: Operational carbon intensity of energy sources, gCO2eq/kWh (paper Table 3).
SOURCE_CARBON_INTENSITY: dict[EnergySource, float] = {
    EnergySource.WIND: 11.0,
    EnergySource.SOLAR: 41.0,
    EnergySource.WATER: 24.0,
    EnergySource.OIL: 650.0,
    EnergySource.NATURAL_GAS: 490.0,
    EnergySource.COAL: 820.0,
    EnergySource.NUCLEAR: 12.0,
    EnergySource.OTHER: 230.0,
}

#: Same table as a positional list indexed by EnergySource value.
SOURCE_CI_LIST: list[float] = [
    SOURCE_CARBON_INTENSITY[EnergySource(i)] for i in range(len(EnergySource))
]

#: ACT vs LCA embodied-CF gap (paper §4.3: "those two modeling tools have 28% gap").
ACT_OVER_LCA_RATIO: float = 0.72


class Target(enum.IntEnum):
    """Execution targets across the edge-cloud spectrum (paper Table 1 rows)."""

    MOBILE = 0
    EDGE_DC = 1
    HYPERSCALE_DC = 2


N_TARGETS: int = len(Target)


class Component(enum.IntEnum):
    """Infrastructure components (paper Table 1 columns)."""

    MOBILE = 0
    EDGE_NETWORK = 1  # base station
    EDGE_DC = 2
    CORE_NETWORK = 3  # core routers
    HYPERSCALE_DC = 4


N_COMPONENTS: int = len(Component)


# --- TPU v5e hardware constants (roofline targets; system prompt) -------------
TPU_V5E_PEAK_BF16_FLOPS: float = 197e12  # FLOP/s per chip
TPU_V5E_HBM_BW: float = 819e9  # bytes/s per chip
TPU_V5E_ICI_BW: float = 50e9  # bytes/s per link
TPU_V5E_TDP_W: float = 215.0  # chip TDP (public v5e figure ~215W board power)
TPU_V5E_IDLE_W: float = 60.0  # idle draw estimate
TPU_V5E_HBM_GIB: float = 16.0  # HBM capacity per chip


# --- QoS constraints (paper §3.2 / §4.1) --------------------------------------
QOS_VISION_FPS: float = 30.0  # 30 FPS -> 33.3 ms (paper: [24,133])
QOS_VISION_LATENCY_S: float = 1.0 / QOS_VISION_FPS
QOS_TEXT_LATENCY_S: float = 0.100  # 100 ms for text workloads (paper: [98])
QOS_INTERACTIVE_LATENCY_S: float = 0.050  # 50 ms interactive (paper: [26,78])
QOS_ARVR_LATENCY_S: float = 0.09783  # 97.83 ms (paper Table 6)
