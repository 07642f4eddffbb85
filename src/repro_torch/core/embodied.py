"""Embodied carbon-footprint models (paper §3.1, §4.3, Fig 11).

Two tools, as in the paper:

  * **ACT** (Gupta et al., ISCA'22 [50]) — an architectural carbon model that
    builds embodied CF bottom-up from die area, fab energy/gas/material
    intensity, yield, memory and storage capacity.  Reimplemented here with
    the published per-process-node constants.
  * **LCA** — the manufacturer life-cycle reports ([7,21,48,60,105,108,113]);
    these arrive as plain numbers in ``infrastructure.ComputeSpec.ecf_lca_g``.

Paper §4.3: ACT does not model networking gear (transceivers), so base
stations and routers always use LCA values regardless of the selected tool;
and the two tools differ by ~28% on the compute components — the ACT
parameters below land within a few percent of that gap by construction of the
published constants, which the Fig-11 reproduction depends on.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FabParams:
    """Per-process-node fab parameters (ACT paper, Table 2/3 ballpark)."""

    epa_kwh_per_cm2: float  # fab energy per wafer area
    gpa_g_per_cm2: float  # direct fluorinated-gas emissions per area
    mpa_g_per_cm2: float  # upstream material emissions per area
    yield_frac: float
    fab_ci_g_per_kwh: float  # carbon intensity of the fab's grid


#: 10/7nm-class logic (TSMC, Taiwan grid ~2019).
FAB_7NM = FabParams(epa_kwh_per_cm2=1.2, gpa_g_per_cm2=250.0,
                    mpa_g_per_cm2=500.0, yield_frac=0.875,
                    fab_ci_g_per_kwh=620.0)
#: 12/16nm-class logic (V100-era).
FAB_14NM = FabParams(epa_kwh_per_cm2=0.9, gpa_g_per_cm2=200.0,
                     mpa_g_per_cm2=500.0, yield_frac=0.90,
                     fab_ci_g_per_kwh=620.0)

#: Carbon per GB, grams (ACT paper memory/storage models).
DRAM_G_PER_GB = 370.0
HBM_G_PER_GB = 450.0
NAND_G_PER_GB = 110.0
#: Fixed packaging/assembly/PCB overhead per device class, grams.
PACKAGING_MOBILE_G = 6.5e3
PACKAGING_SERVER_G = 250e3


@dataclasses.dataclass(frozen=True)
class DeviceBOM:
    """Bill of materials for the ACT bottom-up model."""

    name: str
    logic_area_cm2: float
    fab: FabParams
    dram_gb: float = 0.0
    hbm_gb: float = 0.0
    nand_gb: float = 0.0
    packaging_g: float = 0.0
    #: number of identical accelerator packages in the unit (e.g. 8x A100)
    n_packages: int = 1


def amortized_g_per_hour(embodied_g: float, lifetime_h: float,
                         utilization: float = 1.0) -> float:
    """Amortized embodied carbon per server-hour (paper §4.3).

    The paper spreads a device's embodied CF uniformly over its service
    lifetime; each provisioned hour is charged ``embodied_g / lifetime_h``.
    ``utilization`` < 1 concentrates the same total onto the fraction of
    the lifetime the device is actually provisioned (a server kept for 4
    years but serving half the hours carries twice the per-served-hour
    charge) — the CASPER-style accounting the provisioning subsystem
    charges each (site, tier, hour) server cell.
    """
    if lifetime_h <= 0:
        raise ValueError(f"lifetime_h must be positive, got {lifetime_h}")
    if not 0.0 < utilization <= 1.0:
        raise ValueError(
            f"utilization must be in (0, 1], got {utilization}")
    return embodied_g / (lifetime_h * utilization)


def act_embodied_g(bom: DeviceBOM) -> float:
    """ACT embodied CF (grams CO2e) for one unit."""
    fab = bom.fab
    per_die = bom.logic_area_cm2 * (
        fab.fab_ci_g_per_kwh * fab.epa_kwh_per_cm2
        + fab.gpa_g_per_cm2 + fab.mpa_g_per_cm2) / fab.yield_frac
    mem = (bom.dram_gb * DRAM_G_PER_GB + bom.hbm_gb * HBM_G_PER_GB
           + bom.nand_gb * NAND_G_PER_GB)
    return bom.n_packages * per_die + mem + bom.packaging_g


# --- BOMs for the paper fleet ---------------------------------------------------

#: Pixel 3: Snapdragon 845 die ~94 mm^2 (10nm), 4 GB LPDDR4, 64 GB UFS.
BOM_PIXEL3 = DeviceBOM(name="pixel3", logic_area_cm2=0.94, fab=FAB_7NM,
                       dram_gb=4, nand_gb=64, packaging_g=PACKAGING_MOBILE_G)

#: p3.2xlarge share: V100 (815 mm^2, 12nm) + 16 GB HBM2 + host slice
#: (Xeon ~3.5 cm^2, 64 GB DRAM, 0.5 TB SSD share).
BOM_P3 = DeviceBOM(name="p3.2xlarge-v100", logic_area_cm2=8.15 + 3.5,
                   fab=FAB_14NM, dram_gb=64, hbm_gb=16, nand_gb=512,
                   packaging_g=PACKAGING_SERVER_G)

#: p4d.24xlarge: 8x A100 (826 mm^2, 7nm) + 8x40 GB HBM2e + dual-Xeon host +
#: 1152 GB DRAM + 8 TB NVMe.
BOM_P4D = DeviceBOM(name="p4d.24xlarge-a100x8", logic_area_cm2=8.26,
                    fab=FAB_7NM, dram_gb=1152 / 8, hbm_gb=40, nand_gb=1024,
                    packaging_g=PACKAGING_SERVER_G / 8, n_packages=1)


def act_fleet_embodied_g() -> dict[str, float]:
    """ACT estimates for the paper fleet's compute tiers, grams per unit."""
    return {
        "pixel3": act_embodied_g(BOM_PIXEL3),
        "p3.2xlarge-v100": act_embodied_g(BOM_P3),
        # p4d: 8 GPU packages + host overheads
        "p4d.24xlarge-a100x8": 8 * act_embodied_g(BOM_P4D)
        + act_embodied_g(dataclasses.replace(
            BOM_P3, name="p4d-host", logic_area_cm2=7.0, hbm_gb=0,
            dram_gb=0, nand_gb=0, packaging_g=PACKAGING_SERVER_G)),
    }
