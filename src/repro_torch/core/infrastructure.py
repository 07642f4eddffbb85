"""Edge-cloud infrastructure specifications (paper §2, §4.2, Tables 7-8).

Port of the fleet specs, ``pack_infra`` and the per-tier envelopes
(``TierEnvelope``, ``tpu_envelope``, ``paper_envelope``) from the
reference ``core/infrastructure.py``: the same two fleets (``paper_fleet``
for the figure reproductions, ``tpu_fleet`` for the LM workloads) packed
into a dataclass of float32 tensors that the Table-1 model consumes. The
envelopes are the simulated fleet's tier data (host numpy), not the
hardware this package runs on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.constants import (
    ACT_OVER_LCA_RATIO,
    SECONDS_PER_YEAR,
    TPU_V5E_PEAK_BF16_FLOPS,
    TPU_V5E_TDP_W,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """One compute tier (mobile device / edge DC server / hyperscale DC server)."""

    name: str
    #: effective FLOP/s sustained on NN-style work (calibrated, not peak)
    eff_flops: float
    #: sustained memory bandwidth (bytes/s) for memory-bound workloads
    eff_mem_bw: float
    p_comp: float  # W while computing
    p_comm: float  # W while transmitting (client devices; 0 for servers)
    p_idle: float  # W while idle
    ecf_lca_g: float  # embodied CF per LCA reports, grams CO2e
    lifetime_s: float
    pue: float = 1.0  # power usage effectiveness multiplier (DCs)
    #: explicit ACT bottom-up estimate; None -> the paper's 28% ACT-under-LCA gap
    ecf_act_override_g: float | None = None

    @property
    def ecf_act_g(self) -> float:
        """ACT estimate — paper §4.3: ACT is ~28% below LCA reports."""
        if self.ecf_act_override_g is not None:
            return self.ecf_act_override_g
        return self.ecf_lca_g * ACT_OVER_LCA_RATIO


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """One network component (base station or core-router path)."""

    name: str
    bandwidth_bps: float  # per-user achievable throughput
    base_latency_s: float  # propagation + protocol latency floor
    p_active: float  # W while carrying traffic (whole unit)
    n_user: float  # concurrent users sharing the unit
    ecf_lca_g: float
    lifetime_s: float

    @property
    def ecf_act_g(self) -> float:
        return self.ecf_lca_g * ACT_OVER_LCA_RATIO


@dataclasses.dataclass(frozen=True)
class Fleet:
    """A full edge-cloud deployment: 3 compute tiers + 2 network components.

    ``mobile_arvr``: the Jetson AGX that runs the paper's AR/VR workloads.
    """

    mobile: ComputeSpec
    edge_dc: ComputeSpec
    hyper_dc: ComputeSpec
    edge_net: NetworkSpec  # base station (macro BS) / WiFi AP
    core_net: NetworkSpec  # multi-hop core-router path
    mobile_arvr: ComputeSpec | None = None  # Jetson AGX (AR/VR workloads)
    # Sharing populations (paper Table 2): users amortizing idle + embodied CF.
    n_user_edge: float = 32.0  # N_user_E  — users per edge-DC server
    n_user_dc: float = 512.0  # N_user_DC — users per hyperscale-DC server
    n_batch_dc: float = 64.0  # N_B       — users batched together in the DC


def paper_fleet() -> Fleet:
    """The paper's measured infrastructure, reconstructed analytically
    (the calibrated constants of the reference ``paper_fleet``)."""
    mobile = ComputeSpec(
        name="pixel3",
        eff_flops=39.049e9,
        eff_mem_bw=24.084e9,
        p_comp=3.797,
        p_comm=1.067,
        p_idle=0.4845,
        ecf_lca_g=5000.0 / ACT_OVER_LCA_RATIO,
        lifetime_s=3 * SECONDS_PER_YEAR,
    )
    jetson = ComputeSpec(
        name="jetson-agx-xavier",
        eff_flops=825.6e9,
        eff_mem_bw=40.93e9,
        p_comp=10.0,
        p_comm=1.067,
        p_idle=0.4845,
        ecf_lca_g=21065.6 / ACT_OVER_LCA_RATIO,
        lifetime_s=3 * SECONDS_PER_YEAR,
    )
    edge_dc = ComputeSpec(
        name="p3.2xlarge-v100",
        eff_flops=0.7281e12,
        eff_mem_bw=300e9,
        p_comp=693.5,
        p_comm=0.0,
        p_idle=15.0,
        ecf_lca_g=1.0e6 / ACT_OVER_LCA_RATIO,
        lifetime_s=4 * SECONDS_PER_YEAR,
        pue=1.5,
    )
    hyper_dc = ComputeSpec(
        name="p4d.24xlarge-a100x8",
        eff_flops=30e12,  # server-level batched sustained; shared via N_B
        eff_mem_bw=1.2e12,
        p_comp=7000.0,  # whole server; divided by N_B per user
        p_comm=0.0,
        p_idle=700.0,
        ecf_lca_g=3.0e6 / ACT_OVER_LCA_RATIO,
        lifetime_s=4 * SECONDS_PER_YEAR,
        pue=1.1,
    )
    edge_net = NetworkSpec(
        name="macro-bs",
        bandwidth_bps=18.14e6,
        base_latency_s=0.00408,
        p_active=1161.2,
        n_user=1500.0,
        ecf_lca_g=25e6,
        lifetime_s=8 * SECONDS_PER_YEAR,
    )
    core_net = NetworkSpec(
        name="core-router-path",
        bandwidth_bps=80.62e6,
        base_latency_s=0.013408,
        p_active=10000.0,
        n_user=40000.0,
        ecf_lca_g=18e6,
        lifetime_s=6 * SECONDS_PER_YEAR,
    )
    return Fleet(mobile=mobile, edge_dc=edge_dc, hyper_dc=hyper_dc,
                 edge_net=edge_net, core_net=core_net, mobile_arvr=jetson,
                 n_user_edge=62.54, n_user_dc=4096.0, n_batch_dc=16.0)


def tpu_fleet() -> Fleet:
    """TPU v5e edge/cloud fleet for LM workloads (the routing fleet of the
    reference; its tiers are the deployment being modelled, not the card
    the port runs on)."""
    mobile = ComputeSpec(
        name="device-npu",
        eff_flops=4e12,  # phone-class NPU sustained int8/bf16-equivalent
        eff_mem_bw=60e9,
        p_comp=6.0,
        p_comm=2.0,
        p_idle=1.0,
        ecf_lca_g=60e3,
        lifetime_s=3 * SECONDS_PER_YEAR,
    )
    edge_dc = ComputeSpec(
        name="v5e-8-slice",
        eff_flops=8 * TPU_V5E_PEAK_BF16_FLOPS * 0.45,
        eff_mem_bw=8 * 819e9,
        p_comp=8 * TPU_V5E_TDP_W + 400.0,
        p_comm=0.0,
        p_idle=8 * 60.0 + 200.0,
        ecf_lca_g=6.0e6,
        lifetime_s=4 * SECONDS_PER_YEAR,
        pue=1.4,
    )
    hyper_dc = ComputeSpec(
        name="v5e-256-pod",
        eff_flops=256 * TPU_V5E_PEAK_BF16_FLOPS * 0.55,
        eff_mem_bw=256 * 819e9,
        p_comp=256 * TPU_V5E_TDP_W + 8000.0,
        p_comm=0.0,
        p_idle=256 * 60.0 + 4000.0,
        ecf_lca_g=256 * 0.9e6,
        lifetime_s=4 * SECONDS_PER_YEAR,
        pue=1.1,
    )
    edge_net = NetworkSpec(
        name="5g-bs",
        bandwidth_bps=200e6,
        base_latency_s=0.008,
        p_active=1200.0,
        n_user=250.0,
        ecf_lca_g=25e6,
        lifetime_s=8 * SECONDS_PER_YEAR,
    )
    core_net = NetworkSpec(
        name="core-router-path",
        bandwidth_bps=400e6,
        base_latency_s=0.018,
        p_active=10000.0,
        n_user=40000.0,
        ecf_lca_g=18e6,
        lifetime_s=6 * SECONDS_PER_YEAR,
    )
    return Fleet(mobile=mobile, edge_dc=edge_dc, hyper_dc=hyper_dc,
                 edge_net=edge_net, core_net=core_net,
                 n_user_edge=16.0, n_user_dc=2048.0, n_batch_dc=256.0)


@dataclasses.dataclass(frozen=True)
class InfraParams:
    """Everything the Table-1 model needs, as float32 tensors."""

    # compute tiers, indexed [mobile, edge_dc, hyper_dc]
    eff_flops: torch.Tensor  # (3,)
    eff_mem_bw: torch.Tensor  # (3,)
    p_comp: torch.Tensor  # (3,)  (PUE already folded in for DCs)
    p_idle: torch.Tensor  # (3,)
    p_comm_mobile: torch.Tensor  # ()
    ecf_g: torch.Tensor  # (3,)  embodied CF per tier (ACT or LCA)
    lifetime_s: torch.Tensor  # (3,)
    # networks, indexed [edge_net, core_net]
    net_bw: torch.Tensor  # (2,)
    net_lat: torch.Tensor  # (2,)
    net_p: torch.Tensor  # (2,)
    net_n_user: torch.Tensor  # (2,)
    net_ecf_g: torch.Tensor  # (2,)
    net_lifetime_s: torch.Tensor  # (2,)
    # sharing populations
    n_user_edge: torch.Tensor  # ()
    n_user_dc: torch.Tensor  # ()
    n_batch_dc: torch.Tensor  # ()


def pack_infra(fleet: Fleet, embodied_model: str = "act",
               device_kind: str = "phone", *,
               device: str | torch.device = "cuda") -> InfraParams:
    """Pack a Fleet into InfraParams. embodied_model: 'act' | 'lca'.

    ``device_kind``: 'phone' | 'jetson' — which mobile spec fills tier 0
    (the reference's ``device`` argument; renamed here because ``device``
    is the torch device every entry point of the port takes)."""
    dev = resolve_device(device)
    mobile = fleet.mobile
    if device_kind == "jetson":
        if fleet.mobile_arvr is None:
            raise ValueError("fleet has no Jetson (mobile_arvr) spec")
        mobile = fleet.mobile_arvr
    elif device_kind != "phone":
        raise ValueError(f"unknown device {device_kind!r}")
    tiers = (mobile, fleet.edge_dc, fleet.hyper_dc)
    nets = (fleet.edge_net, fleet.core_net)
    if embodied_model not in ("act", "lca"):
        raise ValueError(f"unknown embodied model: {embodied_model!r}")
    ecf = [t.ecf_act_g if embodied_model == "act" else t.ecf_lca_g for t in tiers]
    # Paper §4.3: ACT does not model networking components (transceivers);
    # base stations and routers always use the LCA reports.
    net_ecf = [n.ecf_lca_g for n in nets]
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return InfraParams(
        eff_flops=f([t.eff_flops for t in tiers]),
        eff_mem_bw=f([t.eff_mem_bw for t in tiers]),
        p_comp=f([t.p_comp * t.pue for t in tiers]),
        p_idle=f([t.p_idle * t.pue for t in tiers]),
        p_comm_mobile=f(fleet.mobile.p_comm),
        ecf_g=f(ecf),
        lifetime_s=f([t.lifetime_s for t in tiers]),
        net_bw=f([n.bandwidth_bps for n in nets]),
        net_lat=f([n.base_latency_s for n in nets]),
        net_p=f([n.p_active for n in nets]),
        net_n_user=f([n.n_user for n in nets]),
        net_ecf_g=f(net_ecf),
        net_lifetime_s=f([n.lifetime_s for n in nets]),
        n_user_edge=f(fleet.n_user_edge),
        n_user_dc=f(fleet.n_user_dc),
        n_batch_dc=f(fleet.n_batch_dc),
    )


# ------------------------------------------------------------------------------
# Per-tier TDP/VRAM envelopes: watt-shaped heterogeneous-fleet capacity
# ------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierEnvelope:
    """Per-tier accelerator envelopes of the simulated fleet: TDP and VRAM
    of one server unit, indexed [mobile, edge_dc, hyper_dc].

    ``tdp_w``       watts one server of the tier draws at its power cap.
    ``vram_bytes``  bytes of accelerator memory one server exposes — the
                    KV-cache budget bounding concurrent decode states
                    (``np.inf`` = unbounded).
    """

    name: str
    tdp_w: tuple[float, float, float]
    vram_bytes: tuple[float, float, float]

    def servers_for_power(self, power_budget_w) -> np.ndarray:
        """Whole servers a per-tier power budget (W) energizes:
        ``floor(budget / tdp_w)`` elementwise over a (..., 3) budget array;
        ``np.inf`` budgets stay ``np.inf``."""
        b = np.asarray(power_budget_w, np.float64)
        tdp = np.asarray(self.tdp_w, np.float64)
        if (tdp <= 0).any():
            raise ValueError("tdp_w entries must be positive")
        return np.where(np.isinf(b), np.inf, np.floor(b / tdp))

    def kv_slots(self, tier: int, slot_bytes: float) -> int | None:
        """Concurrent KV-cache slots tier ``tier``'s VRAM holds at
        ``slot_bytes`` per decode slot; None when that VRAM is ``np.inf``.
        At least 1 — a server that exists serves."""
        v = float(self.vram_bytes[tier])
        if np.isinf(v):
            return None
        if slot_bytes <= 0:
            raise ValueError("slot_bytes must be positive")
        return max(1, int(v // float(slot_bytes)))


def tpu_envelope() -> TierEnvelope:
    """``tpu_fleet`` tier envelopes: phone NPU sharing ~8 GiB of SoC memory,
    a v5e-8 slice (8 x 16 GiB HBM) and a v5e-256 pod (256 x 16 GiB HBM)."""
    gib = 1024.0**3
    return TierEnvelope(
        name="tpu-v5e",
        tdp_w=(6.0, 8 * TPU_V5E_TDP_W + 400.0,
               256 * TPU_V5E_TDP_W + 8000.0),
        vram_bytes=(8.0 * gib, 8 * 16.0 * gib, 256 * 16.0 * gib))


def paper_envelope() -> TierEnvelope:
    """``paper_fleet`` tier envelopes: Pixel 3 (4 GiB shared), p3.2xlarge
    (one V100, 16 GiB HBM), p4d.24xlarge (8 x A100-40GiB)."""
    gib = 1024.0**3
    return TierEnvelope(
        name="paper",
        tdp_w=(3.797, 693.5, 7000.0),
        vram_bytes=(4.0 * gib, 16.0 * gib, 8 * 40.0 * gib))
