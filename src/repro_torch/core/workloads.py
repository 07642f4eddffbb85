"""Workload descriptors (paper §4.1, Tables 4-6) as dataclasses of float32
tensors.

Port of the reference ``core/workloads.py``: ``Workload`` and its
constructors, the registry entry ``WorkloadInfo`` (with ``ARVRInfo``), the
paper's three workload tables and ``lm_workload``. Callers compute the
descriptor numbers on the host in float64 (e.g. ``2 * N_active * tokens``)
and the constructors round them to float32 once, as
``jnp.asarray(x, jnp.float32)`` does: taking the product in float32 would
change the FLOP count. The tables are data: their descriptors live on the
CPU, and ``stack_workloads`` moves a stack of them to the device asked for.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from repro_torch.core.constants import (
    QOS_ARVR_LATENCY_S,
    QOS_TEXT_LATENCY_S,
    QOS_VISION_LATENCY_S,
)
from repro_torch.device import resolve_device


class Category(enum.IntEnum):
    AI_VISION = 0
    AI_TEXT = 1
    GAME = 2
    ARVR = 3
    LM = 4  # assigned LM architectures (beyond-paper)


def _f32(x, device: torch.device) -> torch.Tensor:
    """Host value (float64 numpy/Python) -> float32 tensor, rounded once."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                           device=device)


@dataclasses.dataclass(frozen=True)
class Workload:
    """One schedulable workload (single request / frame / step); every field
    is a float32 tensor, scalar or with leading batch dimensions.

    ``flops``            floating point ops per request.
    ``mem_bytes``        bytes touched per request (memory-bound latency).
    ``data_in``          request payload uploaded from the client (bytes).
    ``data_out``         response payload downloaded to the client (bytes).
    ``latency_req``      QoS latency constraint (s).
    ``continuous``       1.0 for streaming workloads, else 0.0.
    ``fps_req``          required frame rate for streaming workloads (Hz).
    ``mobile_eff_scale`` client-device efficiency factor vs the fleet's
                         nominal eff_flops (1.0 = nominal).
    """

    flops: torch.Tensor
    mem_bytes: torch.Tensor
    data_in: torch.Tensor
    data_out: torch.Tensor
    latency_req: torch.Tensor
    continuous: torch.Tensor
    fps_req: torch.Tensor
    mobile_eff_scale: torch.Tensor

    @staticmethod
    def make(flops, mem_bytes, data_in, data_out, latency_req,
             continuous=0.0, fps_req=0.0, mobile_eff_scale=1.0, *,
             device: str | torch.device = "cuda") -> "Workload":
        dev = resolve_device(device)
        return Workload(*[_f32(x, dev) for x in (
            flops, mem_bytes, data_in, data_out, latency_req, continuous,
            fps_req, mobile_eff_scale)])


def batch_workloads(*, flops, mem_bytes, data_in, data_out, latency_req,
                    continuous=0.0, fps_req=0.0, mobile_eff_scale=1.0,
                    device: str | torch.device = "cuda") -> Workload:
    """Vectorized ``Workload.make``: array-valued fields broadcast to one
    common batch shape, producing a stacked Workload."""
    dev = resolve_device(device)
    leaves = [_f32(x, dev) for x in (flops, mem_bytes, data_in, data_out,
                                     latency_req, continuous, fps_req,
                                     mobile_eff_scale)]
    shape = torch.broadcast_shapes(*[l.shape for l in leaves])
    return Workload(*[l.expand(shape) for l in leaves])


@dataclasses.dataclass(frozen=True)
class WorkloadInfo:
    """Registry entry: a descriptor (on the CPU) and host metadata.

    ``available_targets`` — which execution targets exist for this
    workload (games and AR/VR have no edge-DC build, paper §4.1)."""

    name: str
    category: Category
    workload: Workload
    available_targets: tuple[bool, bool, bool] = (True, True, True)

    @property
    def avail_mask(self) -> torch.Tensor:
        """(3,) bool, on the CPU like the descriptor."""
        return torch.tensor(self.available_targets)

    @property
    def device(self) -> str:
        """Which client device runs this workload (paper §4.2: AI and games
        on the Pixel 3, AR/VR on the Jetson AGX)."""
        return "jetson" if self.category == Category.ARVR else "phone"


def _kb(x: float) -> float:
    return x * 1e3


def _mb(x: float) -> float:
    return x * 1e6


def _table_workload(**kw) -> Workload:
    """A table entry's descriptor, held on the CPU (import never touches a
    card)."""
    return Workload.make(**kw, device="cpu")


# --- Table 4: NN inference workloads ------------------------------------------
# FLOPs / params / IO sizes as published; mem_bytes ~ 2x params (fp16 weights
# read once) + activations (~20% extra).

def _nn(name: str, cat: Category, gflops: float, mparams: float, io_kb: float,
        latency: float, dsp: float = 1.0) -> WorkloadInfo:
    params_b = mparams * 1e6 * 2.0  # fp16 weight bytes
    return WorkloadInfo(
        name=name,
        category=cat,
        workload=_table_workload(
            flops=gflops * 1e9,
            mem_bytes=params_b * 1.2,
            data_in=_kb(io_kb),
            data_out=_kb(4.0),  # logits / detections are small
            latency_req=latency,
            mobile_eff_scale=dsp,
        ),
    )


# dsp factors: heavy CNNs run quantized on the Hexagon DSP; small float nets
# stay on the GPU (values co-calibrated with paper_fleet()).
AI_WORKLOADS: tuple[WorkloadInfo, ...] = (
    _nn("mobilenet", Category.AI_VISION, 0.31, 3.5, 150.5, QOS_VISION_LATENCY_S),
    _nn("squeezenet", Category.AI_VISION, 0.82, 1.2, 150.5, QOS_VISION_LATENCY_S),
    _nn("resnet50", Category.AI_VISION, 4.09, 25.6, 150.5, QOS_VISION_LATENCY_S,
        dsp=3.912),
    _nn("mobilenet-ssd", Category.AI_VISION, 0.80, 6.8, 270.0, QOS_VISION_LATENCY_S),
    _nn("inception", Category.AI_VISION, 5.71, 23.8, 268.2, QOS_VISION_LATENCY_S,
        dsp=2.404),
    _nn("bert", Category.AI_TEXT, 25.3, 17.5, 1.0, QOS_TEXT_LATENCY_S),
)


# --- Table 5: game workloads ---------------------------------------------------
# Continuous streaming: at the DC every rendered frame streams to the client
# at fps_req; ``data_out`` is the per-second stream volume over fps.

def _game(name: str, stream_mb_s: float, fps: float, latency_ms: float,
          gflops_frame: float) -> WorkloadInfo:
    return WorkloadInfo(
        name=name,
        category=Category.GAME,
        workload=_table_workload(
            flops=gflops_frame * 1e9,
            mem_bytes=gflops_frame * 1e9 * 0.5,  # texture/geometry traffic
            data_in=_kb(8.0),  # controller input per frame
            data_out=_mb(stream_mb_s) / fps,  # streamed frame payload
            latency_req=latency_ms / 1e3,
            continuous=1.0,
            fps_req=fps,
        ),
        # Android build on the phone vs cloud gaming in the DC (§4.1)
        available_targets=(True, False, True),
    )


GAME_WORKLOADS: tuple[WorkloadInfo, ...] = (
    _game("fortnite", 3.2, 60.0, 100.0, 0.70),
    _game("genshin-impact", 3.0, 60.0, 500.0, 0.65),
    _game("teamfight-tactics", 1.9, 60.0, 1000.0, 0.40),
)


# --- Table 6: AR/VR workloads (ILLIXR) -----------------------------------------


@dataclasses.dataclass(frozen=True)
class ARVRInfo(WorkloadInfo):
    #: per-stage (perception, visual, audio) FLOPs fractions, sums to 1
    stage_flops_frac: tuple[float, float, float] = (0.45, 0.45, 0.10)
    #: payload entering each stage, bytes (input -> perception -> visual)
    stage_bytes: tuple[float, float, float] = (_kb(540.47), _kb(160.0), _kb(90.0))


def _arvr(name: str, gflops: float) -> ARVRInfo:
    return ARVRInfo(
        name=name,
        category=Category.ARVR,
        workload=_table_workload(
            flops=gflops * 1e9,
            mem_bytes=gflops * 1e9 * 0.6,
            data_in=_kb(540.47),
            data_out=_kb(200.0),  # rendered frame delta streamed back
            latency_req=QOS_ARVR_LATENCY_S,
            continuous=1.0,
            fps_req=1.0 / QOS_ARVR_LATENCY_S,
        ),
        # on the headset/Jetson or streamed from the DC (§4.1/§5.1)
        available_targets=(True, False, True),
    )


ARVR_WORKLOADS: tuple[ARVRInfo, ...] = (
    _arvr("vr-3d-world-sponza", 9.5),  # heavy: misses mobile latency budget
    _arvr("vr-3d-material", 2.8),
    _arvr("vr-3d-cartoon", 2.4),
    _arvr("ar-demo", 3.6),
)


ALL_PAPER_WORKLOADS: tuple[WorkloadInfo, ...] = (
    AI_WORKLOADS + GAME_WORKLOADS + ARVR_WORKLOADS
)


def by_name(name: str) -> WorkloadInfo:
    for info in ALL_PAPER_WORKLOADS:
        if info.name == name:
            return info
    raise KeyError(name)


def stack_workloads(infos, *, device: str | torch.device = "cuda"
                    ) -> Workload:
    """Stack descriptors into one Workload with a leading axis, on
    ``device``. Accepts ``WorkloadInfo`` or bare ``Workload`` entries."""
    dev = resolve_device(device)
    ws = [i.workload if isinstance(i, WorkloadInfo) else i for i in infos]
    return Workload(*[torch.stack([getattr(w, f.name).to(dev) for w in ws])
                      for f in dataclasses.fields(Workload)])


# --- LM workloads (beyond-paper) -----------------------------------------------


def lm_workload(*, flops_per_token: float, params_bytes: float, seq_len: int,
                new_tokens: int, bytes_per_token_in: float = 4.0,
                bytes_per_token_out: float = 4.0, latency_req: float = 0.5,
                device: str | torch.device = "cuda") -> Workload:
    """Descriptor for one LM inference request (prefill + decode);
    ``params_bytes`` bounds the memory-bound decode side."""
    total_tokens = seq_len + new_tokens
    return Workload.make(
        flops=flops_per_token * total_tokens,
        mem_bytes=params_bytes * new_tokens,  # weights re-read every step
        data_in=bytes_per_token_in * seq_len,
        data_out=bytes_per_token_out * new_tokens,
        latency_req=latency_req,
        device=device,
    )
