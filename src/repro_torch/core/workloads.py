"""Workload descriptors (paper §4.1) as dataclasses of float32 tensors.

Port of ``Workload``, ``Workload.make`` and ``batch_workloads`` from the
reference ``core/workloads.py``. Callers compute the descriptor numbers on
the host in float64 (e.g. ``2 * N_active * tokens``) and the constructors
round them to float32 once, as ``jnp.asarray(x, jnp.float32)`` does: taking
the product in float32 would change the FLOP count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


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
