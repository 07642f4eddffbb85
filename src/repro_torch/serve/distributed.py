"""Sharded routing over ``torch.distributed`` (port of
``src/repro/serve/distributed.py``).

The reference is single-controller: one host holds the stream and
``shard_map`` scatters it over a device mesh. Here one process runs each
rank, and every rank calls the router with the same whole stream (streams
are made from numpy seeds, so every rank makes the same one). Each rank
then:

  * sorts the stream on the host by the policy's admission-segment key
    (the ``stream_order_key`` the single-rank path already uses), pads it
    to a multiple of the rank count with unroutable dummies carrying the
    largest segment key (last region, last hour, no tier available, slack
    0), and takes its own contiguous shard, so every row of an earlier
    rank precedes every local row in stream order and the local rows stay
    segment-sorted;
  * runs the single-rank program on its shard (``FleetRouter._route_rows``
    with the identity order), the process group passed down as
    ``axis_name``: each admission round lifts local ranks and per-cell
    totals to global ones with one all-gather of the int32 totals
    (``placement.device_prefix_ranks``), and the loop condition is an
    all-reduced any, so every rank runs the same rounds and the capacity
    ledger advances identically on each;
  * all-gathers the per-row outputs (equal shards), drops the pads,
    unsorts, and aggregates them with the single-rank route's own
    ``FleetRouter._aggregate``, on the device.

All the counting is int32, so the decisions are bit-identical to the
single-rank program at every world size; the gathered rows are then the
same bits in the same order as the single-rank route's, so every
aggregate, routed gCO2 included, is too. Per-row policies
(``OraclePolicy``, ``LearnedPolicy``) need no collective but the final
gather; ``CapacityLimiter`` is refused, with the reference's pointer to
``PlacementPolicy``.

Collectives keep their tensors on the card over NCCL and copy them to the
host over gloo (``placement._host_staged``), chosen by the group's backend.
NCCL takes one rank a card; ranks that share a card, or run on the CPU,
use gloo. The reference's persistent compile cache and buffer donation
have no eager counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.serve.forecast import slice_batch
from repro_torch.serve.placement import (
    PlacementState,
    all_gather_rows,
)
from repro_torch.serve.policy import (
    CAPACITY_LIMITER_UNSHARDED,
    CapacityLimiter,
)
from repro_torch.serve.temporal import TemporalState

#: name of the 1-D routing mesh's dimension
DATA_AXIS = "data"

# per-row outputs gathered as one int32 and one float32 block
_INT_ROWS = ("target", "exec_region", "feas", "shed", "exec_hour", "defer")
_F32_ROWS = ("carbon", "ref_latency", "ref_energy", "ref_oracle")


def data_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
              device: str | torch.device = "cuda"):
    """A 1-D ``DeviceMesh`` over the first ``n_devices`` ranks (all of them
    by default) of the initialized default process group. Every rank
    calls it. ``device`` (default ``"cuda"``) is the mesh's device type;
    without a CUDA device only ``device="cpu"`` is accepted."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs an initialized process group: "
                           "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices must be in [1, {world}], got {n}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def _check_mesh(mesh):
    """The process group of a 1-D mesh this rank belongs to."""
    if mesh.ndim != 1:
        raise ValueError(
            f"the routing hot path shards over ONE data axis, got mesh "
            f"dimensions {mesh.mesh_dim_names} — pass a 1-D (sub)mesh, "
            f"e.g. mesh[{DATA_AXIS!r}]")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the routing mesh")
    return mesh.get_group(0)


def route_arrays_sharded(fr, batch, region_np, hour_np, mesh, *,
                         ci_fc=None, cap_scale=None, used0=None,
                         slack_np=None):
    """Sharded twin of ``FleetRouter._route_arrays``: the same prepared
    arrays in, the same ``(FleetRouteResult, state)`` out on every rank,
    with decisions bit-identical to the single-rank program at every world
    size (see the module docstring)."""
    policy = fr.policy
    if isinstance(policy, CapacityLimiter):
        raise NotImplementedError(CAPACITY_LIMITER_UNSHARDED)
    group = _check_mesh(mesh)
    n_ranks, me = group.size(), group.rank()
    n = len(batch)
    n_regions = len(fr.regions)
    dev = fr.device
    region_np = np.asarray(region_np, np.int32)
    hour_np = np.asarray(hour_np, np.int32)

    # --- host sort into admission-segment order ----------------------------
    sort = fr._stream_order(region_np, hour_np)
    # per-row policy: no segments, keep stream order
    order_np = np.arange(n, dtype=np.int64) if sort is None else sort[0]

    # --- pad to a rank multiple with max-key dummies, take this shard -----
    # at least one row a rank: a rank without rows would skip the
    # admission rounds' collectives and leave the others waiting
    n_pad = max(-(-n // n_ranks) * n_ranks, n_ranks)
    per = n_pad // n_ranks
    idx = order_np[me * per:min((me + 1) * per, n)]
    fill = per - len(idx)
    pad = lambda a, v: np.concatenate([a[idx], np.full(fill, v, a.dtype)])
    slack_base = np.asarray(
        batch.slack_h if slack_np is None else slack_np, np.int32)
    local = slice_batch(batch, idx, per)
    ident = torch.arange(per, device=dev)
    state0 = policy.initial_state(n_regions, per)
    rows, state = fr._route_rows(
        local.workload(fr.cfg, device=dev), local.avail(device=dev),
        torch.as_tensor(pad(region_np, n_regions - 1), device=dev).long(),
        torch.as_tensor(pad(hour_np, fr._horizon_h - 1), device=dev).long(),
        fr._ci_table, fr._ci_fc if ci_fc is None else ci_fc, state0,
        ident, ident, torch.as_tensor(pad(slack_base, 0), device=dev),
        cap_scale, used0, axis_name=group)

    # --- gather, unpad, unsort: the whole stream's rows on every rank -----
    inv = None if sort is None else torch.as_tensor(sort[1], device=dev)

    def gather(names, dtype):
        names = [k for k in names if rows[k] is not None]
        block = torch.stack([rows[k].to(dtype) for k in names], dim=1)
        full = all_gather_rows(block, group).reshape(n_pad, len(names))[:n]
        if inv is not None:
            full = full[inv]
        for j, k in enumerate(names):  # contiguous, as the single-rank
            # route's rows are: a strided sum reduces in another order
            rows[k] = full[:, j].to(rows[k].dtype).contiguous()

    gather(_INT_ROWS, torch.int32)
    gather(_F32_ROWS, torch.float32)
    # --- the single-rank aggregates on the gathered rows ------------------
    region = torch.as_tensor(region_np, device=dev).long()
    return fr._aggregate(rows, region), _rebuild_state(policy, state, rows)


def _rebuild_state(policy, state, rows):
    """The policy's state over the whole stream: the replicated ``counts``
    and ``shed_pair`` of the local state (reconciled over the ranks) and
    the gathered per-row fields."""
    counts = getattr(state, "counts", None)
    if counts is None:  # stateless per-row policy
        return ()
    if rows["exec_hour"] is not None:
        return TemporalState(
            counts=counts, shed=rows["shed"],
            exec_region=rows["exec_region"], shed_pair=state.shed_pair,
            exec_hour=rows["exec_hour"], defer_hours=rows["defer"])
    return PlacementState(
        counts=counts, shed=rows["shed"],
        exec_region=(None if state.exec_region is None
                     else rows["exec_region"]),
        shed_pair=state.shed_pair)
