"""Helpers of ``tests/test_torch_distributed.py`` that its spawned ranks
import: the numpy streams, the port's routers, and the rank body. Nothing
here imports JAX, so each child process pays only for torch; the reference
side runs in the test's own process.

A world is started by ``run_world``: ``world`` processes (start method
``spawn``), each joining a gloo group through a FileStore under the given
directory (no TCP port, so concurrent test workers cannot collide), one
torch thread each. Every rank routes every case with the whole stream
under ``data_mesh(world)``, its tensors on the given device (the CPU, or
one card all ranks share), and writes its results to
``<out>/rank<r>.npz``."""

import contextlib
import datetime
import os
import time

import numpy as np

ARCH = "h2o-danube-1.8b"
R = 4
CAPS = 25.0
#: the reference's invariance stream size (tests/test_distributed.py),
#: deliberately not a multiple of any world size
N_INVARIANCE = 515
#: (router, n) pairs every spawned world routes; n = 3 gives a world of
#: 4 a rank of pads only
WORLD_CASES = (("placement-cross", N_INVARIANCE),
               ("temporal-joint", N_INVARIANCE),
               ("placement-cross", 3), ("temporal-joint", 3))
N_SERVE = 300
RESULT_FIELDS = ("target", "feasible", "exec_region", "carbon_g", "counts",
                 "infeasible_count",
                 "total_carbon_g", "routed_carbon_g", "shed_count",
                 "spilled_count", "deferred_count", "mean_defer_hours")
STATE_FIELDS = ("counts", "shed", "shed_pair", "exec_hour", "defer_hours")
SERVED_FIELDS = ("target", "exec_region", "exec_hour", "defer_hours", "shed",
                 "step", "carbon_g")
TIMEOUT_S = 120


@contextlib.contextmanager
def one_rank_world(workdir, backend: str = "gloo", device: str = "cpu"):
    """A world of this process alone (a FileStore under ``workdir``) and
    its 1-D mesh on ``device``; the group is destroyed on exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.serve import data_mesh

    if device == "cuda":  # the communicator binds the current card
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        yield data_mesh(1, device=device)
    finally:
        dist.destroy_process_group()


def invariance_stream(n: int):
    """The reference's invariance stream (``tests/test_distributed.py``'s
    subprocess matrix), cut or grown to ``n`` rows by its own seed:
    ``(RequestBatch fields, region, t_hours)`` as numpy."""
    rng = np.random.default_rng(0)
    cols = dict(
        prompt_tokens=rng.integers(16, 512, n).astype(np.float64),
        max_new_tokens=rng.integers(16, 256, n).astype(np.float64),
        latency_budget_s=rng.uniform(0.3, 4.0, n),
        bytes_per_token=np.full(n, 4.0),
        available=rng.random((n, 3)) > 0.1,
        slack_hours=rng.integers(0, 6, n).astype(np.float64))
    return cols, rng.integers(0, R, n), rng.uniform(0, 24, n)


def port_router(name: str, caps: float = CAPS, *, mesh=None,
                device: str = "cpu"):
    """The port's ``placement-cross`` or ``temporal-joint`` router of the
    invariance matrix (the smoke config, the fully connected grid, ``caps``
    a cell), sharded over ``mesh`` when given."""
    from repro_torch.configs import get_config
    from repro_torch.core.carbon_intensity import DEFAULT_REGIONS, CarbonGrid
    from repro_torch.serve import (FleetRouter, OraclePolicy,
                                   PlacementPolicy, TemporalPolicy)

    cfg = get_config(ARCH, smoke=True)
    infra = FleetRouter(cfg, device=device).infra
    cap = np.full((R, 3), caps)
    policy = (PlacementPolicy(OraclePolicy(infra), cap)
              if name == "placement-cross"
              else TemporalPolicy(OraclePolicy(infra), cap, max_defer_h=6))
    return FleetRouter(cfg, device=device, policy=policy, mesh=mesh,
                       grid=CarbonGrid.fully_connected(DEFAULT_REGIONS,
                                                       device=device))


def port_batch(cols):
    from repro_torch.serve import RequestBatch

    return RequestBatch(**cols)


def flatten(res, state, prefix: str) -> dict:
    """A fleet result and its state as ``{prefix/field: array}``."""
    out = {f"{prefix}/{f}": np.asarray(getattr(res, f).cpu())
           for f in RESULT_FIELDS}
    for f in STATE_FIELDS:
        x = getattr(state, f, None)
        if x is not None:
            out[f"{prefix}/state.{f}"] = np.asarray(x.cpu())
    return out


def served(mesh=None):
    """``serve_stream`` of the invariance stream's first ``N_SERVE`` rows,
    none of them able to run on the device, through the
    ``placement-cross`` router at 2 a cell and one one-slot worker a
    (region, DC tier), so that it spills and sheds; sharded over ``mesh``
    when given."""
    from repro_torch.serve import WorkerPool, serve_stream

    cols, region, t = invariance_stream(N_SERVE)
    cols["available"][:, 0] = False
    pool = WorkerPool(R, slots_per_worker=1.0, launch_delay_steps=0)
    for r in range(R):
        for tier in (1, 2):
            pool.launch(r, tier, n=1)
    return serve_stream(port_router("placement-cross", 2.0, mesh=mesh),
                        port_batch(cols), region, t, pool=pool)


def rank_main(rank: int, world: int, store: str, out: str, device: str,
              cases, serve: bool) -> None:
    """One rank: join the gloo group, route every ``(router, n)`` case with
    its tensors on ``device`` (and the served seam when ``serve``), save
    the results."""
    import torch
    import torch.distributed as dist

    from repro_torch.serve import data_mesh

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = data_mesh(world, device=torch.device(device).type)
        results = {}
        for name, n in cases:
            cols, region, t = invariance_stream(n)
            res, state = port_router(name, device=device
                                     ).route_stream_with_state(
                port_batch(cols), region, t, mesh=mesh)
            results.update(flatten(res, state, f"{name}@{n}"))
        if serve:
            q = served(mesh)
            results.update({f"serve/{f}": getattr(q, f)
                            for f in SERVED_FIELDS})
        np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()


def run_world(world: int, workdir: str, device: str = "cpu",
              cases=WORLD_CASES, serve: bool = True) -> list[dict]:
    """Spawn ``world`` ranks of ``rank_main`` and return each rank's
    results; a rank that fails or outlives ``TIMEOUT_S`` fails the call,
    and no rank is left running."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(
        rank_main, args=(world, os.path.join(workdir, "store"), workdir,
                         device, tuple(cases), serve),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world} still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]
