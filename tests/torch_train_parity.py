"""Helpers of ``tests/test_torch_compression.py`` that its spawned ranks
import. Nothing here imports JAX, so each child pays only for torch.

A world is started by ``run_world``: ``world`` processes (start method
``spawn``), each joining a gloo group through a FileStore under the given
directory (no TCP port, so concurrent test workers cannot collide), one
torch thread each. Every rank

* runs ``compress_and_reduce`` in each compressed mode for ``ITERS``
  iterations on its own seeded gradients (``fake_grads``), starting from
  a seeded residual, and records each iteration's mean and residual;
* trains the h2o-danube-1.8b smoke model, loaded from the parameters in
  ``<dir>/case.npz``, for ``STEPS`` steps in each mode of ``MODES`` under
  ``data_mesh(world)``, on its contiguous slice of the global batches in
  the same file, and records the losses, grad norms and final parameters;

and writes it all to ``<dir>/rank<r>.npz``."""

import datetime
import os
import time

import numpy as np

ARCH = "h2o-danube-1.8b"
MODES = ("int8", "bf16", "none")
STEPS = 2
ITERS = 2
LR = 1e-3
TIMEOUT_S = 120


def fake_grads(rank: int, it: int) -> dict:
    """Rank ``rank``'s seeded float32 gradients at iteration ``it``."""
    rng = np.random.default_rng(1000 * rank + it)
    return {"w": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
            "b": (rng.standard_normal((3,)) * 0.01).astype(np.float32),
            "s": np.asarray(rng.standard_normal(()), np.float32)}


def fake_residual(rank: int) -> dict:
    rng = np.random.default_rng(7 + rank)
    return {k: np.asarray(rng.standard_normal(v.shape) * 1e-3, np.float32)
            for k, v in fake_grads(0, 0).items()}


def rank_main(rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serve import data_mesh
    from repro_torch.train import adamw, constant_lr, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.compression import compress_and_reduce

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = {}
        group = dist.group.WORLD
        for mode in MODES[:2]:
            ef = {k: torch.from_numpy(v) for k, v in
                  fake_residual(rank).items()}
            for it in range(ITERS):
                grads = {k: torch.from_numpy(v) for k, v in
                         fake_grads(rank, it).items()}
                mean, ef = compress_and_reduce(grads, ef, mode=mode,
                                               group=group, n_dp=world)
                for k in mean:
                    out[f"reduce/{mode}/{it}/mean/{k}"] = mean[k].numpy()
                    out[f"reduce/{mode}/{it}/ef/{k}"] = ef[k].numpy()

        case = np.load(os.path.join(workdir, "case.npz"))
        model = Transformer(get_config(ARCH, smoke=True), device="cpu")
        names = [n for n, _ in model.named_parameters()]
        mesh = data_mesh(world, device="cpu")
        for mode in MODES:
            opt = adamw(constant_lr(LR))
            state = init_train_state(
                {n: torch.from_numpy(case[f"param/{n}"]).clone()
                 for n in names}, opt, compression=mode)
            step = make_train_step(model, opt, mesh=mesh, compression=mode)
            for i in range(STEPS):
                batch = {}
                for k in ("tokens", "labels"):
                    rows = case[f"batch/{i}/{k}"]
                    per = rows.shape[0] // world
                    batch[k] = torch.from_numpy(
                        rows[rank * per:(rank + 1) * per]).long()
                state, m = step(state, batch)
                out[f"train/{mode}/loss/{i}"] = float(m["loss"])
                out[f"train/{mode}/grad_norm/{i}"] = float(m["grad_norm"])
            for n in names:
                out[f"train/{mode}/param/{n}"] = state.params[n].numpy()
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_world(world: int, workdir: str) -> list[dict]:
    """Run ``world`` ranks of ``rank_main`` and return their records; a
    rank that fails or outlives ``TIMEOUT_S`` fails the caller, and none
    is left running."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(rank_main, args=(world, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world}: ranks still running "
                                   f"after {TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]
