"""Production mesh definitions, port of ``src/repro/launch/mesh.py``.

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
which must be initialized with the mesh's size. ``fake_world(n)`` starts
torch's fake process group of ``n`` ranks in this one process (no cards,
no communication: a collective returns at once), which is what the dry
run and the tests lower onto, as the reference lowers onto 512 virtual
host devices. On the card a (1, 1) mesh runs over a real NCCL world of 1.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

SINGLE_POD = (16, 16)  # ("data", "model"): 256 chips
MULTI_POD = (2, 16, 16)  # ("pod", "data", "model"): 512 chips


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks (this process is rank
    0) for the block, destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device: str | torch.device):
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda"):
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips).

    Axes: DP over ("pod", "data"), TP/EP over "model"."""
    if multi_pod:
        return _mesh(MULTI_POD, ("pod", "data", "model"), device)
    return _mesh(SINGLE_POD, ("data", "model"), device)


def make_mesh(n_data: int, n_model: int, n_pod: int = 1, *,
              device: str | torch.device = "cuda"):
    """Arbitrary mesh for tests / elastic reconfigurations."""
    if n_pod > 1:
        return _mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                     device)
    return _mesh((n_data, n_model), ("data", "model"), device)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def mesh_name(mesh) -> str:
    """"16x16", "2x16x16": the reference's mesh label."""
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
