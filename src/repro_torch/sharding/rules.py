"""Partition rules for every parameter, batch and cache leaf of the model
zoo, port of ``src/repro/sharding/rules.py``.

Sharding scheme (Megatron-style TP x DP, plus EP for MoE), as in the
reference:

  * batch dims shard over the data axes (``("pod", "data")`` multi-pod,
    ``"data"`` single-pod): pure DP, gradient all-reduce over data axes.
  * attention: wq/wk/wv column-parallel over ``model`` (heads split), wo
    row-parallel: one all-reduce per attention block.
  * MLP: gate/up column-parallel, down row-parallel: one all-reduce.
  * MoE: experts shard over ``model`` (expert parallelism). Router
    replicated.
  * Mamba: z/x/dt projections and conv column-parallel over SSM heads;
    the B/C streams replicated; out_proj row-parallel.
  * embedding vocab-parallel; lm_head column-parallel over vocab.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim shards over their product,
the first the outermost), as ``PartitionSpec`` is in the reference. Rules
are by leaf name and rank, so one table covers every architecture. The
port keeps one module per layer, so no leaf carries the reference's
stacked super-block axis and no spec its leading ``None``. ``placements``
turns a spec into the ``Shard(i)`` / ``Replicate()`` list of a
``DeviceMesh``.

``decode_state_sharding`` keeps the layout the reference's rules give in
effect: its name rules read ``.key`` from the tree path, which JAX's
dataclass entries (``DecodeState``, ``KVCache``, ``SSMState`` fields) do
not carry, so every cache leaf falls to the generic rule, batch over the
data axes and the rest replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Union

from torch.distributed.tensor import Replicate, Shard

Axes = Union[None, str, tuple]
Spec = tuple


def _mesh_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (a mapping passes through)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(_mesh_names(mesh))}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis names of the production mesh."""

    data: tuple[str, ...] = ("data",)  # ("pod", "data") multi-pod
    model: str = "model"
    #: weight/optimizer-state sharding axis (ZeRO/FSDP). None = pure DP
    #: (weights replicated across data). FSDP shards within a pod only.
    fsdp: str | None = None

    @staticmethod
    def for_mesh(mesh, fsdp: bool = False) -> "MeshAxes":
        names = tuple(axis_sizes(mesh))
        data = tuple(n for n in names if n != "model")
        return MeshAxes(data=data, model="model",
                        fsdp=(data[-1] if fsdp and data else None))


# --- per-leaf logical rules ----------------------------------------------------


def logical_param_spec(key: str, ndim: int, m: MeshAxes) -> Spec:
    """Spec of one parameter leaf by its name and rank.

    With ``m.fsdp`` set (training), the dim not consumed by tensor
    parallelism also shards over the fsdp axis (ZeRO-3 style)."""
    mdl = m.model
    f = m.fsdp  # None -> that dim stays replicated (pure DP)
    # --- embeddings / head ---
    if key == "embed":
        return (mdl, f)  # vocab-parallel (+ fsdp on d)
    if key == "lm_head":
        return (f, mdl)
    if key == "pos_embed":
        return ()
    # --- attention ---
    if key in ("wq", "wk", "wv"):
        return (f, mdl)  # column-parallel (heads split)
    if key == "wo":
        return (mdl, f)  # row-parallel
    if key in ("bq", "bk", "bv"):
        return (mdl,)
    # --- dense FF ---
    if key in ("w_gate", "w_up") and ndim == 2:
        return (f, mdl)
    if key == "w_down" and ndim == 2:
        return (mdl, f)
    if key == "w1":
        return (f, mdl)
    if key == "b1":
        return (mdl,)
    if key == "w2":
        return (mdl, f)
    if key == "b2":
        return ()
    # --- MoE (expert-parallel over `model`) ---
    if key == "router":
        return ()
    if key in ("w_gate", "w_up", "w_down") and ndim == 3:
        return (mdl, f, None)
    # --- mamba ---
    if key in ("z_proj", "x_proj", "dt_proj"):
        return (f, mdl)
    if key == "bc_proj":
        return (f, None)
    if key == "conv_x_w":
        return (None, mdl)
    if key == "conv_x_b":
        return (mdl,)
    if key in ("conv_bc_w", "conv_bc_b"):
        return ()
    if key in ("A_log", "D", "dt_bias"):
        return (mdl,)
    if key == "norm_scale":
        return (mdl,)
    if key == "out_proj":
        return (mdl, f)
    # --- norms and anything small ---
    return ()


def _axes_tuple(axes: Axes) -> tuple[str, ...]:
    return () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))


def enforce_divisible(mesh, spec: Spec, shape: tuple[int, ...]) -> Spec:
    """Drop sharded axes whose dimension is not divisible by the axis size
    (mamba2's vocab 50280 over model=16, long_500k's global_batch=1 over
    data=16): that dim falls back to replication. ``mesh``: a
    ``DeviceMesh`` or {axis name: size}. A one-name tuple becomes the name,
    as ``PartitionSpec`` normalises it."""
    sizes = axis_sizes(mesh)
    new = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axes is None:
            new.append(None)
            continue
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]
        size = math.prod(sizes[a] for a in _axes_tuple(axes))
        new.append(axes if dim % size == 0 else None)
    return tuple(new)


def placements(mesh, spec: Spec) -> list:
    """The ``DeviceMesh`` placements of a spec: ``Shard(i)`` on each mesh
    dim that names tensor dim i, ``Replicate()`` on the others."""
    out = []
    for name in _mesh_names(mesh):
        dims = [i for i, axes in enumerate(spec) if name in _axes_tuple(axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(mesh, spec: Spec, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The shard shape one device holds (the spec divides ``shape``)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in _axes_tuple(axes))
                 for d, axes in zip(shape, spec))


def _named_shapes(params) -> dict[str, tuple[int, ...]]:
    """{name: shape} of a module's parameters or of a ``param_specs``
    dict {name: (shape, dtype)} or {name: tensor}."""
    if hasattr(params, "named_parameters"):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(v[0] if isinstance(v, tuple) else v.shape)
            for n, v in params.items()}


def spec_tree(params, m: MeshAxes) -> dict[str, Spec]:
    """{parameter name: spec} by the leaf's last name and rank."""
    return {name: logical_param_spec(name.rsplit(".", 1)[-1], len(shape), m)
            for name, shape in _named_shapes(params).items()}


def param_shardings(mesh, params, *, fsdp: bool = False) -> dict[str, Spec]:
    """{parameter name: spec} after ``enforce_divisible``. ``fsdp=True``
    (training): weights and optimizer moments also shard over the
    innermost data axis. Serving keeps fsdp=False."""
    m = MeshAxes.for_mesh(mesh, fsdp=fsdp)
    shapes = _named_shapes(params)
    return {name: enforce_divisible(mesh, spec, shapes[name])
            for name, spec in spec_tree(params, m).items()}


# --- activations / batch ---------------------------------------------------------


def batch_sharding(mesh, batch: dict) -> dict[str, Spec]:
    """Batch specs: leading batch dim over the data axes; ``positions``
    (3, B, S) has batch second."""
    m = MeshAxes.for_mesh(mesh)
    out = {}
    for name, leaf in batch.items():
        if name == "positions":
            spec = (None, m.data, None)
        else:
            spec = (m.data,) + (None,) * (leaf.ndim - 1)
        out[name] = enforce_divisible(mesh, spec, tuple(leaf.shape))
    return out


def decode_state_leaves(state) -> dict[str, object]:
    """{path: leaf} of a ``DecodeState``: ``caches.{i}.{k,v,length}`` or
    ``caches.{i}.{conv_x,conv_bc,ssm}``, ``cross_kv.{i}.{0,1}``, ``step``."""
    out: dict[str, object] = {}
    for i, cache in enumerate(state.caches):
        for f in dataclasses.fields(cache):
            out[f"caches.{i}.{f.name}"] = getattr(cache, f.name)
    for i, kv in enumerate(state.cross_kv):
        if kv is not None:
            out[f"cross_kv.{i}.0"], out[f"cross_kv.{i}.1"] = kv
    out["step"] = state.step
    return out


def decode_state_sharding(mesh, state) -> dict[str, Spec]:
    """{path: spec} of every tensor leaf of a ``DecodeState``: batch over
    the data axes, the rest replicated (the reference's effective layout,
    see the module docstring). Python-int leaves (``length``, ``step``)
    have no spec."""
    m = MeshAxes.for_mesh(mesh)
    out = {}
    for name, leaf in decode_state_leaves(state).items():
        if isinstance(leaf, int):
            continue
        spec = (m.data,) + (None,) * (leaf.ndim - 1)
        out[name] = enforce_divisible(mesh, spec, tuple(leaf.shape))
    return out
