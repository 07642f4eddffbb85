"""Distribution layer: per-architecture partition rules over the production
mesh, as placement lists of a ``DeviceMesh``."""

from repro_torch.sharding.rules import (
    MeshAxes,
    batch_sharding,
    decode_state_sharding,
    enforce_divisible,
    local_shape,
    logical_param_spec,
    param_shardings,
    placements,
    spec_tree,
)
