"""What one device's ops cost: FLOPs, bytes accessed, collective bytes and
the peak of the memory they allocate, counted by one
``TorchDispatchMode`` over eager code, on meta tensors or on the card.

``DeviceCostMode`` is the port's counterpart of what the reference reads
from a compiled SPMD module (``cost_analysis``, ``memory_analysis`` and
the collectives of its HLO text, ``src/repro/launch/dryrun.py``). Every
aten op that runs inside the mode passes through it once, after autograd
and after any ``CompositeImplicitAutograd`` decomposition, so the same
code counts the same ops whether its tensors live on ``meta`` or on a
card. It records:

* ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s registry,
  the formulas ``FlopCounterMode`` applies.
* ``bytes_accessed``: XLA's ``HloCostAnalysis`` convention, the bytes of
  each tensor operand plus each tensor result of every op that computes.
  An op counts 0 when its schema marks no return as written and every
  output shares an input's storage: views, ``detach``, ``expand``,
  ``t`` / ``transpose``, and ``_unsafe_view`` (whose schema carries no
  alias annotation). An in-place op computes, and counts its mutated
  input as an operand and as its result. Collectives are left out (they
  have their own count). A tensor counts its logical elements, so an
  expanded operand counts its expanded size. Eager PyTorch fuses nothing:
  every intermediate goes through memory, so this is an upper bound on
  what a fused program of the same ops would move.
* ``collective_bytes``: by kind (``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``all_to_all``; any other ``_c10d_functional``
  collective under its own name): each op counts
  max(operand bytes, result bytes), the reference's rule
  (``collective_bytes`` there: an all-gather's traffic shows in its
  result, a reduce-scatter's in its operand). ``wait_tensor`` and
  ``_wrap_tensor_autograd`` move nothing. ``collective_counts`` counts the
  ops by the same kinds, and ``collective_groups`` keeps the bytes by
  (kind, group size, lowest and highest global rank of the group), which
  is what pricing each op on the link its group spans needs.
* ``peak_live_bytes``: the largest total, at any point inside the mode,
  of the tensor storages created inside it and still alive. A storage
  counts once however many views share it, and leaves the total when it
  is freed (a ``weakref.finalize`` on the storage). Storages that existed
  before the mode (weights, optimizer state, inputs) are not in it.
  ``mark()`` ends a phase (a training step's backward, say): its own peak
  goes to ``phase_peaks``.

Ops on a tensor subclass (``DTensor``) are passed on to the subclass,
which runs plain ops on its local tensors; the mode sees those. DTensor's
sharding propagation may run extra ops on meta tensors there: read only
the collectives of a block that computes on DTensors.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
# the functional collectives' bookkeeping ops: no data moves
_NO_TRAFFIC = ("wait_tensor", "_wrap_tensor_autograd")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    or results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _collective_kind(name: str) -> str:
    """The kind of a ``_c10d_functional`` op by its name:
    ``all_gather_into_tensor`` -> ``all_gather``, coalesced forms too."""
    return next((k for k in COLLECTIVES if name.startswith(k)), name)


def _group_ranks(func, args, kwargs) -> list[int]:
    """Global ranks of the process group a functional collective names."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    i = names.index("group_name")
    name = args[i] if i < len(args) else kwargs["group_name"]
    return dist.get_process_group_ranks(_resolve_process_group(name))


class DeviceCostMode(TorchDispatchMode):
    """Counts what the ops inside the block cost one device (module
    docstring). Use as ``with DeviceCostMode() as cost: ...``."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_accessed = 0
        self.collective_bytes: collections.Counter = collections.Counter()
        self.collective_counts: collections.Counter = collections.Counter()
        # (kind, group size, lowest rank, highest rank) -> bytes
        self.collective_groups: collections.Counter = collections.Counter()
        self.flops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.phase_peaks: list[int] = []
        self._phase_peak = 0
        self._live: dict[int, int] = {}
        from torch.distributed.tensor import DTensor
        self._subclass = DTensor

    def mark(self) -> None:
        """Ends a phase: its peak of live bytes goes to ``phase_peaks``,
        and the next phase's starts from the bytes alive now."""
        self.phase_peaks.append(self._phase_peak)
        self._phase_peak = self.live_bytes

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, outs: list[torch.Tensor], seen: set[int]) -> None:
        for t in outs:
            key = _storage_key(t)
            if key in seen or key in self._live:
                continue
            st = t.untyped_storage()
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._release, key)
        self._phase_peak = max(self._phase_peak, self.live_bytes)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._subclass) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        self._track(outs, in_keys)
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name not in _NO_TRAFFIC:
                kind = _collective_kind(name)
                moved = max(sum(map(nbytes, ins)), sum(map(nbytes, outs)))
                ranks = _group_ranks(func, args, kwargs)
                self.collective_bytes[kind] += moved
                self.collective_counts[kind] += 1
                self.collective_groups[(kind, len(ranks), min(ranks),
                                        max(ranks))] += moved
            return out
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        written = any(r.alias_info is not None and r.alias_info.is_write
                      for r in func._schema.returns)
        if not written and outs and all(_storage_key(t) in in_keys
                                        for t in outs):
            return out  # a view: nothing computed, nothing moved
        self.bytes_accessed += sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        return out
