"""Atomic, resumable checkpoint store (port of
``src/repro/checkpoint/store.py``).

* **Atomic**: leaves are written into ``step_<n>.tmp-<pid>`` and the
  directory is renamed into place last: a reader never sees a partial
  checkpoint; a crashed writer leaves only a ``.tmp`` directory.
* **Device-independent**: leaves are saved whole, on the host, as
  ``.npy`` files with a JSON manifest keyed by the leaf's path
  (``params/layers.3.attn.wq``, ``opt/mu/embed``, ``opt/count``);
  ``restore`` places them on the device it is given.
* **Resumable**: ``latest_step`` scans the directory; tmp and partial
  (manifest-less) directories are ignored.

A tree is any nesting of dicts, lists, tuples, NamedTuples and dataclasses
(a ``TrainState``) over tensors or numpy arrays; ``None`` holds no leaf.
numpy has no bfloat16, so a bfloat16 leaf is stored as its uint16 bits
with ``"dtype": "bfloat16"`` in the manifest.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import torch

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs in a fixed order; None holds no leaf."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _flatten(child, f"{prefix}/{key}" if prefix else str(key))


def _rebuild(tree, leaves, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    new = {key: _rebuild(child, leaves,
                         f"{prefix}/{key}" if prefix else str(key))
           for key, child in kids}
    if isinstance(tree, dict):
        return new
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **new)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**new)
    return type(tree)(new[i] for i in range(len(tree)))


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(directory: str, tree) -> None:
    """Write a tree of tensors into ``directory`` (non-atomic inner op)."""
    os.makedirs(directory, exist_ok=True)
    manifest = {}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        name = f"leaf_{i:05d}.npy"
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(directory, name), arr)
        manifest[path] = {"file": name, "shape": list(arr.shape),
                          "dtype": dtype}
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def restore_pytree(directory: str, template,
                   device: str | torch.device | None = None):
    """Load into the structure of ``template`` as tensors on ``device``
    (default: each template leaf's device, the CPU for a numpy leaf).
    Raises KeyError on a missing leaf and ValueError on a wrong shape."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = {}
    for path, leaf in _flatten(template):
        if path not in manifest:
            raise KeyError(f"checkpoint {directory} missing leaf {path}")
        entry = manifest[path]
        arr = np.load(os.path.join(directory, entry["file"]))
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != {want}")
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        leaves[path] = _to_tensor(arr, entry["dtype"]).to(dev)
    return _rebuild(template, leaves)


def save(root: str, step: int, tree) -> str:
    """Atomic checkpoint: write a tmp dir, fsync the manifest, rename it
    into place."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    try:
        save_pytree(tmp, tree)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return final


def latest_step(root: str) -> int | None:
    """Newest complete checkpoint step in ``root`` (tmp dirs ignored)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def prune(root: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoints in
    ``root``."""
    steps = sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                 os.listdir(root)) if m)
    for step in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(root, f"step_{step}"))


def restore(root: str, step: int, template,
            device: str | torch.device | None = None):
    return restore_pytree(os.path.join(root, f"step_{step}"), template,
                          device)
