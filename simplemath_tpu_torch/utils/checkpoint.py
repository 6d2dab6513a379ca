"""Checkpoint / resume of solver state.

Counterpart of ``simplemath_tpu/utils/checkpoint.py``, with its directory
layout: ``meta.json`` (the backend and the caller's metadata),
``treedef.json`` (the structure's fingerprint and ``n_leaves``) and the
leaves.  Here the leaves are one ``torch.save`` of the flat leaf list
(``state.pt``; bfloat16 has no numpy type, so npz cannot hold it), read
back with ``weights_only=True``.

``restore`` checks the stored structure against ``like``, so a mismatch is
a clear error at the checkpoint boundary, and puts every tensor leaf on
``config.device``.  It also reads a checkpoint that the JAX package wrote
with its npz backend (``state.npz``, ``leaf_<i>``): a JAX treedef string
cannot equal a torch ``TreeSpec``'s, so there the number of leaves and each
leaf's shape are checked against ``like``.  An orbax checkpoint cannot be
read without JAX and raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree

from ..config import config


def save(path: str, state: Any, metadata: Optional[Dict] = None) -> None:
    """Save a pytree of tensors to ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    flat, spec = _pytree.tree_flatten(state)
    torch.save(flat, os.path.join(path, "state.pt"))
    # The TreeSpec string is the structure fingerprint `restore` checks.
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump({"treedef": str(spec), "n_leaves": len(flat)}, f)
    meta = {"backend": "torch"}
    if metadata:
        meta.update(metadata)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _stored(path: str) -> Optional[dict]:
    tdpath = os.path.join(path, "treedef.json")
    if not os.path.exists(tdpath):
        return None  # old checkpoints have no fingerprint
    with open(tdpath) as f:
        return json.load(f)


def _check_structure(path: str, like: Any) -> None:
    """Raise ValueError if ``like``'s structure differs from the stored one."""
    stored = _stored(path)
    if like is None or stored is None:
        return
    _, spec = _pytree.tree_flatten(like)
    if str(spec) != stored["treedef"]:
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  stored : {stored['treedef']}\n"
            f"  `like` : {spec}"
        )


def _jax_order(tree) -> list:
    """The indices of ``tree``'s leaves (in torch's flattening order) in
    the order JAX flattens them: the same walk, but a dict's children by
    sorted key (torch keeps their insertion order)."""
    paths = [p for p, _ in _pytree.tree_flatten_with_path(tree)[0]]
    children = {}  # parent path -> its child keys, in torch's order
    for p in paths:
        for d in range(len(p)):
            sib = children.setdefault(p[:d], [])
            if p[d] not in sib:
                sib.append(p[d])

    def rank(parent, key):
        sib = children[parent]
        if isinstance(key, _pytree.MappingKey):
            return sorted(k.key for k in sib).index(key.key)
        return sib.index(key)

    ranks = [tuple(rank(p[:d], p[d]) for d in range(len(p))) for p in paths]
    return sorted(range(len(paths)), key=ranks.__getitem__)


def _restore_npz(path: str, like: Any):
    """A JAX npz checkpoint, its leaves checked against ``like`` by count
    and shape."""
    like_flat, spec = _pytree.tree_flatten(like)
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = [data[f"leaf_{i}"] for i in range(len(data.files))]
    stored = _stored(path)
    n = stored["n_leaves"] if stored else len(flat)
    if n != len(like_flat) or len(flat) != len(like_flat):
        raise ValueError(f"checkpoint structure mismatch: {n} stored leaves, "
                         f"{len(like_flat)} in `like`")
    leaves = [None] * n
    for i, (got, j) in enumerate(zip(flat, _jax_order(like))):
        want = like_flat[j]
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(f"checkpoint structure mismatch: leaf {i} has shape "
                             f"{tuple(got.shape)}, `like` {tuple(np.shape(want))}")
        leaves[j] = torch.from_numpy(np.ascontiguousarray(got)).to(config.device)
    return _pytree.tree_unflatten(leaves, spec)


def restore(path: str, like: Any = None) -> Any:
    """Restore a checkpoint into ``like``'s structure (required), tensors on
    ``config.device``; ``like`` is checked against the structure recorded at
    save time."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["backend"] == "orbax":
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package, which the port cannot "
            "read; save it there with orbax absent (the npz backend) to resume it here"
        )
    if like is None:
        raise ValueError("restore requires `like` for the tree structure")
    if meta["backend"] == "npz":
        return _restore_npz(path, like)
    _check_structure(path, like)
    flat = torch.load(os.path.join(path, "state.pt"), map_location=torch.device(config.device),
                      weights_only=True)
    _, spec = _pytree.tree_flatten(like)
    return _pytree.tree_unflatten(flat, spec)
