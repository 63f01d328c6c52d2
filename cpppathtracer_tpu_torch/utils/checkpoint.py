"""Checkpoint and resume of long progressive or multi-device renders
(counterpart of ``cpppathtracer_tpu/utils/checkpoint.py``).

A state is a tree of dicts, lists, tuples and dataclasses whose leaves are
tensors, numpy arrays or Python ints.  It is flattened in the order of
``jax.tree_util`` (dict keys sorted, sequences and dataclass fields in
order, None holding no leaf) and written in the JAX package's ``.npz``
layout: ``leaf_<i>`` per leaf and a ``__treedef__`` JSON header.  So a file
saved by either package restores in the other, and a resumed render
continues bit-identically.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _children(tree):
    """(rebuild, subtrees) of an inner node, or None for a leaf."""
    if tree is None:
        return (lambda vals: None), []
    if isinstance(tree, dict):
        keys = sorted(tree)

        def rebuild(vals):
            by_key = dict(zip(keys, vals))
            return type(tree)((k, by_key[k]) for k in tree)

        return rebuild, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return (lambda vals: type(tree)(vals)), list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return (lambda vals: dataclasses.replace(tree, **dict(zip(names, vals)))), \
            [getattr(tree, n) for n in names]
    return None


def flatten(tree) -> list:
    """The leaves of `tree`, in ``jax.tree_util`` order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for sub in node[1] for leaf in flatten(sub)]


def _rebuild(like, leaves, leaf_fn):
    node = _children(like)
    if node is None:
        return leaf_fn(like, next(leaves))
    rebuild, subs = node
    return rebuild([_rebuild(s, leaves, leaf_fn) for s in subs])


def clone(tree):
    """A copy of `tree` whose tensors are clones, so that changing the
    original in place leaves the copy as it was."""
    return _rebuild(tree, iter(flatten(tree)),
                    lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x)


def _as_like(like, value):
    """`value` (a numpy array) as the kind of leaf `like` is: a tensor of
    its dtype on its device, a Python int (AccumulatorState.sample_idx),
    else a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(device=like.device, dtype=like.dtype)
    if isinstance(like, int):
        return int(value)
    return np.asarray(value)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save(path: str, tree, metadata: dict | None = None) -> None:
    """Serialize a tree (+ JSON-able metadata) to an .npz."""
    flat = flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(flat)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps({"n": len(flat), "meta": metadata or {}}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def restore(path: str, like_tree):
    """Restore a tree saved with :func:`save` (by either package);
    `like_tree` gives the structure, the leaves' kinds and the tensors'
    devices.  Returns (tree, metadata)."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__treedef__"].tobytes()).decode())
        n = len(flatten(like_tree))
        if header["n"] != n:
            raise ValueError(f"checkpoint has {header['n']} leaves, expected {n}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(like_tree, iter(leaves), _as_like), header["meta"]
