"""Disk checkpointing for trees of tensors and arrays.

The port of ``connectome_gnn_tpu.train.checkpoint``: a tree (dataclasses,
NamedTuples, dicts, lists and tuples, such as a ``state_dict``, walked by
the rules of :mod:`connectome_gnn_tpu_torch.utils.tree`) is written to one
``.npz`` file keyed by the path of each leaf, ``"model/convs.0.bias"``:
the JAX package's keys for the same tree.  ``None`` writes nothing.  There
is no pickle: leaves round-trip as raw numpy arrays, bitwise, and a leaf
that would need one (an object array) raises ``TypeError`` at save.

Restore is template-based: the caller gives a tree of the right structure
(a fresh ``state_dict``, say) and gets the same structure back with every
leaf read from the file, on the template leaf's device where the leaf is a
tensor.  A leaf missing from the file raises ``KeyError``; a shape that
differs from the template's raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from connectome_gnn_tpu_torch.utils.tree import leaves_with_path, map_leaves_with_path


def _to_numpy(key: str, leaf: Any) -> np.ndarray:
    array = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    if array.dtype.hasobject:
        raise TypeError(f"checkpoint leaf '{key}' ({type(leaf).__name__}) is not an array: "
                        "it would need a pickle")
    return array


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree of tensors and arrays to ``path`` (``.npz`` appended if
    missing).  The write is atomic (a tmp file, then ``os.replace``), so a
    crash mid-save never corrupts the last good checkpoint."""
    arrays = {key: _to_numpy(key, leaf) for key, leaf in leaves_with_path(tree)}
    target = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}.npz"  # np.savez appends .npz otherwise
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """Every stored leaf of a checkpoint, by path key."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        return dict(data)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore a tree saved by :func:`save_checkpoint` into the structure
    of ``template``, every node of the template's own type (dataclass,
    NamedTuple, dict, list, tuple, ``None``; a dataclass's static fields
    the template's): a tensor leaf becomes a tensor on that leaf's device
    (in the stored type), any other leaf the stored numpy array."""
    stored = load_arrays(path)

    def fill(key: str, leaf: Any) -> Any:
        if key not in stored:
            raise KeyError(f"checkpoint {_npz_path(path)} is missing leaf '{key}'")
        value = stored[key]
        if hasattr(leaf, "shape") and tuple(leaf.shape) != value.shape:
            raise ValueError(f"shape mismatch for '{key}': template {tuple(leaf.shape)} "
                             f"vs checkpoint {value.shape}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(value).to(leaf.device)
        return value

    return map_leaves_with_path(template, fill)
