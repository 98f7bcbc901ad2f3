"""Disk checkpointing for nested mappings of tensors and arrays.

The port of ``connectome_gnn_tpu.train.checkpoint``: a tree (nested
mappings and sequences, such as a ``state_dict``) is written to one
``.npz`` file keyed by the path of each leaf, ``"model/convs.0.bias"``.
There is no pickle: leaves round-trip as raw numpy arrays, bitwise.

Restore is template-based: the caller gives a tree of the right structure
(a fresh ``state_dict``, say) and gets the same structure back with every
leaf read from the file, on the template leaf's device where the leaf is a
tensor.  A leaf missing from the file raises ``KeyError``; a shape that
differs from the template's raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree of tensors and arrays to ``path`` (``.npz`` appended if
    missing).  The write is atomic (a tmp file, then ``os.replace``), so a
    crash mid-save never corrupts the last good checkpoint."""
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
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
    of ``template``: mappings become dicts, sequences lists; a tensor leaf
    becomes a tensor on that leaf's device (in the stored type), any other
    leaf the stored numpy array."""
    stored = load_arrays(path)

    def fill(tree: Any, prefix: str) -> Any:
        if isinstance(tree, Mapping):
            return {k: fill(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        key = prefix[:-1]
        if key not in stored:
            raise KeyError(f"checkpoint {_npz_path(path)} is missing leaf '{key}'")
        value = stored[key]
        if hasattr(tree, "shape") and tuple(tree.shape) != value.shape:
            raise ValueError(f"shape mismatch for '{key}': template {tuple(tree.shape)} "
                             f"vs checkpoint {value.shape}")
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(value).to(tree.device)
        return value

    return fill(template, "")
