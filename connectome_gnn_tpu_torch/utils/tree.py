"""The port's tree rules: how nested containers of tensors are walked.

The JAX package keeps its containers as pytrees
(``connectome_gnn_tpu/utils/pytree.py``); the port's dataclasses are plain,
so this module states the same rules once for every walker of the port
(``StepTimer.toc``, the checkpoints, ``Mesh.place``):

* **nodes** are a dataclass instance, a NamedTuple, a dict, a list, a tuple,
  and ``None`` (a node with no children);
* **leaves** are everything else;
* a dataclass's **children** are its fields whose values are tensors, numpy
  arrays or nodes; a field holding anything else (a Python scalar or a
  string, such as ``ConnectomeBatch.num_graphs``) is static metadata, JAX's
  ``static_field``: no leaf, carried over when the node is rebuilt;
* a leaf's **path** joins dict keys, sequence indices and the field names of
  dataclasses and NamedTuples with ``/``, as the JAX package's checkpoint
  keys do (``connectome_gnn_tpu/train/checkpoint.py``), so one tree gives one
  key set in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_dataclass(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _is_node(x: Any) -> bool:
    """Whether ``x`` is a node (see the module docstring)."""
    return x is None or _is_dataclass(x) or isinstance(x, (dict, list, tuple))


def _children(node: Any) -> list[tuple[Any, Any]]:
    """``(key, child)`` pairs of a node, in its own order."""
    if node is None:
        return []
    if _is_dataclass(node):
        return [(f.name, v) for f in dataclasses.fields(node)
                if f.init and (isinstance(v := getattr(node, f.name), (torch.Tensor, np.ndarray))
                               or _is_node(v))]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return list(node.items())
    return list(enumerate(node))


def _rebuild(node: Any, children: list[tuple[Any, Any]]) -> Any:
    """``node`` of its own type with ``children`` in place of its own."""
    if node is None:
        return None
    if _is_dataclass(node):
        return dataclasses.replace(node, **dict(children))
    if _is_namedtuple(node):
        return type(node)(*(v for _, v in children))
    if isinstance(node, dict):
        return type(node)(children)
    return type(node)(v for _, v in children)


def leaves_with_path(tree: Any) -> list[tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, depth first in each node's
    order; a leaf at the root has the path ``""``."""
    return _leaves(tree, ())


def _leaves(tree: Any, parts: tuple) -> list[tuple[str, Any]]:
    if not _is_node(tree):
        return [("/".join(parts), tree)]
    return [item for key, child in _children(tree) for item in _leaves(child, (*parts, str(key)))]


def map_leaves_with_path(tree: Any, fn: Callable[[str, Any], Any]) -> Any:
    """``tree`` rebuilt node by node with its own types, each leaf replaced
    by ``fn(path, leaf)``; static fields are carried over."""
    return _map(tree, fn, ())


def _map(tree: Any, fn: Callable[[str, Any], Any], parts: tuple) -> Any:
    if not _is_node(tree):
        return fn("/".join(parts), tree)
    return _rebuild(tree, [(key, _map(child, fn, (*parts, str(key))))
                           for key, child in _children(tree)])


def map_leaves(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(leaf)``."""
    return _map(tree, lambda _, leaf: fn(leaf), ())
