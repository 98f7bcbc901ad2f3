"""The port's tree rules (``utils/tree.py``) against the JAX package's
pytrees, through the checkpoints: for each tree the port's
``save_checkpoint`` writes the keys (and values) that JAX's writes for its
counterpart, the file loads without pickle, and the port's restore gives
back the template's node types and the saved values bitwise."""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu as jp
import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from connectome_gnn_tpu.utils.pytree import pytree_dataclass, static_field
from connectome_gnn_tpu_torch.train import restore_checkpoint, save_checkpoint
from connectome_gnn_tpu_torch.utils.tree import leaves_with_path, map_leaves


class Moments(NamedTuple):
    m: object
    v: object


@dataclasses.dataclass
class Counted:
    values: torch.Tensor
    count: int = 0


@pytree_dataclass
class JaxCounted:
    values: jnp.ndarray
    count: int = static_field(default=0)


def arrays(*shapes):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def dict_case():
    a, b = arrays((3, 4), (5,))
    return ({"a": a, "b": {"c": b}},
            {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(b)}})


def batch_case():
    jb = jp.collate_graphs(jp.generate_dataset(num_subjects=2, num_regions=12, seed=0))
    tb = tp.collate_graphs(tp.generate_dataset(num_subjects=2, num_regions=12, seed=0))
    return {"batch": jb}, {"batch": tb}


def namedtuple_case():
    m, v = arrays((4,), (4,))
    return ({"nt": Moments(m, v)},
            {"nt": Moments(torch.from_numpy(m), torch.from_numpy(v))})


def tuple_case():
    a, b = arrays((2, 2), (3,))
    return {"t": (a, b)}, {"t": (torch.from_numpy(a), torch.from_numpy(b))}


def none_case():
    (w,) = arrays((6,))
    return {"w": w, "opt": None}, {"w": torch.from_numpy(w), "opt": None}


def static_dataclass_case():
    (x,) = arrays((2, 3))
    return {"state": JaxCounted(jnp.asarray(x), count=3)}, {"state": Counted(torch.from_numpy(x), 3)}


CASES = {"dict": dict_case, "connectome_batch": batch_case, "namedtuple": namedtuple_case,
         "tuple": tuple_case, "none": none_case, "static_dataclass": static_dataclass_case}


def node_types(tree):
    """Every node's type and every dataclass's static fields, by path."""
    if isinstance(tree, torch.Tensor):
        return "tensor"
    if dataclasses.is_dataclass(tree):
        return (type(tree), {f.name: node_types(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return (type(tree), {k: node_types(v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return (type(tree), [node_types(v) for v in tree])
    return tree


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_keys_are_jaxs_and_restore_is_bitwise_and_typed(case, tmp_path):
    jax_tree, tree = CASES[case]()
    jax_save_checkpoint(str(tmp_path / "jax"), jax_tree)
    save_checkpoint(str(tmp_path / "port"), tree)
    with np.load(tmp_path / "jax.npz") as jf, np.load(tmp_path / "port.npz", allow_pickle=False) as pf:
        want, got = dict(jf), dict(pf)
    assert set(got) == set(want)
    for key in want:  # the same values; index dtypes differ (int32 in JAX, int64 here)
        assert np.array_equal(got[key], want[key]), key

    template = map_leaves(tree, lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t)
    restored = restore_checkpoint(str(tmp_path / "port"), template)
    assert node_types(restored) == node_types(tree)
    saved, back = leaves_with_path(tree), leaves_with_path(restored)
    assert [k for k, _ in back] == [k for k, _ in saved]
    for (key, t), (_, r) in zip(saved, back):
        assert r.dtype == t.dtype and torch.equal(r, t), key


def test_tree_rules():
    batch = batch_case()[1]["batch"]
    keys = [k for k, _ in leaves_with_path({"b": batch, "nt": Moments(1, None), "n": None})]
    assert keys == [f"b/{f.name}" for f in dataclasses.fields(batch) if f.name != "num_graphs"] + ["nt/m"]
    assert leaves_with_path(torch.ones(2))[0][0] == ""
    doubled = map_leaves({"c": Counted(torch.ones(2), 7), "t": (1, [2])}, lambda x: x * 2)
    assert doubled["c"].count == 7 and torch.equal(doubled["c"].values, torch.full((2,), 2.0))
    assert doubled["t"] == (2, [4])


def test_an_object_leaf_raises_at_save_and_writes_nothing(tmp_path):
    with pytest.raises(TypeError, match="'model/bad'"):
        save_checkpoint(str(tmp_path / "c"), {"model": {"w": torch.ones(2), "bad": object()}})
    assert list(tmp_path.iterdir()) == []
