"""Weights carried across from the JAX package.

The port's parameter names are the reference's ``state_dict`` keys, so the
JAX package's key table (``connectome_gnn_tpu/models/compat.py:13-24``)
read backwards is the whole transplant:

==============================  =======================================
``convs.{i}.linear.weight``     ``params["convs"][i]["kernel"].T``
``convs.{i}.bias`` (GCN)        ``params["convs"][i]["bias"]``
``convs.{i}.linear.bias``(SAGE) ``params["convs"][i]["bias"]``
``batch_norms.{i}.weight``      ``params["norms"][i]["scale"]``
``batch_norms.{i}.bias``        ``params["norms"][i]["bias"]``
``batch_norms.{i}.running_*``   ``state["norms"][i]["mean"/"var"]``
``classifier.0.*``              ``params["head"]["fc1"]`` (transposed)
``classifier.3.*``              ``params["head"]["fc2"]`` (transposed)
``head.*`` (node models)        ``params["head"]`` (one dense layer)
==============================  =======================================

The node models (``BandedNodeGCN``, ``BandedNodeSAGE``, the COO
``NodeGCN`` / ``NodeSAGE`` and their blocked forms, and a
``DeviceSampledModel`` wrapping one) share the conv and BatchNorm keys;
their head is one dense layer, which the table's last row carries.  SAGE's
conv kernel is ``[2·in, out]`` in both packages.

The pytrees are taken with numpy leaves (``jax.tree_util.tree_map(
np.asarray, params)``); this module imports neither JAX nor the JAX
package.  A reference checkpoint needs no helper: ``model.load_state_dict``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def reference_state_dict_from_params(
    params: Mapping, state: Mapping, *, sage: bool
) -> dict[str, np.ndarray]:
    """The reverse of ``params_from_reference_state_dict``: JAX
    ``(params, state)`` pytrees → reference ``state_dict`` keys (numpy).
    ``sage`` selects where the conv bias lives (inside SAGE's linear)."""
    sd: dict[str, np.ndarray] = {}
    for i, conv in enumerate(params["convs"]):
        sd[f"convs.{i}.linear.weight"] = np.asarray(conv["kernel"]).T
        bias_key = f"convs.{i}.linear.bias" if sage else f"convs.{i}.bias"
        sd[bias_key] = np.asarray(conv["bias"])
    for i, (norm, moments) in enumerate(zip(params["norms"], state["norms"])):
        sd[f"batch_norms.{i}.weight"] = np.asarray(norm["scale"])
        sd[f"batch_norms.{i}.bias"] = np.asarray(norm["bias"])
        sd[f"batch_norms.{i}.running_mean"] = np.asarray(moments["mean"])
        sd[f"batch_norms.{i}.running_var"] = np.asarray(moments["var"])
    head = params["head"]
    if "kernel" in head:  # node models: one dense layer
        sd["head.weight"] = np.asarray(head["kernel"]).T
        if "bias" in head:
            sd["head.bias"] = np.asarray(head["bias"])
        return sd
    for idx, fc in (("0", "fc1"), ("3", "fc2")):
        sd[f"classifier.{idx}.weight"] = np.asarray(head[fc]["kernel"]).T
        sd[f"classifier.{idx}.bias"] = np.asarray(head[fc]["bias"])
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping, state: Mapping) -> None:
    """Copy JAX ``(params, state)`` pytrees (numpy leaves) into ``model``
    in place: kernels ``[in, out]`` become ``weight [out, in]`` and the
    BatchNorm moments become buffers.  Works for the connectome classifiers
    and the node models.  Raises on any key or shape mismatch; only
    ``num_batches_tracked``, which JAX does not keep, is left as is."""
    from connectome_gnn_tpu_torch.models.connectome import GraphSAGEConnectome
    from connectome_gnn_tpu_torch.models.node_coo import NodeSAGE
    from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

    inner = getattr(model, "inner", model)  # a DeviceSampledModel's node model
    sd = reference_state_dict_from_params(
        params, state, sage=isinstance(inner, (GraphSAGEConnectome, BandedNodeSAGE, NodeSAGE))
    )
    result = model.load_state_dict(
        {k: torch.tensor(v) for k, v in sd.items()},
        strict=False,
    )
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise ValueError(
            f"JAX params do not match the model: missing {missing}, "
            f"unexpected {result.unexpected_keys}"
        )
