"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each a gap that its cell's limit bounds.

Training (the first three steps of the one trained object):

- ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` of the
  three steps.
- ``grad_gap``: the first step's gradient as Adam takes it, by the worst
  leaf: ``|‖g‖ - ‖g_ref‖|`` over the larger of ``‖g_ref‖`` for that leaf
  and for the median leaf.
- ``change_gap``: the parameters' change after the three steps, by the
  worst leaf the same way, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (a gradient below that is
  rounding, as the GCN conv bias under BatchNorm, and moves under Adam by
  round-off alone).

Serving (a sample of the requests the window finished):

- ``logit_rel_err``: the largest ``‖Δ‖ / ‖ref‖`` (Frobenius) of a
  request's logits.
- ``logit_max_gap``: the largest ``max |Δ| / max |ref|`` of a request: one
  node's answer altered shows here.
"""

from __future__ import annotations

import statistics

import torch

#: a leaf's reference gradient under this share of the median leaf's is
#: rounding, and its change is not compared
NOUGHT_SHARE = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(got: dict, want: dict, keys) -> list:
    """Each leaf's ``|‖got‖ - ‖want‖|`` over the larger of ``‖want‖`` for
    that leaf and for the median leaf."""
    keys = list(keys)
    g, w = _norms({k: got[k] for k in keys}), _norms({k: want[k] for k in keys})
    median = statistics.median(w.values())
    return [abs(g[k] - w[k]) / max(w[k], median, 1e-30) for k in keys]


def moved_leaves(ref_grads: dict) -> list:
    norms = _norms(ref_grads)
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NOUGHT_SHARE * median]


def train_readings(got: dict, want: dict) -> dict:
    losses = zip(got["losses"], want["losses"])
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in losses),
        "grad_gap": max(leaf_gaps(got["grads"], want["grads"], want["grads"])),
        "change_gap": max(leaf_gaps(got["change"], want["change"], moved_leaves(want["grads"]))),
    }


def serve_readings(got: list, want: list) -> dict:
    rel, gap = 0.0, 0.0
    for a, b in zip(got, want):
        d = (a.double() - b.double())
        rel = max(rel, float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(b.double())))
        gap = max(gap, float(d.abs().max() / b.double().abs().max()))
    return {"logit_rel_err": rel, "logit_max_gap": gap}
