"""In-run fault detection and preemption handling.

The port of ``connectome_gnn_tpu.train.fault`` (``fault.py:42-136``):

* **numeric blowup** — a bad batch or a learning-rate spike gives a
  non-finite loss or gradient, and one such step poisons the parameters for
  good.  :func:`all_finite` reduces on the device and
  :func:`guard_step_outputs` makes the step a no-op by a select against a
  :func:`snapshot` taken before it: parameters, BatchNorm buffers and
  optimizer state keep their old values, and the step reports ``ok = 0``.
  Snapshot and select work on one flat copy per device and type, so the
  guard is a handful of launches whatever the number of tensors.  Nothing
  here reads the device from the host, so a guarded step needs no host
  sync; the trainer reads the counts once per epoch.
* **preemption** — :class:`PreemptionGuard` turns SIGTERM/SIGINT into a
  flag that the training loop polls at epoch boundaries; with the atomic
  fit checkpoint the job saves its state and exits cleanly, and
  ``resume=True`` continues it.

When every value is finite the select returns the new values, so the guard
is the identity, bitwise, and is on by default in the trainer.
"""

from __future__ import annotations

import signal
from typing import Sequence

import torch


def all_finite(*tensors: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: every element of every floating-point tensor is
    finite (one ``cat``, ``isfinite`` and reduce, on the device)."""
    floats = [t.reshape(-1) for t in tensors if t.is_floating_point()]
    if not floats:
        return torch.ones((), dtype=torch.bool)
    return torch.isfinite(torch.cat(floats)).all()


def _groups(tensors: Sequence[torch.Tensor]) -> dict:
    """``tensors`` by (device, dtype), each group in the given order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups


def snapshot(tensors: Sequence[torch.Tensor]) -> dict:
    """The values of ``tensors``, one flat copy per (device, dtype)."""
    return {key: torch.cat([t.reshape(-1) for t in group]) for key, group in _groups(tensors).items()}


def select_(ok: torch.Tensor, new: Sequence[torch.Tensor], old: dict) -> None:
    """In place, ``new = where(ok, new, old)``: the no-op update when a step
    is rejected.  ``old`` is the :func:`snapshot` of a prefix of ``new``
    (per device and type); tensors past it, such as optimizer state made
    during the step, fall back to zeros.  One ``cat``, one ``where`` and
    one ``_foreach_copy_`` per group, each bitwise."""
    for key, group in _groups(new).items():
        flat = torch.cat([t.reshape(-1) for t in group])
        prev = old.get(key, flat[:0])
        if prev.numel() < flat.numel():
            prev = torch.cat([prev, flat.new_zeros(flat.numel() - prev.numel())])
        torch.where(ok.to(flat.device), flat, prev, out=flat)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in zip(parts, group)])


def guard_step_outputs(
    ok: torch.Tensor,
    new: Sequence[torch.Tensor],
    old: dict,
    loss: torch.Tensor,
    n: torch.Tensor,
):
    """Apply the non-finite guard to a train step's outputs.

    ``new`` (updated in place) takes the values of its :func:`snapshot`
    ``old`` unless ``ok``.  Returns ``(loss, n, ok_f32)``: a rejected step
    contributes ``loss = 0`` and ``n = 0`` to the epoch sums, so one bad
    batch cannot turn the epoch-mean loss into NaN.
    """
    select_(ok, new, old)
    return (
        torch.where(ok, loss, torch.zeros_like(loss)),
        torch.where(ok, n, torch.zeros_like(n)),
        ok.to(torch.float32),
    )


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a cooperative stop flag.

    Usage::

        with PreemptionGuard() as guard:
            for epoch in ...:
                train_epoch(...)
                if guard.triggered:
                    save_checkpoint(...); break

    The previous handlers are restored on exit.  A second signal while the
    guard is active falls through to the previous handler (so a double
    Ctrl-C still kills a hung job).
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.triggered = False
        self._previous = {}

    def _handle(self, signum, frame):
        if self.triggered:
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.triggered = True

    def __enter__(self):
        for sig in self.SIGNALS:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # not the main thread: polling still works, signals just
                # are not intercepted
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False
