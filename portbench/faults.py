"""Faults planted in the port, for the checks that `correct` catches them
(portbench/tests and calibrate.py): each is a context manager that patches
the port's timed path underneath the harness and restores it after.

  altered_answer  the served logits of each volume's first slice shifted
                  by one class, so its labels change where they are made.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    before = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, before)


def altered_answer():
    from saunet_tpu_torch.train import state

    forward = state._forward_eval

    def altered(*args, **kwargs):
        out = list(forward(*args, **kwargs))
        seg = out[0].clone()
        seg[0] = seg[0].roll(1, dims=0)
        out[0] = seg
        return tuple(out)

    return _patched(state, "_forward_eval", altered)


FAULTS = {"altered_answer": altered_answer}
