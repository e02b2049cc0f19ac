"""Checkpoints of engine states.

Port of :mod:`pymgrid_tpu.utils.checkpoint`.  An engine state is a nested
dict of tensors: step and genset counters, battery charges (per replica for
the batched envs).  :func:`save_state` writes it with ``torch.save`` from the
CPU, so a state saved on the card restores on a machine without one;
:func:`restore_state` reads it with ``torch.load(weights_only=True)``, which
unpickles tensors and containers only.

Resume is exact: restoring a state and continuing produces the same
trajectory, bitwise, as an uninterrupted run (tests/test_torch_checkpoint.py).
"""
import os

import torch

from pymgrid_tpu_torch.core.params import tree_map

__all__ = ["save_state", "restore_state"]


def save_state(path, state):
    """Write the state dict ``state`` (tensor leaves) to the file ``path``;
    its directory is created if missing."""
    path = os.path.abspath(os.fspath(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(tree_map(lambda x: x.detach().cpu(), state), path)


def restore_state(path, template=None):
    """Read a state written by :func:`save_state`.

    With a ``template`` (e.g. the live state, or a fresh reset) every leaf
    moves to the template leaf's device and dtype, and the nesting must
    match; without one the leaves come back as stored, on the CPU.
    """
    state = torch.load(os.fspath(path), map_location="cpu", weights_only=True)
    if template is None:
        return state
    return _onto(state, template, "state")


def _onto(stored, template, where):
    if isinstance(template, dict):
        if not isinstance(stored, dict) or set(stored) != set(template):
            got = sorted(stored) if isinstance(stored, dict) else type(stored).__name__
            raise ValueError(f"checkpoint {where}: keys {got} do not match the "
                             f"template's {sorted(template)}")
        return {k: _onto(stored[k], template[k], f"{where}[{k!r}]") for k in template}
    if not isinstance(stored, torch.Tensor):
        raise ValueError(f"checkpoint {where}: expected a tensor, got "
                         f"{type(stored).__name__}")
    return stored.to(device=template.device, dtype=template.dtype)
