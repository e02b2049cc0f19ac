"""Checkpoints of engine states.

Port of :mod:`pymgrid_tpu.utils.checkpoint`.  An engine state is a nested
dict of tensors: step and genset counters, battery charges (per replica for
the batched envs), and threefry keys and realized gaussian windows where
the spec draws them.  :func:`save_state` writes it with ``torch.save`` from
the CPU, so a state saved on the card restores on a machine without one;
:func:`restore_state` reads it with ``torch.load(weights_only=True)``, which
unpickles tensors and containers only.

A batch sharded over a data-parallel job (a
:class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`) is saved by
:func:`save_rank_state`: every rank writes its own rows to its own file in
one directory, so the files together hold the global batch in rank order,
as the JAX package's orbax checkpoint holds the global sharded array.
:func:`restore_rank_state` gives each rank its own rows back and refuses a
restore at another world size or global batch.  Unlike the JAX
:func:`save_state`, which writes a directory, the port's unsharded one
writes one file; as the JAX one, it overwrites it unless ``force=False``.

Resume is exact: restoring a state and continuing produces the same
trajectory, bitwise, as an uninterrupted run (tests/test_torch_checkpoint.py).
"""
import os

import torch

from pymgrid_tpu_torch.core.params import tree_map

__all__ = ["save_state", "restore_state", "save_rank_state", "restore_rank_state"]


def save_state(path, state, *, force=True):
    """Write the state dict ``state`` (tensor leaves) to the file ``path``;
    its directory is created if missing.  ``force=False`` refuses to
    overwrite an existing ``path`` with the JAX function's ``ValueError``."""
    path = os.path.abspath(os.fspath(path))
    if not force and os.path.exists(path):
        raise ValueError(f"Destination {path} already exists.")
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


def _rank_file(path, world_size, rank):
    return os.path.join(os.fspath(path), f"rank{rank}-of-{world_size}.pt")


def save_rank_state(path, state, mesh, global_size):
    """Write this rank's rows of a ``global_size`` batch state to the
    directory ``path`` (created), as ``rank{r}-of-{w}.pt`` with the layout
    it was saved under."""
    layout = torch.tensor([mesh.world_size, mesh.rank, global_size])
    save_state(_rank_file(path, mesh.world_size, mesh.rank),
               {"layout": layout, "state": state})


def restore_rank_state(path, template, mesh, global_size):
    """This rank's rows from a directory written by :func:`save_rank_state`,
    onto ``template``'s devices and dtypes.  ``ValueError`` when the
    checkpoint was saved at another world size or global batch."""
    file = _rank_file(path, mesh.world_size, mesh.rank)
    if not os.path.exists(file):
        saved = sorted(f for f in os.listdir(path) if f.endswith(".pt")) \
            if os.path.isdir(path) else []
        raise ValueError(f"no checkpoint for rank {mesh.rank} of {mesh.world_size} "
                         f"in {os.fspath(path)!r} (found {saved}): a sharded "
                         f"checkpoint restores only at the world size it was saved at")
    stored = restore_state(file)
    want = [mesh.world_size, mesh.rank, global_size]
    if stored["layout"].tolist() != want:
        raise ValueError(f"checkpoint {file!r} holds the layout (world size, rank, "
                         f"global batch) {stored['layout'].tolist()}, not {want}")
    return _onto(stored["state"], template, "state")


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
