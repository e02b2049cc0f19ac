"""Data-parallel execution over ``torch.distributed``.

Port of :mod:`pymgrid_tpu.parallel.distributed`.  The JAX package drives many
devices from one process and lays a global batch over a ``Mesh``; the port
runs one process per device, the PyTorch idiom: each rank holds its rows of
the global batch on its own device, and the collectives are explicit
(``all_reduce`` of a gradient, ``all_gather`` in :func:`fetch`).  A
:class:`BatchMesh` (world size, rank, this rank's device) stands where the JAX
package passes a ``Mesh``.

Typical data-parallel program (one process per card, e.g. under
``torchrun --nproc-per-node 4``)::

    from pymgrid_tpu_torch.parallel import distributed as dist

    dist.initialize()                      # no-op single-process
    mesh = dist.global_batch_mesh()        # this rank's share of the job
    batched = BatchedDiscreteEnv(env, GLOBAL_B, "float32", mesh=mesh)
    states = batched.reset()               # this rank's rows
    ...
    print(dist.fetch(outs.reward, axis=1)) # the global array on every rank

NCCL cannot put two ranks on one card: on a single card the job runs at world
size 1; a 2-rank job on the CPU runs over gloo.
"""
import datetime
import os
import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as torch_dist

from pymgrid_tpu_torch._device import resolve_device

__all__ = [
    "BatchMesh",
    "initialize",
    "global_batch_mesh",
    "process_count",
    "local_batch_size",
    "from_process_local",
    "fetch",
    "all_reduce_mean",
    "free_port",
]


class BatchMesh(NamedTuple):
    """One rank's view of a data-parallel job: ``world_size`` ranks, this
    process's ``rank`` and the device its rows live on."""

    world_size: int
    rank: int
    device: torch.device

    def local_size(self, global_size):
        """Rows of a ``global_size`` batch this rank holds; ``ValueError``
        when the batch does not divide over the ranks."""
        if global_size % self.world_size:
            raise ValueError(f"global batch {global_size} does not divide over "
                             f"{self.world_size} processes")
        return global_size // self.world_size

    def local_rows(self, global_size):
        """This rank's ``slice`` of a ``global_size`` batch axis."""
        n = self.local_size(global_size)
        return slice(self.rank * n, (self.rank + 1) * n)


def local_layout(mesh, global_size, device):
    """``(device, local size, rows)`` of a ``global_size`` batch on this
    rank: the mesh's device and share with a mesh, ``(device, global_size,
    slice(None))`` without one."""
    if mesh is None:
        return resolve_device(device), global_size, slice(None)
    return mesh.device, mesh.local_size(global_size), mesh.local_rows(global_size)


def backend_for(device):
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device="cuda", **kwargs):
    """Join this process to the job (wraps ``init_process_group``: NCCL for a
    CUDA ``device``, gloo for the CPU).

    ``coordinator_address`` is ``host:port`` of rank 0 (or a full
    ``tcp://`` init method).  Without one, a ``torchrun`` job's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.
    Returns ``False`` and does nothing for a single process with no
    coordinator, and when a process group already exists; ``True`` once
    this call has joined the job.  Rendezvous and collectives time out
    after 300 s unless ``kwargs`` give another ``timeout``; every keyword
    argument passes on to ``init_process_group``, as the JAX function's
    pass on to ``jax.distributed.initialize``.
    """
    if torch_dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if coordinator_address is None and num_processes == 1:
        return False
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs.setdefault("timeout", datetime.timedelta(seconds=300))
    torch_dist.init_process_group(
        backend_for(device), init_method=init_method, world_size=num_processes,
        rank=process_id, **kwargs,
    )
    return True


def free_port():
    """A TCP port on ``127.0.0.1`` that is free now, for a one-host job's
    coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_count():
    """World size of the job (1 without a process group)."""
    return torch_dist.get_world_size() if torch_dist.is_initialized() else 1


def _rank():
    return torch_dist.get_rank() if torch_dist.is_initialized() else 0


def _rank_device(device, rank):
    """``device`` with this rank's card index filled in (``LOCAL_RANK``, or
    the rank modulo the visible cards); raises for a missing card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    return resolve_device(device)


def global_batch_mesh(device="cuda"):
    """:class:`BatchMesh` over every rank of the job (one device per rank:
    a CUDA ``device`` without an index becomes this rank's card)."""
    rank = _rank()
    return BatchMesh(process_count(), rank, _rank_device(device, rank))


def local_batch_size(global_batch):
    """Replicas this process feeds (the global batch must divide evenly)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over {n} processes")
    return global_batch // n


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def from_process_local(mesh, local_data):
    """This rank's rows (a nested dict or tuple of arrays or tensors, the
    batch along axis 0 of every leaf) as tensors on the rank's device."""
    return _tree_map(lambda x: _as_tensor(x).to(mesh.device), local_data)


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _gather(x, axis):
    x = _as_tensor(x)
    if torch_dist.is_initialized() and torch_dist.get_world_size() > 1:
        send = x.contiguous()
        is_bool = send.dtype == torch.bool
        if is_bool:                       # collectives move bytes, not bools
            send = send.to(torch.uint8)
        parts = [torch.empty_like(send) for _ in range(torch_dist.get_world_size())]
        torch_dist.all_gather(parts, send)
        x = torch.cat(parts, dim=axis)
        if is_bool:
            x = x.to(torch.bool)
    return x.detach().cpu().numpy()


def fetch(x, axis=0):
    """The global array as numpy on every rank: each rank's rows along
    ``axis`` (0 for states and step outputs, 1 for time-major rollout
    outputs) joined in rank order through ``all_gather``.  With a single
    process it is a plain ``.cpu().numpy()``.  ``x`` may be a nested dict or
    tuple; ``None`` leaves stay ``None``.  Every rank must hold equally many
    rows."""
    return _tree_map(lambda leaf: _gather(leaf, axis), x)


def all_reduce_mean(flat):
    """In place: ``flat`` summed over the job's ranks and divided by the
    world size (XLA's psum-mean); returns ``flat``.  A no-op without a
    process group."""
    if torch_dist.is_initialized():
        torch_dist.all_reduce(flat)
        flat.div_(torch_dist.get_world_size())
    return flat
