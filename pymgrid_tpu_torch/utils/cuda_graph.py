"""Recording work of the port as a CUDA graph and replaying it.

On a CUDA device the suite's per-step rollout, the batched envs' ``step()``
and the planners' solves (``cuda_graph=True`` in ``core/lp.py``) record
their work once in a :class:`Recording` and replay it: one launch for
hundreds, the same kernels on the same inputs, so the outputs are the eager
ones, bitwise.  :func:`available` alone decides whether the port replays;
the CPU tests patch it and swap an eager stand-in for
:meth:`Recording._capture`.
"""
import numpy as np
import torch

from pymgrid_tpu_torch.core.params import copy_into, tree_leaves, tree_map
from pymgrid_tpu_torch.utils import profiling

__all__ = ["available", "graphable", "HostValuesOnDevice", "Recording"]


def available(device):
    """Whether work on ``device`` replays recorded CUDA graphs."""
    return device.type == "cuda"


def graphable(device, spec):
    """Whether an engine step of ``spec`` on ``device`` replays a recording:
    :func:`available`, and no module runs a per-replica callable
    (``custom_fn``, any Python a user hands the engine)."""
    return available(device) and all(ref.custom_fn is None for ref in spec.log_order)


class HostValuesOnDevice(torch.overrides.TorchFunctionMode):
    """Inside a capture: a scalar made on a device from a Python number or a
    0-d numpy array (the log row's ``torch.as_tensor(0.0, device=...)``, the
    threefry draws' bounds), which copies from the host, is filled on the
    device instead, in the dtype ``as_tensor`` infers or is given: the same
    value, and no copy, which a capture cannot hold."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        device = kwargs.get("device")
        if (func is torch.as_tensor and args and device is not None
                and (isinstance(args[0], (bool, int, float))
                     or (isinstance(args[0], np.ndarray) and args[0].ndim == 0))
                and torch.device(device).type != "cpu"):
            host = func(args[0], dtype=kwargs.get("dtype"))
            return torch.full((), host.item(), dtype=host.dtype, device=device)
        return func(*args, **kwargs)


class Recording:
    """``fn(*inputs)`` recorded once as a CUDA graph.

    ``inputs`` are tensors or nested dicts of them.  The graph reads the
    recording's contiguous clones of them (:attr:`inputs`) and writes the
    tensors ``fn`` returned (:attr:`outputs`, nested, ``None`` fields kept).
    Each :meth:`replay` adds to the port's counters what the recorded ``fn``
    counted (:attr:`counts`); the recording names no span or counter."""

    def __init__(self, fn, inputs):
        self.fn = fn
        contiguous = lambda x: x.clone(memory_format=torch.contiguous_format)  # noqa: E731
        self.inputs = tuple(tree_map(contiguous, x) for x in inputs)
        self._replay, self.outputs, self.counts = self._capture()

    def _capture(self):
        """Run ``fn`` once on a side stream, as a capture wants, with its
        counts dropped (the caller made no such step), then record it;
        returns the graph's replay, the outputs and the recorded counts."""
        with torch.cuda.device(next(tree_leaves(self.inputs[0])).device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), profiling.recorded_counts():
                self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with profiling.recorded_counts() as counts, HostValuesOnDevice():
                with torch.cuda.graph(graph):
                    outputs = self.fn(*self.inputs)
        return graph.replay, outputs, counts

    def load(self, *inputs):
        """Copy ``inputs`` into the recording's, in place."""
        for dst, src in zip(self.inputs, inputs, strict=True):
            copy_into(dst, src)

    def replay(self):
        """Run the recorded work on :attr:`inputs` into :attr:`outputs`."""
        self._replay()
        for name, n in self.counts.items():
            profiling.count(name, n)
