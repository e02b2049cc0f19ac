"""Device and dtype policy of the port.

* float64 is the parity mode.  Eager PyTorch rounds every op once and never
  contracts ``a*b + c``, so a float64 trajectory equals the numpy host layer
  bit for bit, on the CPU and on the card alike, as long as every divisor is a
  tensor on the operand's device (CUDA turns ``tensor / python_float`` into a
  multiplication by the reciprocal, 1 ulp off).
* float32 is the throughput mode.

``dtype`` is always passed by the caller and never derived from the device.
``device`` defaults to ``"cuda"`` on every entry point: the port runs on the
card unless the caller asks for the CPU, and a CUDA device that is not there
raises instead of falling back to the CPU.
"""
import numpy as np
import torch

__all__ = ["torch_dtype", "numpy_dtype", "resolve_device"]

_FLOATS = {"float32": torch.float32, "float64": torch.float64}
_NUMPY = {torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64)}


def torch_dtype(dtype):
    """``"float64"`` / ``np.float64`` / ``torch.float64`` -> ``torch.float64``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _FLOATS.values():
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    name = np.dtype(dtype).name
    if name not in _FLOATS:
        raise ValueError(f"unsupported dtype {dtype!r}: use float32 or float64")
    return _FLOATS[name]


def numpy_dtype(dtype):
    """The numpy twin of :func:`torch_dtype`."""
    return _NUMPY[torch_dtype(dtype)]


def resolve_device(device="cuda"):
    """``torch.device`` for ``device`` (``None``: the card); raises if it
    names a missing card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
