"""A torch array namespace for :mod:`pymgrid_tpu_torch.core.physics`.

``physics`` (the host layer's, a copy of the JAX package's) is written
against an ``xp`` namespace (numpy or jax.numpy in the original).  This
module is that namespace for torch, so the physics runs unmodified with
``xp=pymgrid_tpu_torch.core.xp``.  Two torch habits need the shim:

* ``torch.minimum`` and friends take tensors only (``torch.minimum(1.0, t)``
  raises), so Python and numpy scalars are wrapped as tensors of the other
  operand's dtype and device;
* ``np.bool_ | tensor`` raises, so callers hand ``allow_abortion`` over as a
  torch bool tensor (the engine's params keep bool leaves as bool tensors).

``torch.round`` rounds half to even, like ``jnp.round`` and numpy, which
``physics.round_half_even`` relies on.
"""
import numpy as np
import torch

__all__ = ["where", "minimum", "round", "asarray", "ones_like", "zeros_like"]


def _like(value, ref):
    """``value`` as a tensor of ``ref``'s dtype and device."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), dtype=ref.dtype, device=ref.device)


def where(cond, a, b):
    cond = asarray(cond)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        if not all(isinstance(v, (int, np.integer)) for v in (a, b)):
            raise TypeError("xp.where on two float scalars has no dtype to follow")
        ref = torch.empty((), dtype=torch.int32, device=cond.device)
        a, b = _like(a, ref), _like(b, ref)
    elif not isinstance(a, torch.Tensor):
        a = _like(a, b)
    elif not isinstance(b, torch.Tensor):
        b = _like(b, a)
    return torch.where(cond, a, b)


def minimum(a, b):
    if not isinstance(a, torch.Tensor):
        a = _like(a, b)
    elif not isinstance(b, torch.Tensor):
        b = _like(b, a)
    return torch.minimum(a, b)


def round(x):  # noqa: A001 - namespace mirror of numpy.round
    return torch.round(x)


def asarray(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def ones_like(x):
    return torch.ones_like(x)


def zeros_like(x):
    return torch.zeros_like(x)
