"""``optax.adam`` as a ``torch.optim.Optimizer``, bit for bit.

The JAX training programs step their parameters with ``optax.adam(lr)``
(``scale_by_adam`` at its defaults, chained with ``scale(-lr)``, then
``apply_updates``) inside ``jax.jit``.
:class:`Adam` takes the steps XLA compiles from it, one tensor op per IEEE
operation in their order, so that given the same gradients it gives
jitted optax's parameters bit for bit on the CPU (XLA compiled without FMA
contraction, as ``--xla_cpu_max_isa=AVX`` compiles it) and the same bits
on a CUDA device, where every op rounds once:

* ``mu = (1 - b1) * g + b1 * mu`` and ``nu = (1 - b2) * (g * g) + b2 * nu``,
  the constants rounded to the moment's dtype as JAX rounds a Python float;
* ``count`` an int32 that saturates at its maximum (``safe_increment``);
* ``bc = 1 - b ** count`` in the moment's dtype (:func:`bias_correction`,
  on the host), each filled into a 0-d tensor on the parameter's device:
  PyTorch's CUDA divide multiplies by the reciprocal of a Python or CPU
  scalar;
* ``u = mu / (bc1 * (sqrt(nu / bc2) + eps))``: XLA's rewrite of
  optax's ``(mu / bc1) / (...)`` (optax dispatched op by op, unjitted,
  rounds ``mu / bc1`` on its own and differs in the last bit at some
  entries), with the correctly rounded root (XLA's ``sqrt``; the CPU
  torch's is not at every input);
* ``p = p + u * (-lr)``.

``torch.optim.Adam`` differs from this in three ways: it takes the bias
corrections in double, it fuses ``lerp_``, ``addcmul_`` and ``addcdiv_``,
and it divides ``sqrt(nu)`` by ``sqrt(bc2)`` where optax takes the root of
``nu / bc2``.  XLA's CPU runtime also reads subnormals as zero; here a
subnormal moment is kept, which can change a moment's last bits below
``2**-126 * 2**24`` (float32) but not a parameter, unless the parameter
itself is within about ``2**-100`` of zero.

Float32 and float64 parameters; the state (``step``, ``mu``, ``nu`` per
parameter) goes through ``state_dict`` and ``load_state_dict``.
"""
import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from pymgrid_tpu_torch.core.prng import _sqrt_f32, _sqrt_f64

__all__ = ["Adam", "bias_correction"]

B1, B2, EPS = 0.9, 0.999, 1e-8               # optax.adam's defaults
_INT32_MAX = 2**31 - 1


@functools.cache
def _powf():
    """The C library's float32 ``powf``: XLA's CPU backend lowers a float32
    ``power`` to a call of it (``llvm.pow.f32`` in ``--xla_dump_to``'s IR,
    ``powf`` in the object's relocations)."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype, fn.argtypes = ctypes.c_float, (ctypes.c_float, ctypes.c_float)
    return fn


def bias_correction(decay, count, dtype=torch.float32):
    """optax's ``1 - decay ** count`` as XLA computes it on the CPU, as a
    Python float exact in ``dtype``: ``decay`` and ``count`` rounded to
    ``dtype``, the C library's ``powf`` (float32) or ``pow`` (float64; what
    ``math.pow`` calls), a subnormal power read as zero (XLA's runtime
    flushes subnormals), then ``1 -`` in ``dtype``.  The same host
    arithmetic serves every device."""
    if dtype == torch.float32:
        power = np.float32(_powf()(float(np.float32(decay)), float(np.float32(count))))
        if power < np.finfo(np.float32).tiny:
            power = np.float32(0.0)
        return float(np.float32(1.0) - power)
    if dtype == torch.float64:
        power = math.pow(float(decay), float(count))
        return 1.0 - (power if power >= np.finfo(np.float64).tiny else 0.0)
    raise TypeError(f"Adam steps float32 or float64 parameters, not {dtype}")


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr)`` over ``params`` (module docstring), with optax's
    defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0 (XLA drops its ``+
    0``).  Parameters without a gradient are skipped, as every torch
    optimizer skips them."""

    def __init__(self, params, lr):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            corrections = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                count = min(state["step"] + 1, _INT32_MAX)
                at = (count, p.dtype, p.device)
                if at not in corrections:               # filled on the device: no copy, no sync
                    corrections[at] = [
                        torch.full((), bias_correction(b, count, p.dtype), dtype=p.dtype,
                                   device=p.device) for b in (B1, B2)]
                _update(p, state, group["lr"], *corrections[at])
                state["step"] = count


def _update(p, state, lr, bc1, bc2):
    """One step of ``p`` in XLA's compiled order (module docstring)."""
    npd = np.float32 if p.dtype == torch.float32 else np.float64
    c = lambda v: float(npd(v))                         # a Python float as JAX rounds it
    g = p.grad
    mu = g * c(1 - B1) + state["mu"] * c(B1)
    nu = (g * g) * c(1 - B2) + state["nu"] * c(B2)
    sqrt = _sqrt_f32 if p.dtype == torch.float32 else _sqrt_f64
    u = mu / (bc1 * (sqrt(nu / bc2) + c(EPS)))
    p.add_(u * c(-lr))
    state["mu"], state["nu"] = mu, nu
