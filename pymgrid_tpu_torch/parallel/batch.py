"""Replica batching of one microgrid config.

Port of :class:`pymgrid_tpu.parallel.batch.BatchedMicrogrid`: ``batch_size``
replicas of one config step in lockstep on one device.  States, actions and
step outputs carry a leading replica axis ``(B, ...)`` as in the JAX class;
the engine's config axis (``C = 1``) is added and removed inside.  The JAX
class's device mesh (``make_batch_mesh``, ``mesh=``) belongs to distribution
(ROADMAP.md A12); this one takes a ``device``.
"""
import torch

from pymgrid_tpu_torch._device import numpy_dtype, resolve_device, torch_dtype
from pymgrid_tpu_torch.core.engine import (
    StepOutput,
    check_supported,
    make_reset_fn,
    make_step_fn,
)
from pymgrid_tpu_torch.core.params import (
    params_to_torch,
    with_config_axis,
    without_config_axis,
)
from pymgrid_tpu_torch.core.rollout import make_rollout_fn
from pymgrid_tpu_torch.core.spec import extract_spec

__all__ = ["BatchedMicrogrid"]


def drop_config_axis(out):
    """A :class:`StepOutput` at ``C = 1`` -> its fields without the config
    axis (``None`` fields stay ``None``)."""
    return StepOutput(*[None if f is None else f[0] for f in out])


class BatchedMicrogrid:
    """``batch_size`` replicas of ``microgrid`` on ``device`` in ``dtype``
    (float64 for parity work, float32 for throughput)."""

    def __init__(self, microgrid, batch_size, dtype, device="cuda", normalized_actions=False):
        self.batch_size = batch_size
        self.device, self.dtype = resolve_device(device), torch_dtype(dtype)
        self.spec, params, _ = extract_spec(microgrid, dtype=numpy_dtype(dtype))
        check_supported(self.spec)
        self.params = with_config_axis(params_to_torch(params, self.device, self.dtype))
        self._reset_fn = make_reset_fn(self.spec)
        self._step_fn = make_step_fn(self.spec, normalized=normalized_actions)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        """``(B, ...)`` states at the config's initial step.  They do not
        depend on ``seed``: every forecaster the port supports is a pure
        function of time (the JAX reset keys only jax-PRNG gaussian
        forecasts, ROADMAP.md A14)."""
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        return without_config_axis(
            self._reset_fn(self.params, starts.expand(1, self.batch_size))
        )

    def step(self, state, action):
        """Step all replicas; ``action`` tensors carry a leading batch axis."""
        new_state, out = self._step_fn(
            self.params, with_config_axis(state), with_config_axis(action)
        )
        return without_config_axis(new_state), drop_config_axis(out)

    def make_batched_rollout(self, policy, n_steps, auto_reset=True, collect=False):
        """``(params, states) -> (final_states, outputs)`` for a port policy
        (``(params, state) -> action`` on ``(C, B)`` tensors).  Outputs are
        replica-major, ``(B, T, ...)``, as the JAX class's vmap over replicas
        returns them."""
        rollout = make_rollout_fn(self.spec, policy, n_steps,
                                  auto_reset=auto_reset, collect=collect)

        def batched(params, states):
            final, outs = rollout(params, with_config_axis(states))
            fields = [None if f is None else f[:, 0].movedim(0, 1) for f in outs]
            return (without_config_axis(final),
                    StepOutput(*fields) if collect else tuple(fields))

        return batched

    def rollout(self, policy, n_steps, seed=0, auto_reset=True, collect=False):
        fn = self.make_batched_rollout(policy, n_steps, auto_reset, collect)
        return fn(self.params, self.reset(seed))
