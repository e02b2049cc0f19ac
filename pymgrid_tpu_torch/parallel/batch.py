"""Replica batching of one microgrid config.

Port of :mod:`pymgrid_tpu.parallel.batch`: ``batch_size`` replicas of one
config step in lockstep on one device.  States, actions and step outputs
carry a leading replica axis ``(B, ...)`` as in the JAX class; the engine's
config axis (``C = 1``) is added and removed inside.

With ``mesh=`` (a :class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`
from :func:`make_batch_mesh`) ``batch_size`` is the job's global batch and
this rank holds its rows on the mesh's device: ``reset`` and rollouts return
the local rows, ``step`` takes the global actions and uses this rank's rows,
and :func:`~pymgrid_tpu_torch.parallel.distributed.fetch` assembles outputs.
"""
import torch

from pymgrid_tpu_torch._device import numpy_dtype, torch_dtype
from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.engine import (
    StepOutput,
    check_supported,
    make_reset_fn,
    make_step_fn,
    needs_keys,
)
from pymgrid_tpu_torch.core.params import (
    params_to_torch,
    with_config_axis,
    without_config_axis,
)
from pymgrid_tpu_torch.core.rollout import make_rollout_fn
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.parallel.distributed import (
    global_batch_mesh,
    local_layout,
    process_count,
)

__all__ = ["BatchedMicrogrid", "make_batch_mesh", "replica_keys"]


def make_batch_mesh(n_devices=None, device="cuda"):
    """:class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh` of this
    job: one process per device, so ``n_devices`` (if given) must equal the
    job's world size."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"one process drives one device: this job has {world} "
                         f"processes, asked for {n_devices} devices")
    return global_batch_mesh(device)


def replica_keys(spec, seed, global_size, rows, device):
    """This rank's ``rows`` of ``split(key(seed), global_size)`` as
    ``(1, B, 2)`` engine keys (the JAX batched reset's keys), or ``None``
    for a spec that draws no threefry gaussians."""
    if not needs_keys(spec):
        return None
    return prng.split(prng.key(seed, device), global_size)[rows].unsqueeze(0)


def drop_config_axis(out):
    """A :class:`StepOutput` at ``C = 1`` -> its fields without the config
    axis (``None`` fields stay ``None``)."""
    return StepOutput(*[None if f is None else f[0] for f in out])


class BatchedMicrogrid:
    """``batch_size`` replicas of ``microgrid`` on ``device`` in ``dtype``
    (float64 for parity work, float32 for throughput); with ``mesh`` this
    rank's rows of them on the mesh's device (see the module docstring)."""

    def __init__(self, microgrid, batch_size, dtype, device="cuda", normalized_actions=False,
                 mesh=None):
        self.batch_size = batch_size
        self.mesh = mesh
        self.device, self.local_batch_size, self._rows = local_layout(mesh, batch_size, device)
        self.dtype = torch_dtype(dtype)
        self.spec, params, _ = extract_spec(microgrid, dtype=numpy_dtype(dtype))
        check_supported(self.spec)
        self.params = with_config_axis(params_to_torch(params, self.device, self.dtype))
        self._reset_fn = make_reset_fn(self.spec)
        self._step_fn = make_step_fn(self.spec, normalized=normalized_actions)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        """``(B, ...)`` states at the config's initial step (this rank's
        rows with a mesh).  ``seed`` keys threefry-gaussian forecasts: the
        replicas take ``split(key(seed), B)`` over the global batch, as the
        JAX class does, so meshed and unmeshed runs draw alike; other
        forecasters draw nothing."""
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        keys = replica_keys(self.spec, seed, self.batch_size, self._rows, self.device)
        return without_config_axis(
            self._reset_fn(self.params, starts.expand(1, self.local_batch_size), keys)
        )

    def step(self, state, action):
        """Step all replicas; ``action`` tensors carry a leading (global)
        batch axis, of which this rank uses its rows."""
        action = {k: torch.as_tensor(v, device=self.device)[self._rows]
                  for k, v in action.items()}
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
