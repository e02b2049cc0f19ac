"""Vectorized RL environments over the engine.

Port of :mod:`pymgrid_tpu.parallel.batched_env`.  ``BatchedDiscreteEnv`` is
the batched analog of :class:`~pymgrid_tpu_torch.envs.DiscreteMicrogridEnv`: B
replicas step in lockstep, integer actions index a priority-list table
(:func:`~pymgrid_tpu_torch.core.rollout.make_table_policy`) and episodes
auto-reset.  ``BatchedContinuousEnv`` is the analog of
:class:`~pymgrid_tpu_torch.envs.ContinuousMicrogridEnv`: ``(B, action_dim)``
actions in [0, 1] in the env's flattened layout (sorted module names, genset
rows [goal, production]), denormalized by the engine like the host env's
``run(action, normalized=True)``.

The public API has the JAX envs' shapes: ``step`` returns ``(B, ...)``
outputs, ``rollout`` time-major ``(T, B, ...)`` ones, and states are dicts of
``(B, ...)`` leaves (no ``rng`` leaf); the engine's config axis (``C = 1``)
is added and removed inside.  Observations come out in the env's order
(``obs_layout="env"``).

``rollout`` is a Python loop over the action sequence.  The engine step is
built once per ``(keep_obs, keep_logs)`` and builds only what is kept (the
port's form of XLA's dead-code elimination in the JAX rollout), and the
outputs go into ``(T, B, ...)`` buffers allocated at the first step.
``shared_step=True`` carries one ``(C, 1)`` simulated time for all replicas,
the lockstep layout: time rows are read once per step instead of once per
replica.  It holds for ``reset()`` states (one start, and auto-resets fire
together since ``done`` depends on the time alone) and gives the same
outputs bitwise.
"""
import numpy as np
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
from pymgrid_tpu_torch.core.rollout import make_table_policy, select_state
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.tables import ensure_tables
from pymgrid_tpu_torch.parallel.batch import drop_config_axis

__all__ = ["BatchedDiscreteEnv", "BatchedContinuousEnv"]


class _BatchedEnv:
    """What both envs share: params on the device, reset, the auto-reset
    step, the fused rollout and checkpoints.  Subclasses set
    ``_normalized``, ``_action_tail`` (the per-replica action shape) and
    ``_action_dtype``, and map actions in ``_engine_action``."""

    _normalized = False

    def __init__(self, env, batch_size, dtype, device, auto_reset):
        self.batch_size = batch_size
        self.auto_reset = auto_reset
        self.device, self.dtype = resolve_device(device), torch_dtype(dtype)
        self.spec, params, _ = extract_spec(env, dtype=numpy_dtype(dtype))
        check_supported(self.spec)
        self.params = ensure_tables(
            self.spec,
            with_config_axis(params_to_torch(params, self.device, self.dtype)),
            config_axis=True,
        )
        self.obs_dim = self.spec.obs_dim
        self._reset_fn = make_reset_fn(self.spec)
        self._step_fns = {}    # (with_obs, with_log) -> engine step

    def _engine_action(self, states, actions):
        raise NotImplementedError

    def _step_fn(self, with_obs, with_log):
        key = (bool(with_obs), bool(with_log))
        if key not in self._step_fns:
            self._step_fns[key] = make_step_fn(
                self.spec, normalized=self._normalized, with_obs=key[0],
                with_log=key[1], obs_layout="env",
            )
        return self._step_fns[key]

    def _actions(self, actions, time_major):
        """``actions`` as a tensor on the device of shape ``(B,) + tail``
        (``(T, B) + tail`` when ``time_major``); ``ValueError`` otherwise."""
        if isinstance(actions, torch.Tensor):
            actions = actions.to(self.device)
        else:
            actions = torch.as_tensor(np.asarray(actions), device=self.device)
        lead = (tuple(actions.shape[:1]) if time_major else ()) + (self.batch_size,)
        if tuple(actions.shape) != lead + self._action_tail:
            want = ("T",) * time_major + (self.batch_size,) + self._action_tail
            raise ValueError(f"{'action_seq' if time_major else 'actions'} must have "
                             f"shape ({', '.join(map(str, want))}), got "
                             f"{tuple(actions.shape)}")
        return actions.to(self._action_dtype)

    def _advance(self, step_fn, states, actions):
        """One step of ``(C, B)`` states, with the auto-reset."""
        new_states, out = step_fn(self.params, states,
                                  self._engine_action(states, actions))
        if self.auto_reset:
            starts = self.params["initial_step"].to(torch.int32).unsqueeze(1)
            fresh = self._reset_fn(self.params, starts.expand(new_states["step"].shape))
            new_states = select_state(out.done, fresh, new_states)
        return new_states, out

    @staticmethod
    def _lift(states):
        """``(B, ...)`` states -> ``(1, B, ...)``; a shared step of shape
        ``()`` or ``(1,)`` becomes ``(1, 1)``."""
        lifted = with_config_axis(states)
        lifted["step"] = states["step"].reshape(1, -1)
        return lifted

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        """``(B, ...)`` initial states (observations come from step
        outputs).  They do not depend on ``seed``: every forecaster the port
        supports is a pure function of time (the JAX reset keys only
        jax-PRNG gaussian forecasts, ROADMAP.md A14)."""
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        return without_config_axis(
            self._reset_fn(self.params, starts.expand(1, self.batch_size))
        )

    def step(self, states, actions):
        """One step of every replica; returns ``(new_states, StepOutput)``
        with ``(B, ...)`` fields."""
        actions = self._actions(actions, time_major=False)
        new_states, out = self._advance(self._step_fn(True, True),
                                        self._lift(states), actions.unsqueeze(0))
        return without_config_axis(new_states), drop_config_axis(out)

    def rollout(self, states, action_seq, keep_logs=False, keep_obs=True,
                shared_step=False):
        """T steps of ``action_seq`` (``(T, B, ...)``); returns
        ``(final_states, outs)``, ``outs`` a time-major StepOutput equal to T
        ``step()`` calls bitwise.  ``log_row`` is ``None`` unless
        ``keep_logs``; ``obs`` is ``None`` when ``keep_obs=False``.

        ``shared_step=True`` needs states whose replicas share the step (as
        ``reset()`` returns them); the final states keep one shared step of
        shape ``(1,)``: pass them back only to another ``shared_step``
        rollout."""
        action_seq = self._actions(action_seq, time_major=True)
        n_steps = action_seq.shape[0]
        states = self._lift(states)
        if shared_step:
            states["step"] = states["step"][:, :1]
        step_fn = self._step_fn(keep_obs, keep_logs)
        buffers = None
        for t in range(n_steps):
            states, out = self._advance(step_fn, states, action_seq[t].unsqueeze(0))
            if buffers is None:
                buffers = [None if f is None else
                           torch.empty((n_steps,) + f.shape[1:], dtype=f.dtype,
                                       device=f.device)
                           for f in out]
            for buf, f in zip(buffers, out):
                if buf is not None:
                    buf[t].copy_(f[0])
        return without_config_axis(states), StepOutput(*buffers)

    def save_states(self, path, states):
        """Checkpoint a batch state to the file ``path``."""
        from pymgrid_tpu_torch.utils.checkpoint import save_state

        save_state(path, states)

    def restore_states(self, path):
        """Restore a checkpoint onto this env's device and dtypes; resuming
        from it is bitwise-identical to an uninterrupted run."""
        from pymgrid_tpu_torch.utils.checkpoint import restore_state

        return restore_state(path, template=self.reset())


class BatchedDiscreteEnv(_BatchedEnv):
    """``batch_size`` replicas of the host ``DiscreteMicrogridEnv`` ``env``:
    ``step(states, action_indices)`` takes ``(B,)`` integer actions."""

    _action_tail = ()
    _action_dtype = torch.int64

    def __init__(self, env, batch_size, dtype, device="cuda", auto_reset=True):
        super().__init__(env, batch_size, dtype, device, auto_reset)
        self.n_actions = env.action_space.n
        self._policy = make_table_policy(
            self.spec, [list(pl) for pl in env.actions_list], self.device
        )

    def _engine_action(self, states, actions):
        return self._policy(self.params, states, actions)


class BatchedContinuousEnv(_BatchedEnv):
    """``batch_size`` replicas of the host ``ContinuousMicrogridEnv``
    ``env``: ``step(states, actions)`` takes ``(B, action_dim)`` values in
    [0, 1], whose segments follow the env's ``_nested_action_space`` order
    (sorted module names)."""

    _normalized = True

    def __init__(self, env, batch_size, dtype, device="cuda", auto_reset=True):
        super().__init__(env, batch_size, dtype, device, auto_reset)
        by_module = {(ref.name, ref.num): ref for ref in self.spec.controllable}
        self._segments, offset = [], 0     # (kind, slot, offset, width)
        for name, boxes in env._nested_action_space.items():
            for num, box in enumerate(boxes):
                ref = by_module[(name, num)]
                self._segments.append((ref.kind, ref.slot, offset, box.shape[0]))
                offset += box.shape[0]
        self.action_dim = offset
        self._action_tail = (offset,)
        self._action_dtype = self.dtype

    def _engine_action(self, states, flat):
        batch, spec = flat.shape[:2], self.spec
        zeros = lambda *tail: torch.zeros(batch + tail, dtype=self.dtype,
                                          device=self.device)
        action = {"battery": zeros(spec.n_battery), "genset": zeros(spec.n_genset, 2),
                  "grid": zeros(spec.n_grid)}
        for kind, slot, offset, width in self._segments:
            if kind == "genset":
                action["genset"][..., slot, :] = flat[..., offset:offset + width]
            else:
                action[kind][..., slot] = flat[..., offset]
        return action

    def sample_actions(self, rng):
        """Uniform random normalized actions from a numpy ``RandomState``."""
        return rng.rand(self.batch_size, self.action_dim)
