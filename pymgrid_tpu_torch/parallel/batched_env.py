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
``(B, ...)`` leaves; the engine's config axis (``C = 1``) is added and
removed inside.  A spec with threefry-gaussian forecasts keeps the JAX
leaves ``rng`` ``(B, 2)`` and ``forecast``: ``reset(seed)`` keys the
replicas with ``split(key(seed), B)`` over the global batch and an
auto-reset re-keys a replica from its own ``rng``, so the port draws the
JAX env's forecasts for the same seed; other specs carry no ``rng``.  Observations come out in the env's order
(``obs_layout="env"``); ``obs_layout="log"`` gives the engine's container
order instead, the layout the training examples feed their MLPs.

With ``mesh=`` (a :class:`~pymgrid_tpu_torch.parallel.distributed.BatchMesh`)
``batch_size`` is the job's global batch and this rank holds its rows on the
mesh's device: ``reset`` returns the local states, ``step`` and ``rollout``
take the global actions and use this rank's rows (as the JAX
``_shard_inputs`` places them), and outputs are local;
:func:`~pymgrid_tpu_torch.parallel.distributed.fetch` assembles them.

``rollout`` is a Python loop over the action sequence.  The engine step is
built once per ``(keep_obs, keep_logs)`` and builds only what is kept (the
port's form of XLA's dead-code elimination in the JAX rollout), and the
outputs go into ``(T, B, ...)`` buffers allocated at the first step.
``shared_step=True`` carries one ``(C, 1)`` simulated time for all replicas,
the lockstep layout: time rows are read once per step instead of once per
replica.  It holds for ``reset()`` states (one start, and auto-resets fire
together since ``done`` depends on the time alone) and gives the same
outputs bitwise.

On a CUDA device ``step`` replays one recorded step (policy, engine step,
auto-reset; :mod:`~pymgrid_tpu_torch.utils.cuda_graph`), one launch in place
of ~230, bitwise, and returns new tensors, which later calls leave as they
are.  The env keeps one recording per ``keep_logs``, layout of the states
and actions, and params' addresses; a ``custom_fn`` spec, an input that
requires grad and ``rollout`` run eagerly.
"""
import numpy as np
import torch

from pymgrid_tpu_torch._device import numpy_dtype, torch_dtype
from pymgrid_tpu_torch.core.engine import (
    StepOutput,
    check_supported,
    make_reset_fn,
    make_step_fn,
)
from pymgrid_tpu_torch.core.params import (
    copy_into,
    params_to_torch,
    tree_addresses,
    tree_layout,
    tree_leaves,
    tree_map,
    with_config_axis,
    without_config_axis,
)
from pymgrid_tpu_torch.core.rollout import auto_reset, initial_steps, make_table_policy
from pymgrid_tpu_torch.core.spec import extract_spec
from pymgrid_tpu_torch.core.tables import ensure_tables
from pymgrid_tpu_torch.parallel.batch import drop_config_axis, replica_keys
from pymgrid_tpu_torch.parallel.distributed import local_layout
from pymgrid_tpu_torch.utils.cuda_graph import Recording, graphable
from pymgrid_tpu_torch.utils.profiling import count, span

__all__ = ["BatchedDiscreteEnv", "BatchedContinuousEnv"]


class _BatchedEnv:
    """What both envs share: params on the device, reset, the auto-reset
    step, the fused rollout and checkpoints.  Subclasses set
    ``_normalized``, ``_action_tail`` (the per-replica action shape) and
    ``_action_dtype``, and map actions in ``_engine_action``."""

    _normalized = False

    def __init__(self, env, batch_size, dtype, device, auto_reset, mesh, obs_layout):
        self.batch_size = batch_size
        self.auto_reset = auto_reset
        self.mesh = mesh
        self.device, self.local_batch_size, self._rows = local_layout(mesh, batch_size, device)
        self.dtype = torch_dtype(dtype)
        self.obs_layout = obs_layout
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
        self._graph_steps = graphable(self.device, self.spec)
        self._graphs = {}      # signature -> (Recording, state views, action view)

    def _engine_action(self, states, actions):
        raise NotImplementedError

    def _step_fn(self, with_obs, with_log):
        key = (bool(with_obs), bool(with_log))
        if key not in self._step_fns:
            self._step_fns[key] = make_step_fn(
                self.spec, normalized=self._normalized, with_obs=key[0],
                with_log=key[1], obs_layout=self.obs_layout,
            )
        return self._step_fns[key]

    def _actions(self, actions, time_major):
        """``actions`` as a tensor on the device of shape ``(B,) + tail``
        (``(T, B) + tail`` when ``time_major``; ``B`` the global batch),
        ``ValueError`` otherwise; returns this rank's rows."""
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
        actions = actions[:, self._rows] if time_major else actions[self._rows]
        return actions.to(self._action_dtype)

    def _advance(self, step_fn, states, actions):
        """One step of ``(C, B)`` states, with the auto-reset."""
        with span("pymgrid.engine.policy"):
            action = self._engine_action(states, actions)
        new_states, out = step_fn(self.params, states, action)
        if self.auto_reset:
            new_states = auto_reset(self._reset_fn, self.params, new_states, out,
                                    lambda s: initial_steps(self.params, s["step"]))
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
        """``(B, ...)`` initial states (this rank's rows with a mesh;
        observations come from step outputs).  ``seed`` keys
        threefry-gaussian forecasts (``split(key(seed), B)`` over the global
        batch, so meshed and unmeshed runs draw alike); other forecasters
        draw nothing."""
        starts = self.params["initial_step"].to(torch.int32).view(1, 1)
        keys = replica_keys(self.spec, seed, self.batch_size, self._rows, self.device)
        return without_config_axis(
            self._reset_fn(self.params, starts.expand(1, self.local_batch_size), keys)
        )

    def step(self, states, actions, keep_logs=True):
        """One step of every replica; returns ``(new_states, StepOutput)``
        with ``(B, ...)`` fields (``log_row`` is ``None`` unless
        ``keep_logs``).  States whose replicas share one step of shape
        ``(1,)`` (a ``shared_step`` rollout's final states) keep it shared.
        On a CUDA device the call replays a recorded step (see the module
        docstring)."""
        with span("pymgrid.env.step"):
            actions = self._actions(actions, time_major=False)
            if self._graph_steps and not (actions.requires_grad or any(
                    x.requires_grad for x in tree_leaves(states))):
                return self._replayed(states, actions, keep_logs)
            new_states, out = self._advance(self._step_fn(True, keep_logs),
                                            self._lift(states), actions.unsqueeze(0))
            return without_config_axis(new_states), drop_config_axis(out)

    def _replayed(self, states, actions, keep_logs):
        """The step as a replay of its signature's recording, made at the
        signature's first call.  The caller's ``(B, ...)`` inputs go in
        through ``(B, ...)`` views of the recording's ``(1, B, ...)`` ones,
        made once; the outputs come back as clones."""
        params = tree_addresses(self.params)
        signature = (bool(keep_logs), tree_layout(states), actions.shape, actions.dtype,
                     params)
        entry = self._graphs.get(signature)
        if entry is None:
            # a recording reads the params' leaves where they were: free
            # those of other params before recording
            self._graphs = {k: g for k, g in self._graphs.items() if k[-1] == params}
            step_fn = self._step_fn(True, keep_logs)
            recording = Recording(lambda s, a: self._advance(step_fn, s, a),
                                  (self._lift(states), actions.unsqueeze(0)))
            lifted, lifted_actions = recording.inputs
            views = without_config_axis(lifted)
            views["step"] = lifted["step"].view(states["step"].shape)
            entry = self._graphs[signature] = (recording, views, lifted_actions[0])
            count("pymgrid.env.graph_captures", 1)
        recording, state_views, action_view = entry
        copy_into(state_views, states)
        action_view.copy_(actions)
        with span("pymgrid.env.graph_replay"):
            recording.replay()
        count("pymgrid.env.graph_replays", 1)
        new_states, out = recording.outputs
        return (tree_map(lambda x: x[0].clone(), new_states),
                StepOutput(*[None if f is None else f[0].clone() for f in out]))

    def rollout(self, states, action_seq, keep_logs=False, keep_obs=True,
                shared_step=False):
        """T steps of ``action_seq`` (``(T, B, ...)``); returns
        ``(final_states, outs)``, ``outs`` a time-major StepOutput equal to T
        ``step()`` calls bitwise.  ``log_row`` is ``None`` unless
        ``keep_logs``; ``obs`` is ``None`` when ``keep_obs=False``.

        ``shared_step=True`` needs states whose replicas share the step (as
        ``reset()`` returns them); the final states keep one shared step of
        shape ``(1,)``: pass them back only to another ``shared_step``
        rollout.  Keys and gaussian windows stay per replica."""
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
        """Checkpoint a batch state (every leaf, ``rng`` and ``forecast``
        included): to the file ``path``, or with a mesh to the directory
        ``path``, one file per rank holding its rows
        (:func:`~pymgrid_tpu_torch.utils.checkpoint.save_rank_state`; the
        files together are the global batch)."""
        from pymgrid_tpu_torch.utils import checkpoint

        if self.mesh is None:
            checkpoint.save_state(path, states)
        else:
            checkpoint.save_rank_state(path, states, self.mesh, self.batch_size)

    def restore_states(self, path):
        """Restore a checkpoint onto this env's device and dtypes (with a
        mesh: this rank's own rows; ``ValueError`` for a checkpoint saved at
        another world size); resuming from it is bitwise-identical to an
        uninterrupted run."""
        from pymgrid_tpu_torch.utils import checkpoint

        template = self.reset()
        if self.mesh is None:
            return checkpoint.restore_state(path, template=template)
        return checkpoint.restore_rank_state(path, template, self.mesh, self.batch_size)


class BatchedDiscreteEnv(_BatchedEnv):
    """``batch_size`` replicas of the host ``DiscreteMicrogridEnv`` ``env``:
    ``step(states, action_indices)`` takes ``(B,)`` integer actions."""

    _action_tail = ()
    _action_dtype = torch.int64

    def __init__(self, env, batch_size, dtype, device="cuda", auto_reset=True, mesh=None,
                 obs_layout="env"):
        super().__init__(env, batch_size, dtype, device, auto_reset, mesh, obs_layout)
        self.n_actions = env.action_space.n
        self._policy = make_table_policy(
            self.spec, [list(pl) for pl in env.actions_list], self.device
        )

    def step(self, states, action_indices, keep_logs=True):
        """One step with ``(B,)`` integer actions; see :meth:`_BatchedEnv.step`."""
        return super().step(states, action_indices, keep_logs)

    def _engine_action(self, states, actions):
        return self._policy(self.params, states, actions)


class BatchedContinuousEnv(_BatchedEnv):
    """``batch_size`` replicas of the host ``ContinuousMicrogridEnv``
    ``env``: ``step(states, actions)`` takes ``(B, action_dim)`` values in
    [0, 1], whose segments follow the env's ``_nested_action_space`` order
    (sorted module names)."""

    _normalized = True

    def __init__(self, env, batch_size, dtype, device="cuda", auto_reset=True, mesh=None,
                 obs_layout="env"):
        super().__init__(env, batch_size, dtype, device, auto_reset, mesh, obs_layout)
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
