"""Engine rollouts: time loops and in-engine policies.

Port of :mod:`pymgrid_tpu.core.rollout`.  ``lax.scan`` becomes a Python loop
over steps; a policy is a plain function ``(params, state) -> action`` on
``(C, B)`` tensors, evaluated before every step.  Params stay tensors on the
operand's device throughout: on CUDA a division by a Python float turns into a
multiplication by its reciprocal, which breaks bitwise parity with the numpy
host layer (the same rule the JAX package follows against XLA's constant
folding).
"""
import numpy as np
import torch

from pymgrid_tpu_torch.core import prng
from pymgrid_tpu_torch.core.tables import row_table_layout
from pymgrid_tpu_torch._device import resolve_device, torch_dtype
from pymgrid_tpu_torch.core.engine import (
    StepOutput,
    slot_param,
    gather_rows,
    make_reset_fn,
    make_step_fn,
)
from pymgrid_tpu_torch.utils.profiling import count, span

__all__ = [
    "make_rollout_fn",
    "rollout_policy",
    "rollout_actions",
    "make_lockstep_sweep_fn",
    "lockstep_states",
    "make_priority_policy",
    "make_table_policy",
    "make_marginal_cost_policy",
    "make_random_policy",
    "select_state",
    "initial_steps",
    "auto_reset",
]


def select_state(cond, fresh, current):
    """Per-replica ``where(cond, fresh, current)`` over a nested state;
    ``cond`` is ``(C, B)`` and broadcasts over each leaf's trailing axes.

    A shared ``(C, 1)`` leaf (the lockstep ``step``) stays shared: it takes
    replica 0's condition, which speaks for all, since every replica of a
    config has the same time and ``done`` depends on the time alone.
    ``fresh`` must then be shared too (a reset from ``(C, 1)`` starts)."""
    if isinstance(current, dict):
        return {k: select_state(cond, fresh[k], current[k]) for k in current}
    if current.dim() >= 2 and current.shape[1] == 1:
        cond = cond[:, :1]
    c = cond.view(cond.shape + (1,) * (current.dim() - cond.dim()))
    return torch.where(c, fresh, current)


def initial_steps(params, like):
    """``params["initial_step"]`` broadcast to the ``(C, B)`` of ``like``."""
    return params["initial_step"].to(torch.int32).unsqueeze(1).expand(like.shape)


def auto_reset(reset_fn, params, new_states, out, starts_of):
    """Where ``out.done``, a replica's state becomes a fresh one built by
    ``reset_fn`` at ``starts_of(new_states)`` and re-keyed from its own
    ``rng``, as the JAX rollouts re-key it; the whole under the span
    ``pymgrid.engine.auto_reset``, counting ``pymgrid.engine.fresh_states``."""
    with span("pymgrid.engine.auto_reset"):
        fresh = reset_fn(params, starts_of(new_states), new_states.get("rng"))
        count("pymgrid.engine.fresh_states", new_states["step"].numel())
        return select_state(out.done, fresh, new_states)


_auto_reset = auto_reset   # for make_rollout_fn, whose ``auto_reset`` flag hides it


def make_rollout_fn(spec, policy, n_steps, normalized=False, auto_reset=False,
                    collect=True):
    """Build ``(params, state) -> (final_state, outputs)``.

    ``outputs`` is a time-major :class:`StepOutput` (every field ``(T, C, B,
    ...)``) when ``collect``, else ``(rewards, dones)`` only, each
    ``(T, C, B)``.  With ``auto_reset`` a finished replica restarts at
    ``params["initial_step"]``, re-keyed from its own ``rng`` as the JAX
    rollout re-keys it.  ``normalized``: the policy emits actions in
    [0, 1] (e.g. :func:`make_random_policy`); the rule-based policies emit
    raw ones.
    """
    step_fn = make_step_fn(spec, normalized=normalized, with_obs=collect,
                           with_log=collect)
    reset_fn = make_reset_fn(spec)

    def rollout(params, state):
        outs = []
        for _ in range(n_steps):
            action = policy(params, state)
            new_state, out = step_fn(params, state, action)
            if auto_reset:
                new_state = _auto_reset(reset_fn, params, new_state, out,
                                        lambda s: initial_steps(params, s["step"]))
            outs.append(out if collect else (out.reward, out.done))
            state = new_state
        stacked = [torch.stack(field) for field in zip(*outs)]
        if collect:
            return state, StepOutput(*stacked)
        return state, tuple(stacked)

    return rollout


def rollout_policy(spec, params, state, policy, n_steps, normalized=False,
                   auto_reset=False, collect=True):
    """One-shot convenience wrapper over :func:`make_rollout_fn`."""
    fn = make_rollout_fn(spec, policy, n_steps, normalized=normalized,
                         auto_reset=auto_reset, collect=collect)
    return fn(params, state)


def rollout_actions(spec, params, state, actions, normalized=False):
    """Step precomputed time-major actions (a dict of ``(T, C, B, ...)``
    tensors) through the engine; returns ``(final_state, outputs)`` with a
    time-major :class:`StepOutput`."""
    step_fn = make_step_fn(spec, normalized=normalized)
    outs = []
    for t in range(actions["battery"].shape[0]):
        state, out = step_fn(params, state, {k: v[t] for k, v in actions.items()})
        outs.append(out)
    return state, StepOutput(*[torch.stack(field) for field in zip(*outs)])


def make_lockstep_sweep_fn(spec, policy, n_steps, normalized=False):
    """Rollout for LOCKSTEP replica sweeps: every replica of a config shares
    the simulated time (``state["step"]`` is ``(C, 1)``), only battery charge
    and the genset machine are per replica.  Time-dependent rows are read
    once per config per step, rewards accumulate, nothing is written per
    step.

    ``normalized``: the policy's actions are in [0, 1], as
    :func:`make_rollout_fn`'s.  Returns ``(params, states) -> (final_states,
    cum_reward (C, B))``, with ``states`` from :func:`lockstep_states`.
    """
    step_fn = make_step_fn(spec, normalized=normalized, with_obs=False, with_log=False)

    def sweep(params, states):
        acc = torch.zeros(states["battery_charge"].shape[:2],
                          dtype=torch_dtype(spec.dtype),
                          device=states["battery_charge"].device)
        for _ in range(n_steps):
            action = policy(params, states)
            states, out = step_fn(params, states, action)
            acc = acc + out.reward
        return states, acc

    return sweep


def lockstep_states(spec, params, batched_states):
    """Per-replica reset states whose replicas share ``step`` -> the
    shared-time layout :func:`make_lockstep_sweep_fn` consumes."""
    out = dict(batched_states)
    out["step"] = batched_states["step"][:, :1]
    return out


def _row_accessor(spec, params, t, state=None):
    """``(kind, slot) -> current raw ts row (C, B, width)`` at step ``t``:
    a prefetched ``state["table_row"]`` (the suite's block-prefetch rollout)
    when the state carries one, else one row gather from ``step_table`` when
    tables are attached, else per-slot series reads; all give the same
    values."""
    raw = None
    if state is not None and "table_row" in state:
        raw = state["table_row"]
    elif "step_table" in params:
        raw = gather_rows(params["step_table"], t)
    if raw is not None:
        layout, _ = row_table_layout(spec)

        def cur(kind, slot):
            off, width = layout[(kind, slot)]
            return raw[..., off : off + width]

        return cur
    return lambda kind, slot: gather_rows(params[kind]["ts"][:, slot], t)


def _net_load(spec, cur_row, zero):
    total_load = zero
    for ref in spec.fixed:
        total_load = total_load + (-cur_row("load", ref.slot)[..., 0])
    renewable = zero
    for ref in spec.flex:
        if ref.kind == "renewable":
            renewable = renewable + cur_row("renewable", ref.slot)[..., 0]
    return total_load - renewable


def _clamp_produce(remaining, min_p, max_p):
    return torch.where(
        remaining < min_p, min_p, torch.where(remaining > max_p, max_p, remaining)
    )


def _deploy(remaining, min_p, max_p, max_c):
    near_zero = remaining.abs() <= 1e-4
    consume = torch.where(-remaining > max_c, -max_c, remaining)
    return torch.where(
        near_zero, 0.0,
        torch.where(remaining > 0, _clamp_produce(remaining, min_p, max_p), consume),
    )


def _genset_next_on_off(state, slot):
    """Predicted genset status (policy side) under goal on and goal off."""
    gs = state["genset"]
    cur = gs["current_status"][..., slot]
    up_ready = gs["steps_until_up"][..., slot] == 0
    down_ready = gs["steps_until_down"][..., slot] == 0
    next_on = torch.where(cur == 1, 1, torch.where(up_ready, 1, 0))
    next_off = torch.where(cur == 0, 0, torch.where(down_ready, 0, 1))
    return next_on, next_off


def _genset_next_status_f(state, slot, goal, dtype):
    """Predicted genset status under ``goal`` (a tensor), as ``dtype``."""
    next_on, next_off = _genset_next_on_off(state, slot)
    return torch.where(goal == 1, next_on, next_off).to(dtype)


def _genset_energy(remaining, nsf, p, slot):
    min_p = nsf * slot_param(p["running_min_production"], slot)
    max_p = nsf * slot_param(p["running_max_production"], slot)
    near_zero = remaining.abs() <= 1e-4
    return torch.where(
        near_zero, 0.0,
        torch.where(remaining > 0, _clamp_produce(remaining, min_p, max_p), 0.0),
    )


def _battery_bounds(params, state, slot):
    p = params["battery"]
    charge = state["battery_charge"][..., slot]
    eff = slot_param(p["efficiency"], slot)
    max_p = torch.minimum(
        slot_param(p["max_discharge"], slot), charge - slot_param(p["min_capacity"], slot)
    ) * eff
    max_c = torch.minimum(
        slot_param(p["max_charge"], slot), slot_param(p["max_capacity"], slot) - charge
    ) / eff
    return max_p, max_c


def _grid_bounds(params, cur_row, slot):
    p = params["grid"]
    status = cur_row("grid", slot)[..., 3]
    return slot_param(p["max_import"], slot) * status, slot_param(p["max_export"], slot) * status


def _action(spec, batch, slots, dtype, device):
    """Action dict of ``(C, B, n[, 2])`` tensors from per-slot values
    (``slots[kind][slot]``; missing slots are 0)."""
    def col(kind, i):
        value = slots[kind].get(i, 0.0)
        return torch.as_tensor(value, dtype=dtype, device=device).expand(batch)

    def stack(cols, tail):
        if not cols:
            return torch.zeros(batch + tail, dtype=dtype, device=device)
        return torch.stack(cols, dim=len(batch))

    return {
        "battery": stack([col("battery", i) for i in range(spec.n_battery)], (0,)),
        "genset": stack([torch.stack([col("genset_goal", i), col("genset", i)], -1)
                         for i in range(spec.n_genset)], (0, 2)),
        "grid": stack([col("grid", i) for i in range(spec.n_grid)], (0,)),
    }


def _batch_of(state):
    return torch.broadcast_shapes(state["step"].shape,
                                  state["battery_charge"].shape[:-1])


def make_priority_policy(spec, priority_list):
    """Compile a priority list into an engine policy (mirror of
    ``PriorityListAlgo._populate_action``): net load = fixed-sink consumption
    minus flex-source availability; walk the static list, deploying each
    controllable module against the remainder."""
    dtype = torch_dtype(spec.dtype)
    by_module = {(ref.name, ref.num): ref for ref in spec.controllable}

    # first element of a multi-action module fixes its goal action
    seen, elements = set(), []
    for el in priority_list:
        if el.module in seen:
            continue
        seen.add(el.module)
        if el.module not in by_module:
            raise KeyError(f"Priority element {el} has no controllable module")
        elements.append((by_module[el.module], el))

    def policy(params, state):
        t = state["step"]
        device = t.device
        zero = torch.zeros((), dtype=dtype, device=device)
        cur_row = _row_accessor(spec, params, t, state)
        remaining = _net_load(spec, cur_row, zero)
        slots = {"battery": {}, "genset": {}, "genset_goal": {}, "grid": {}}

        for ref, el in elements:
            if ref.kind == "genset":
                nsf = _genset_next_status_f(
                    state, ref.slot, torch.tensor(el.action, device=device), dtype
                )
                energy = _genset_energy(remaining, nsf, params["genset"], ref.slot)
                slots["genset_goal"][ref.slot] = float(el.action)
            else:
                if ref.kind == "battery":
                    max_p, max_c = _battery_bounds(params, state, ref.slot)
                else:
                    max_p, max_c = _grid_bounds(params, cur_row, ref.slot)
                energy = _deploy(remaining, zero, max_p, max_c)
            slots[ref.kind][ref.slot] = energy
            remaining = remaining - energy

        return _action(spec, _batch_of(state), slots, dtype, device)

    return policy


def make_marginal_cost_policy(spec):
    """Priority-list RBC with the deployment order computed at run time from
    each config's marginal costs (battery at ``battery_cost_cycle``, grid at
    the import price at ``initial_step``, genset at
    ``fuel + cost_co2 * co2_per_unit``), sorted stably per config.  One
    policy serves a heterogeneous config batch.

    Requires at most one module per controllable kind (the suite superset).
    """
    if spec.n_battery > 1 or spec.n_genset > 1 or spec.n_grid > 1:
        raise NotImplementedError(
            "Runtime-ordered RBC supports at most one module per controllable "
            "kind; use make_priority_policy with an explicit list."
        )
    dtype = torch_dtype(spec.dtype)

    def policy(params, state):
        t = state["step"]
        device = t.device
        zero = torch.zeros((), dtype=dtype, device=device)
        cur_row = _row_accessor(spec, params, t, state)
        remaining = _net_load(spec, cur_row, zero)

        costs, deploys = [], []
        if spec.n_genset:
            pgen = params["genset"]
            # the reference's default list keeps the genset ON only when
            # running_min_production == 0 (priority_list.py:40-67)
            goal = torch.where(slot_param(pgen["running_min_production"], 0) == 0, 1, 0)

            def deploy_genset(remaining):
                nsf = _genset_next_status_f(state, 0, goal, dtype)
                return _genset_energy(remaining, nsf, pgen, 0)

            costs.append(pgen["genset_cost"][:, 0]
                         + pgen["cost_per_unit_co2"][:, 0] * pgen["co2_per_unit"][:, 0])
            deploys.append(("genset", deploy_genset))

        if spec.n_battery:
            def deploy_battery(remaining):
                max_p, max_c = _battery_bounds(params, state, 0)
                return _deploy(remaining, zero, max_p, max_c)

            costs.append(params["battery"]["battery_cost_cycle"][:, 0])
            deploys.append(("battery", deploy_battery))

        if spec.n_grid:
            def deploy_grid(remaining):
                max_p, max_c = _grid_bounds(params, cur_row, 0)
                return _deploy(remaining, zero, max_p, max_c)

            t0 = params["initial_step"].unsqueeze(1)
            costs.append(gather_rows(params["grid"]["ts"][:, 0], t0)[:, 0, 0])
            deploys.append(("grid", deploy_grid))

        # (C, k) costs -> per-config stable order; position p deploys the
        # branch order[:, p] (a per-config select among the k branches)
        order = torch.argsort(torch.stack(costs, dim=-1), dim=-1, stable=True)
        energies = {kind: zero for kind, _ in deploys}
        for position in range(len(deploys)):
            idx = order[:, position].unsqueeze(1)
            branch = [fn(remaining) for _, fn in deploys]
            chosen = branch[0]
            for j in range(1, len(branch)):
                chosen = torch.where(idx == j, branch[j], chosen)
            for j, (kind, _) in enumerate(deploys):
                energies[kind] = torch.where(idx == j, branch[j], energies[kind])
            remaining = remaining - chosen

        slots = {"battery": {}, "genset": {}, "genset_goal": {}, "grid": {}}
        for kind, energy in energies.items():
            slots[kind][0] = energy
        if spec.n_genset:
            slots["genset_goal"][0] = goal.to(dtype)
        return _action(spec, _batch_of(state), slots, dtype, device)

    return policy


_KINDS = {"battery": 0, "genset": 1, "grid": 2}


def make_table_policy(spec, priority_lists, device="cuda"):
    """Compile ALL priority lists into one table-driven policy
    ``(params, state, action_idx) -> action``, ``action_idx`` a ``(C, B)``
    integer tensor (out-of-range indices clamp, as a JAX gather does).

    Every list is encoded once as an integer device table
    ``[kind | slot | goal][action, position]``; each replica reads its row
    with one index by its action.  Per deployment position the policy
    computes every controllable module's energy candidate and selects by the
    row's entry, so its cost is O(n_positions x n_controllable) whatever the
    number of actions.  The per-position ``where(sel, e, 0)`` accumulation is
    the JAX policy's own, which keeps the two bitwise equal.
    """
    dtype = torch_dtype(spec.dtype)
    by_module = {(ref.name, ref.num): ref for ref in spec.controllable}
    n_actions, n_positions = len(priority_lists), len(priority_lists[0])
    table = np.zeros((n_actions, 3, n_positions), np.int64)
    for a, plist in enumerate(priority_lists):
        if len(plist) != n_positions:
            raise ValueError("All priority lists must have equal length.")
        for k, el in enumerate(plist):
            ref = by_module[el.module]
            table[a, :, k] = (_KINDS[ref.kind], ref.slot, el.action)
    table = torch.as_tensor(table.reshape(n_actions, 3 * n_positions),
                            device=resolve_device(device))
    ctrl_refs = [(ref.kind, ref.slot) for ref in spec.controllable]

    def policy(params, state, action_idx):
        t = state["step"]
        zero = torch.zeros((), dtype=dtype, device=t.device)
        cur_row = _row_accessor(spec, params, t, state)
        remaining = _net_load(spec, cur_row, zero)
        row = table[action_idx.long().clamp(0, n_actions - 1)]   # (C, B, 3 * n_pos)
        kinds, slots, goals = row.unflatten(-1, (3, n_positions)).unbind(-2)

        # what each candidate needs that does not depend on the position
        bounds, next_status = {}, {}
        for kind, slot in ctrl_refs:
            if kind == "battery":
                bounds[(kind, slot)] = _battery_bounds(params, state, slot)
            elif kind == "grid":
                bounds[(kind, slot)] = _grid_bounds(params, cur_row, slot)
            else:
                next_status[slot] = _genset_next_on_off(state, slot)

        energy_acc = {pair: zero for pair in ctrl_refs}
        goal_acc = {slot: zero for kind, slot in ctrl_refs if kind == "genset"}
        for k in range(n_positions):
            kind_k, slot_k, goal_k = kinds[..., k], slots[..., k], goals[..., k]
            energy_k = zero
            for kind, slot in ctrl_refs:
                sel = (kind_k == _KINDS[kind]) & (slot_k == slot)
                if kind == "genset":
                    on, off = next_status[slot]
                    nsf = torch.where(goal_k == 1, on, off).to(dtype)
                    e = _genset_energy(remaining, nsf, params["genset"], slot)
                    goal_acc[slot] = goal_acc[slot] + torch.where(sel, goal_k.to(dtype), 0.0)
                else:
                    e = _deploy(remaining, zero, *bounds[(kind, slot)])
                energy_k = torch.where(sel, e, energy_k)
                energy_acc[(kind, slot)] = energy_acc[(kind, slot)] + torch.where(sel, e, 0.0)
            remaining = remaining - energy_k

        slots_out = {"battery": {}, "genset": {}, "genset_goal": goal_acc, "grid": {}}
        for (kind, slot), energy in energy_acc.items():
            slots_out[kind][slot] = energy
        return _action(spec, _batch_of(state), slots_out, dtype, t.device)

    return policy


def make_random_policy(spec, normalized=True):
    """Uniform random actions in [0, 1] (for a ``normalized=True`` step),
    the JAX policy's draws: per replica ``fold_in(state["rng"], 7)`` split in
    three, each a ``uniform`` of shape ``(n_battery,)``, ``(n_genset, 2)`` and
    ``(n_grid,)``.  The state must carry keys (a reset given keys); like the
    JAX policy it takes ``normalized`` and ignores it."""
    dtype = torch_dtype(spec.dtype)

    def policy(params, state):
        if "rng" not in state:
            raise ValueError("the random policy draws from the state's keys: reset "
                             "with keys (make_reset_fn(spec)(params, starts, keys))")
        kb, kg, kr = prng.split(prng.fold_in(state["rng"], 7), 3).unbind(-2)
        return {
            "battery": prng.uniform(kb, (spec.n_battery,), dtype),
            "genset": prng.uniform(kg, (spec.n_genset, 2), dtype),
            "grid": prng.uniform(kr, (spec.n_grid,), dtype),
        }

    return policy
