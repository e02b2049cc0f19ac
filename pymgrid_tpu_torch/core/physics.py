"""Pure microgrid physics: transition functions shared by the numpy host layer
and the torch engine.

Each function is written against an array-namespace argument ``xp`` (numpy or
the torch namespace of :mod:`pymgrid_tpu_torch.core.xp`) and contains no Python
data-dependent control flow, so the same definitions run on batched tensors
and evaluate eagerly on scalars.

Semantics follow the reference simulator exactly:

* source/sink clipping     — ``modules/base/base_module.py:173-274``
* battery transition       — ``modules/battery_module.py:108-130,244-291``
* genset status machine    — ``modules/genset_module.py:235-346``
* grid import/export costs — ``modules/grid_module.py:134-228``
* balancing (unmet/excess) — ``modules/unbalanced_energy_module.py:28-70``
"""
import numpy as np

__all__ = [
    "clip_source",
    "clip_sink",
    "battery_model_transition",
    "battery_max_production",
    "battery_max_consumption",
    "genset_update_status",
    "genset_next_status",
    "round_half_even",
]


def clip_source(energy_demand, min_production, max_production, xp=np):
    """Clip a source request into ``[min_production, max_production]``."""
    return xp.where(
        energy_demand > max_production,
        max_production,
        xp.where(energy_demand < min_production, min_production, energy_demand),
    )


def clip_sink(energy_excess, max_consumption, xp=np):
    """Clip a sink request into ``[0, max_consumption]``."""
    return xp.where(energy_excess > max_consumption, max_consumption, energy_excess)


def battery_model_transition(external_energy_change, efficiency, xp=np):
    """External energy request -> internal energy change.

    Discharge (negative external) costs ``1/efficiency`` internally; charge
    (positive external) retains ``efficiency`` of the energy.
    """
    return xp.where(
        external_energy_change < 0,
        external_energy_change / efficiency,
        external_energy_change * efficiency,
    )


def battery_max_production(charge, min_capacity, max_discharge, efficiency, xp=np):
    """Max external discharge: bounded by rate limit and available charge."""
    return xp.minimum(max_discharge, charge - min_capacity) * efficiency


def battery_max_consumption(charge, max_capacity, max_charge, efficiency, xp=np):
    """Max external charge: bounded by rate limit and remaining headroom."""
    return xp.minimum(max_charge, max_capacity - charge) / efficiency


def round_half_even(value, xp=np):
    """Round to the nearest integer, ties to even (Python/numpy ``round``).

    The genset goal-status action is rounded with these semantics
    (``genset_module.py:281``).
    """
    return xp.round(value)


def genset_next_status(current_status, steps_until_up, steps_until_down, goal, xp=np):
    """Predict the next status without modifying state
    (``genset_module.py:360-390``)."""
    up_ready = steps_until_up == 0
    down_ready = steps_until_down == 0
    next_if_on_goal = xp.where(current_status == 1, 1, xp.where(up_ready, 1, 0))
    next_if_off_goal = xp.where(current_status == 0, 0, xp.where(down_ready, 0, 1))
    return xp.where(goal == 1, next_if_on_goal, next_if_off_goal)


def genset_update_status(
    current_status,
    goal_status,
    steps_until_up,
    steps_until_down,
    goal,
    start_up_time,
    wind_down_time,
    allow_abortion,
    xp=np,
):
    """One tick of the genset ON/OFF state machine, branchless.

    Inputs are integer (0/1 statuses, non-negative counters); ``goal`` must
    already be rounded to {0, 1}.  Returns the updated
    ``(current_status, goal_status, steps_until_up, steps_until_down)``.

    The update happens *before* the energy dispatch of the same step, so the
    production bounds of this step see the new status.  Validated exhaustively
    against a literal sequential transcription of the reference machine in
    ``tests/test_genset_machine.py``.
    """
    goal = xp.asarray(goal)
    one = xp.ones_like(goal)
    zero = xp.zeros_like(goal)

    equilibrium = (goal == current_status) & (current_status == goal_status)

    instant_up = (start_up_time == 0) & (goal == 1)
    instant_down = (wind_down_time == 0) & (goal == 0)
    accept_new_goal = (goal != goal_status) & (
        allow_abortion | instant_up | instant_down
    )
    goal1 = xp.where(accept_new_goal, goal, goal_status)

    # _finish_in_progress_change: complete a change whose counter reached zero.
    fin_up = (steps_until_up == 0) & (goal1 == 1)
    fin_down = (~fin_up) & (steps_until_down == 0) & (goal1 == 0)
    finished = fin_up | fin_down

    cur1 = xp.where(fin_up, one, xp.where(fin_down, zero, current_status))
    up1 = xp.where(fin_up, zero, xp.where(fin_down, start_up_time, steps_until_up))
    down1 = xp.where(
        fin_up, wind_down_time, xp.where(fin_down, zero, steps_until_down)
    )

    # _non_instantaneous_update(goal), applied only when no change completed.
    # (The "abort an in-progress change" branch of the reference is
    # unreachable: with allow_abortion the goal was already overwritten above,
    # and without it the branch is gated on allow_abortion.)
    new_request = (cur1 == goal1) & (goal1 != goal)
    up2 = xp.where(new_request, xp.where(cur1 == 1, zero, start_up_time), up1)
    down2 = xp.where(new_request, xp.where(cur1 == 1, wind_down_time, zero), down1)
    goal2 = xp.where(new_request, goal, goal1)

    in_progress = goal2 != cur1
    up3 = xp.where(in_progress & (goal2 == 1), up2 - 1, up2)
    down3 = xp.where(in_progress & (goal2 == 0), down2 - 1, down2)

    non_inst = ~finished
    new_cur = xp.where(equilibrium, current_status, cur1)
    new_goal = xp.where(equilibrium, goal_status, xp.where(non_inst, goal2, goal1))
    new_up = xp.where(equilibrium, steps_until_up, xp.where(non_inst, up3, up1))
    new_down = xp.where(
        equilibrium, steps_until_down, xp.where(non_inst, down3, down1)
    )
    return new_cur, new_goal, new_up, new_down
