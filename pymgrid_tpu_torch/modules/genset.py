"""Genset (diesel generator) module (host layer).

Behavioral mirror of ``src/pymgrid/modules/genset_module.py``: a controllable
source with a two-dimensional action ``[goal_status, production]`` and an
ON/OFF state machine with start-up/wind-down delays.  Two ordering rules
matter: the status update runs *before* the energy dispatch of the same step,
and the goal component of the action is never denormalized
(``genset_module.py:100-149``).

The state machine itself is the shared branchless transition
:func:`pymgrid_tpu_torch.core.physics.genset_update_status`; this class wraps it
with the reference's validation and self-consistency invariants.
"""
from warnings import warn

import numpy as np

from pymgrid_tpu_torch.core import physics
from pymgrid_tpu_torch.modules.base import BaseMicrogridModule
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["GensetModule"]


class GensetModule(BaseMicrogridModule):
    module_type = ("genset", "controllable")
    yaml_tag = "!Genset"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    # energy request lives in the second action slot; slot 0 is goal status
    _energy_pos = 1

    # ----------------------------------------------------- identity & bounds
    is_source = property(lambda self: True)
    current_status = property(lambda self: self._current_status)
    goal_status = property(lambda self: self._goal_status)

    @property
    def max_production(self):
        return self._current_status * self.running_max_production

    @property
    def min_production(self):
        return self._current_status * self.running_min_production

    @property
    def min_obs(self):
        return np.array([0, 0, 0, 0])

    @property
    def max_obs(self):
        return np.array([1, 1, self.start_up_time, self.wind_down_time])

    @property
    def min_act(self):
        return np.array([0, 0])

    @property
    def max_act(self):
        return np.array([1, self.running_max_production])

    @property
    def production_marginal_cost(self):
        return self.get_cost(1.0)

    # -------------------------------------------------------- status machine
    def next_status(self, goal_status):
        return int(
            physics.genset_next_status(
                self._current_status,
                self._steps_until_up,
                self._steps_until_down,
                goal_status,
            )
        )

    def next_max_production(self, goal_status):
        return self.next_status(goal_status) * self.running_max_production

    def next_min_production(self, goal_status):
        return self.next_status(goal_status) * self.running_min_production

    def update_status(self, goal_status):
        """One tick of the ON/OFF machine, with the reference's invariants."""
        assert self._steps_until_down >= 0 and self._steps_until_up >= 0
        if not 0 <= goal_status <= 1:
            raise ValueError(
                f"Invalid goal_status value {goal_status}, must be in [0, 1]."
            )

        goal = int(physics.round_half_even(goal_status))
        predicted = self.next_status(goal)

        new_state = physics.genset_update_status(
            self._current_status,
            self._goal_status,
            self._steps_until_up,
            self._steps_until_down,
            goal,
            self.start_up_time,
            self.wind_down_time,
            self.allow_abortion,
        )
        (
            self._current_status,
            self._goal_status,
            self._steps_until_up,
            self._steps_until_down,
        ) = (int(v) for v in new_state)

        if self._current_status != predicted:
            raise ValueError("self.next_status working incorrectly.")

    def step(self, action, normalized=True):
        """Update status from ``action[0]`` then dispatch energy ``action[1]``."""
        requested_status = action[0]
        assert 0 <= requested_status <= 1
        self.update_status(requested_status)
        return super().step(action, normalized=normalized)

    # --------------------------------------------------------------- costs
    def get_co2(self, production):
        return self.co2_per_unit * production

    def get_co2_cost(self, production):
        return self.cost_per_unit_co2 * self.get_co2(production)

    def _get_fuel_cost(self, production):
        if callable(self.genset_cost):
            return self.genset_cost(production)
        return self.genset_cost * production

    def get_cost(self, production):
        return self._get_fuel_cost(production) + self.get_co2_cost(production)

    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_source, "This module may only act as a source."
        return (
            -1.0 * self.get_cost(external_energy_change),
            False,
            {
                "provided_energy": external_energy_change,
                "co2_production": self.get_co2(external_energy_change),
            },
        )

    def sample_action(self, strict_bound=False, **kwargs):
        return np.array(
            [np.random.rand(), super().sample_action(strict_bound=strict_bound)]
        )

    def _raise_error(self, ask_value, available_value, as_source=False, as_sink=False, lower_bound=False):
        try:
            super()._raise_error(
                ask_value,
                available_value,
                as_source=as_source,
                as_sink=as_sink,
                lower_bound=lower_bound,
            )
        except ValueError as base_error:
            if self._current_status:
                hint = "This is despite the fact this genset module is currently running."
            else:
                hint = "This may be because this genset module is not currently running."
            raise ValueError(f"{base_error}\n {hint}") from base_error

    # --------------------------------------------------------------- state
    def serializable_state_attributes(self):
        return ["_current_step"] + [f"_{key}" for key in self.state_dict().keys()]

    def _state_dict(self):
        return {
            "current_status": self._current_status,
            "goal_status": self._goal_status,
            "steps_until_up": self._steps_until_up,
            "steps_until_down": self._steps_until_down,
        }

    # --------------------------------------------------------- construction
    def _initial_up_down_times(self):
        if self._goal_status != self._current_status:
            raise RuntimeError(
                "Attempting to reset up and down times with status change in progress."
            )
        if self._current_status:
            return 0, self.wind_down_time
        return self.start_up_time, 0

    def __init__(
        self,
        running_min_production,
        running_max_production,
        genset_cost,
        co2_per_unit=0.0,
        cost_per_unit_co2=0.0,
        start_up_time=0,
        wind_down_time=0,
        allow_abortion=True,
        init_start_up=True,
        initial_step=0,
        raise_errors=False,
        provided_energy_name="genset_production",
    ):
        if running_min_production > running_max_production:
            raise ValueError(
                "parameter min_production must not be greater than parameter max_production."
            )
        if not allow_abortion:
            warn(
                "Gensets that do not allow abortions are not fully tested, "
                "setting allow_abortion=False may lead to unexpected behavior."
            )

        self.running_min_production = running_min_production
        self.running_max_production = running_max_production
        self.genset_cost = genset_cost
        self.co2_per_unit = co2_per_unit
        self.cost_per_unit_co2 = cost_per_unit_co2
        self.start_up_time = start_up_time
        self.wind_down_time = wind_down_time
        self.allow_abortion = allow_abortion
        self.init_start_up = init_start_up

        self._current_status = int(init_start_up)
        self._goal_status = int(init_start_up)
        self._steps_until_up, self._steps_until_down = self._initial_up_down_times()
        self.name = ("genset", None)

        super().__init__(
            raise_errors,
            initial_step=initial_step,
            provided_energy_name=provided_energy_name,
            absorbed_energy_name=None,
        )
