"""Battery module (host layer).

Behavioral mirror of ``src/pymgrid/modules/battery_module.py``: a
controllable source-and-sink with an efficiency-scaled SOC transition.
External discharge drains ``E/efficiency`` internally; external charge
retains ``E*efficiency``.  Cycling costs ``|internal dE| * battery_cost_cycle``.
The default transition lives in :mod:`pymgrid_tpu_torch.core.physics` so the host
layer and the compiled engine share one definition.
"""
from warnings import warn

import numpy as np

from pymgrid_tpu_torch.core import physics
from pymgrid_tpu_torch.modules.base import BaseMicrogridModule
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["BatteryModule"]


class BatteryModule(BaseMicrogridModule):
    module_type = ("battery", "controllable")
    yaml_tag = "!BatteryModule"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    # ----------------------------------------------------- identity & bounds
    is_source = property(lambda self: True)
    is_sink = property(lambda self: True)

    @property
    def min_act(self):
        return -self.max_discharge / self.efficiency

    @property
    def max_act(self):
        return self.max_charge * self.efficiency

    @property
    def min_obs(self):
        return np.array([self.min_soc, self.min_capacity])

    @property
    def max_obs(self):
        return np.array([self.max_soc, self.max_capacity])

    @property
    def production_marginal_cost(self):
        return self.battery_cost_cycle

    @property
    def absorption_marginal_cost(self):
        return self.battery_cost_cycle

    @property
    def max_production(self):
        return float(
            physics.battery_max_production(
                self._current_charge, self.min_capacity, self.max_discharge, self.efficiency
            )
        )

    @property
    def max_consumption(self):
        return float(
            physics.battery_max_consumption(
                self._current_charge, self.max_capacity, self.max_charge, self.efficiency
            )
        )

    # --------------------------------------------------------- construction
    def __init__(
        self,
        min_capacity,
        max_capacity,
        max_charge,
        max_discharge,
        efficiency,
        battery_cost_cycle=0.0,
        battery_transition_model=None,
        init_charge=None,
        init_soc=None,
        initial_step=0,
        raise_errors=False,
    ):
        assert 0 < efficiency <= 1
        self.min_capacity = min_capacity
        self.max_capacity = max_capacity
        self.max_charge = max_charge
        self.max_discharge = max_discharge
        self.efficiency = efficiency
        self.battery_transition_model = battery_transition_model
        self.battery_cost_cycle = battery_cost_cycle

        self.min_soc = min_capacity / max_capacity
        self.max_soc = 1
        self.init_charge = init_charge
        self.init_soc = init_soc
        self._current_charge, self._soc = self._resolve_initial_state(init_charge, init_soc)
        self.name = ("battery", None)
        super().__init__(
            raise_errors,
            initial_step=initial_step,
            provided_energy_name="discharge_amount",
            absorbed_energy_name="charge_amount",
        )

    def _resolve_initial_state(self, init_charge, init_soc):
        """Derive (charge, soc) from whichever of the two was given."""
        if init_charge is None and init_soc is None:
            raise ValueError("Must set one of init_charge and init_soc.")
        if init_charge is not None:
            if init_soc is not None:
                warn(
                    "Passed both init_capacity and init_soc. "
                    "Using init_charge and ignoring init_soc"
                )
            return init_charge, init_charge / self.max_capacity
        return init_soc * self.max_capacity, init_soc

    # ---------------------------------------------------------------- state
    @property
    def current_charge(self):
        return self._current_charge

    @current_charge.setter
    def current_charge(self, value):
        self._current_charge, self._soc = self._resolve_initial_state(value, None)

    @property
    def soc(self):
        return self._soc

    @soc.setter
    def soc(self, value):
        self._current_charge, self._soc = self._resolve_initial_state(None, value)

    def _state_dict(self):
        return {"soc": self._soc, "current_charge": self._current_charge}

    # ----------------------------------------------------- transition model
    def transition_kwargs(self):
        return dict(
            min_capacity=self.min_capacity,
            max_capacity=self.max_capacity,
            max_charge=self.max_charge,
            max_discharge=self.max_discharge,
            efficiency=self.efficiency,
            battery_cost_cycle=self.battery_cost_cycle,
            max_production=self.max_production,
            max_consumption=self.max_consumption,
            state_dict=self.state_dict(),
        )

    def model_transition(self, energy):
        if self.battery_transition_model is None:
            return float(physics.battery_model_transition(energy, self.efficiency))
        return self.battery_transition_model(
            external_energy_change=energy, **self.transition_kwargs()
        )

    def get_cost(self, energy_change):
        return np.abs(energy_change) * self.battery_cost_cycle

    def _apply_charge_delta(self, energy_change):
        self._current_charge += energy_change
        if self._current_charge < self.min_capacity:
            assert np.isclose(self._current_charge, self.min_capacity)
            self._current_charge = self.min_capacity
        self._soc = self._current_charge / self.max_capacity

    # ------------------------------------------------------------- dispatch
    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_source + as_sink == 1, (
            "Must act as either source or sink but not both or neither."
        )

        # discharging moves negative energy through the transition model
        sign = -1.0 if as_source else 1.0
        internal_delta = self.model_transition(sign * external_energy_change)
        assert sign * internal_delta >= 0

        self._apply_charge_delta(internal_delta)
        reward = -1.0 * self.get_cost(internal_delta)
        info_key = "provided_energy" if as_source else "absorbed_energy"
        return reward, False, {info_key: external_energy_change}
