"""Unbalanced-energy (balancing) module (host layer).

Behavioral mirror of ``src/pymgrid/modules/unbalanced_energy_module.py``: an
infinite flex source-and-sink, auto-appended to every microgrid, that closes
the energy balance.  It charges ``loss_load_cost`` per unit of unmet demand
(acting as a source) and ``overgeneration_cost`` per unit of excess
production (acting as a sink).
"""
import numpy as np

from pymgrid_tpu_torch.modules.base import BaseMicrogridModule
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["UnbalancedEnergyModule"]


class UnbalancedEnergyModule(BaseMicrogridModule):
    module_type = ("balancing", "flex")
    yaml_tag = "!UnbalancedEnergyModule"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    # an unbounded two-way balancer with no observable state
    is_source = property(lambda self: True)
    is_sink = property(lambda self: True)
    min_act = property(lambda self: -np.inf)
    max_act = property(lambda self: np.inf)
    max_production = property(lambda self: np.inf)
    max_consumption = property(lambda self: np.inf)
    min_obs = property(lambda self: np.array([]))
    max_obs = property(lambda self: np.array([]))
    state = property(lambda self: np.array([]))

    @property
    def production_marginal_cost(self):
        return self.loss_load_cost

    @property
    def absorption_marginal_cost(self):
        return self.overgeneration_cost

    def _state_dict(self):
        return dict()

    def get_cost(self, energy_amount, as_source, as_sink):
        if as_source and as_sink:
            raise TypeError("as_source and as_sink cannot both be True.")
        if as_source:  # unmet load
            return self.loss_load_cost * energy_amount
        if as_sink:  # overgeneration
            return self.overgeneration_cost * energy_amount
        raise TypeError("One of as_source or as_sink must be True.")

    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_source + as_sink == 1, (
            "Must act as either source or sink but not both or neither."
        )
        penalty = -1.0 * self.get_cost(external_energy_change, as_source, as_sink)
        assert penalty <= 0
        info_key = "provided_energy" if as_source else "absorbed_energy"
        return penalty, False, {info_key: external_energy_change}

    def __init__(self, raise_errors, initial_step=0, loss_load_cost=10, overgeneration_cost=2.0):
        super().__init__(
            raise_errors,
            initial_step=initial_step,
            provided_energy_name="loss_load",
            absorbed_energy_name="overgeneration",
        )
        self.loss_load_cost = loss_load_cost
        self.overgeneration_cost = overgeneration_cost
        self.name = ("unbalanced_energy", None)
