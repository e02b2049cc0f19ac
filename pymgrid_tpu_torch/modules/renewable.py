"""Renewable (e.g. PV) module (host layer).

Behavioral mirror of ``src/pymgrid/modules/renewable_module.py``: a flex
source producing at most the current time-series value.  Production is free
(reward 0); the gap between availability and dispatch is logged as
``curtailment``.
"""
import numpy as np

from pymgrid_tpu_torch.modules.base import BaseTimeSeriesMicrogridModule, DEFAULT_HORIZON
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["RenewableModule"]


class RenewableModule(BaseTimeSeriesMicrogridModule):
    module_type = ("renewable", "flex")
    yaml_tag = "!RenewableModule"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    state_components = np.array(["renewable"], dtype=object)

    is_source = property(lambda self: True)

    @property
    def current_renewable(self):
        return self._time_series[self._current_step].item()

    @property
    def max_production(self):
        return self.current_renewable

    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_source, f"Class {self.__class__.__name__} can only be used as a source."
        available = self.current_renewable
        assert external_energy_change <= available, (
            f"Cannot provide more than {available}"
        )
        return (
            0.0,
            self._done(),
            {
                "provided_energy": external_energy_change,
                "curtailment": available - external_energy_change,
            },
        )

    def __init__(
        self,
        time_series,
        raise_errors=False,
        forecaster=None,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
        initial_step=0,
        final_step=-1,
        provided_energy_name="renewable_used",
    ):
        super().__init__(
            time_series,
            raise_errors,
            forecaster=forecaster,
            forecast_horizon=forecast_horizon,
            forecaster_increase_uncertainty=forecaster_increase_uncertainty,
            forecaster_relative_noise=forecaster_relative_noise,
            initial_step=initial_step,
            final_step=final_step,
            provided_energy_name=provided_energy_name,
            absorbed_energy_name=None,
        )
        self.name = ("renewable", None)
