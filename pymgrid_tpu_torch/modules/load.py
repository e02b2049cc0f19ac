"""Load module (host layer).

Behavioral mirror of ``src/pymgrid/modules/load_module.py``: a fixed sink
with an empty action space.  The time series is stored negative;
``current_load`` is the positive demand.  The reward here is always zero —
the cost of *unmet* load is charged by the balancing module instead.
"""
import numpy as np

from pymgrid_tpu_torch.modules.base import BaseTimeSeriesMicrogridModule, DEFAULT_HORIZON
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["LoadModule"]


class LoadModule(BaseTimeSeriesMicrogridModule):
    module_type = ("load", "fixed")
    yaml_tag = "!LoadModule"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    state_components = np.array(["load"], dtype=object)

    is_sink = property(lambda self: True)

    @property
    def current_load(self):
        return -1 * self._time_series[self._current_step].item()

    @property
    def max_consumption(self):
        return self.current_load

    def sample_action(self, strict_bound=False):
        return np.array([])

    def _get_bounds(self):
        # fixed modules take no actions: empty action bounds
        obs_lo, obs_hi, _, _ = super()._get_bounds()
        return obs_lo, obs_hi, np.array([]), np.array([])

    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_sink, f"Class {self.__class__.__name__} is a sink."
        return 0.0, self._done(), {"absorbed_energy": self.current_load}

    def __init__(
        self,
        time_series,
        forecaster=None,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
        initial_step=0,
        final_step=-1,
        raise_errors=False,
    ):
        super().__init__(
            time_series,
            raise_errors=raise_errors,
            forecaster=forecaster,
            forecast_horizon=forecast_horizon,
            forecaster_increase_uncertainty=forecaster_increase_uncertainty,
            forecaster_relative_noise=forecaster_relative_noise,
            initial_step=initial_step,
            final_step=final_step,
            provided_energy_name=None,
            absorbed_energy_name="load_met",
        )
        self.name = ("load", None)
