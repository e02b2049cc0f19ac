"""Grid module (host layer).

Behavioral mirror of ``src/pymgrid/modules/grid_module.py``: a controllable
source-and-sink driven by a time series of
``(import_price, export_price, co2_per_kwh[, grid_status])``.  Three-column
series get an always-up status column appended; outages (status 0) zero both
exchange bounds.  Import reward is
``-(import_price + cost_per_unit_co2 * co2_per_kwh) * E``; export reward is
``+export_price * E`` with no CO2.
"""
import numpy as np

from pymgrid_tpu_torch.modules.base import BaseTimeSeriesMicrogridModule, DEFAULT_HORIZON
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["GridModule"]

_IMPORT_PRICE, _EXPORT_PRICE, _CO2_PER_KWH, _STATUS = range(4)


class GridModule(BaseTimeSeriesMicrogridModule):
    module_type = ("grid", "controllable")
    yaml_tag = "!GridModule"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    state_components = np.array(
        ["import_price", "export_price", "co2_per_kwh", "grid_status"], dtype=object
    )

    # ------------------------------------------------------ state slices
    is_source = property(lambda self: True)
    is_sink = property(lambda self: True)
    import_price = property(lambda self: self.state[_IMPORT_PRICE::4])
    export_price = property(lambda self: self.state[_EXPORT_PRICE::4])
    co2_per_kwh = property(lambda self: self.state[_CO2_PER_KWH::4])
    grid_status = property(lambda self: self.state[_STATUS::4])

    @property
    def current_status(self):
        return self.grid_status[0]

    @property
    def weak_grid(self):
        return self._time_series[:, -1].min() < 1

    @property
    def max_production(self):
        return self.max_import * self.current_status

    @property
    def max_consumption(self):
        return self.max_export * self.current_status

    @property
    def production_marginal_cost(self):
        return self.import_price[0]

    @property
    def absorption_marginal_cost(self):
        return self.export_price[0]

    # --------------------------------------------------- taxonomy mutation
    def as_flex(self):
        """Reclassify grid modules as flex (class-level mutation, mirroring
        ``grid_module.py:230-246``)."""
        self.__class__.module_type = (self.__class__.module_type[0], "flex")

    def as_fixed(self):
        self.__class__.module_type = (self.__class__.module_type[0], "fixed")

    # ------------------------------------------------------- costs & co2
    def get_co2_production(self, import_export, as_source, as_sink):
        if as_source:  # import
            intensity = self._time_series[self.current_step, _CO2_PER_KWH]
            return import_export * intensity
        if as_sink:
            return 0.0
        raise RuntimeError

    def get_co2_cost(self, import_export, as_source, as_sink):
        return -1.0 * self.cost_per_unit_co2 * self.get_co2_production(
            import_export, as_source, as_sink
        )

    def get_cost(self, import_export, as_source, as_sink):
        """Reward of using the grid (negative = cost); export may be revenue."""
        if as_source:  # import
            price = self._time_series[self.current_step, _IMPORT_PRICE]
            return -1 * price * import_export + self.get_co2_cost(
                import_export, as_source, as_sink
            )
        if as_sink:  # export
            price = self._time_series[self.current_step, _EXPORT_PRICE]
            return price * import_export + self.get_co2_cost(
                import_export, as_source, as_sink
            )
        raise RuntimeError

    def update(self, external_energy_change, as_source=False, as_sink=False):
        assert as_source + as_sink == 1, (
            "Must act as either source or sink but not both or neither."
        )
        info_key = "provided_energy" if as_source else "absorbed_energy"
        return (
            self.get_cost(external_energy_change, as_source, as_sink),
            self._done(),
            {
                info_key: external_energy_change,
                "co2_production": self.get_co2_production(
                    external_energy_change, as_source, as_sink
                ),
            },
        )

    # --------------------------------------------------------- construction
    @staticmethod
    def _validated_series(max_import, max_export, time_series):
        if max_import < 0:
            raise ValueError("parameter max_import must be non-negative.")
        if max_export < 0:
            raise ValueError("parameter max_export must be non-negative.")

        n_cols = time_series.shape[1]
        if n_cols == 4:
            status_col = np.asarray(time_series)[:, -1]
            if not np.isin(status_col, (0, 1)).all():
                raise ValueError("Last column (grid status) must contain binary values.")
        elif n_cols == 3:
            padded = np.ones((time_series.shape[0], 4))
            padded[:, :3] = time_series
            time_series = padded
        else:
            raise ValueError(
                "Time series must be two dimensional with three or four columns."
                "See docstring for details."
            )

        if (np.asarray(time_series) < 0).any():
            raise ValueError("Time series must be non-negative.")
        return time_series

    def _get_bounds(self):
        per_feature_min = self._time_series.min(axis=0)
        per_feature_max = self._time_series.max(axis=0)
        assert len(per_feature_min) in (3, 4)
        return per_feature_min, per_feature_max, -1 * self.max_export, self.max_import

    def __init__(
        self,
        max_import,
        max_export,
        time_series,
        forecaster=None,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
        initial_step=0,
        final_step=-1,
        cost_per_unit_co2=0.0,
        raise_errors=False,
    ):
        time_series = self._validated_series(max_import, max_export, time_series)
        self.max_import = max_import
        self.max_export = max_export
        self.cost_per_unit_co2 = cost_per_unit_co2
        self.name = ("grid", None)
        super().__init__(
            time_series,
            raise_errors,
            forecaster=forecaster,
            forecast_horizon=forecast_horizon,
            forecaster_increase_uncertainty=forecaster_increase_uncertainty,
            forecaster_relative_noise=forecaster_relative_noise,
            initial_step=initial_step,
            final_step=final_step,
            provided_energy_name="grid_import",
            absorbed_energy_name="grid_export",
        )

    def __repr__(self):
        return f"GridModule(max_import={self.max_import}, max_export={self.max_export})"
