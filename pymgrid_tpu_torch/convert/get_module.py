"""Legacy component -> module constructors
(behavioral mirror of reference ``convert/get_module.py``)."""
import pandas as pd

from pymgrid_tpu_torch.modules import (
    BatteryModule,
    GensetModule,
    GridModule,
    LoadModule,
    RenewableModule,
    UnbalancedEnergyModule,
)

__all__ = ["get_module"]


def get_grid_module(nonmodular, raise_errors):
    legacy_columns = (
        ("_grid_price_import", "cost_import"),
        ("_grid_price_export", "cost_export"),
        ("_grid_co2", "co2_per_unit_production"),
        ("_grid_status_ts", "grid_status"),
    )
    series = []
    for attr, name in legacy_columns:
        column = getattr(nonmodular, attr).squeeze()
        column.name = name
        series.append(column)

    return GridModule(
        max_import=nonmodular.grid.power_import,
        max_export=nonmodular.grid.power_export,
        time_series=pd.concat(series, axis=1),
        forecaster="oracle",
        forecast_horizon=nonmodular.horizon - 1,
        cost_per_unit_co2=nonmodular.parameters.cost_co2.item(),
        raise_errors=raise_errors,
    )


def get_genset_module(nonmodular, raise_errors):
    genset = nonmodular.genset
    return GensetModule(
        running_min_production=genset.p_min * genset.rated_power,
        running_max_production=genset.p_max * genset.rated_power,
        genset_cost=genset.fuel_cost,
        co2_per_unit=nonmodular.parameters.genset_co2.item(),
        cost_per_unit_co2=nonmodular.parameters.cost_co2.item(),
        start_up_time=0,
        wind_down_time=0,
        raise_errors=raise_errors,
    )


def get_battery_module(nonmodular, raise_errors):
    battery = nonmodular.battery
    return BatteryModule(
        min_capacity=battery.capacity * battery.soc_min,
        max_capacity=battery.capacity,
        max_charge=battery.p_charge_max,
        max_discharge=battery.p_discharge_max,
        efficiency=battery.efficiency,
        battery_cost_cycle=battery.cost_cycle,
        init_soc=battery.soc,
        raise_errors=raise_errors,
    )


def get_pv_module(nonmodular, raise_errors):
    return RenewableModule(
        time_series=nonmodular._pv_ts,
        raise_errors=raise_errors,
        forecaster="oracle",
        forecast_horizon=nonmodular.horizon - 1,
    )


def get_load_module(nonmodular, raise_errors):
    return LoadModule(
        time_series=nonmodular._load_ts,
        forecaster="oracle",
        forecast_horizon=nonmodular.horizon - 1,
        raise_errors=raise_errors,
    )


def get_unbalanced_energy_module(nonmodular, raise_errors):
    return UnbalancedEnergyModule(
        raise_errors=raise_errors,
        loss_load_cost=nonmodular.parameters["cost_loss_load"].item(),
        overgeneration_cost=nonmodular.parameters["cost_overgeneration"].item(),
    )


_BUILDERS = {
    "load": get_load_module,
    "PV": get_pv_module,
    "battery": get_battery_module,
    "genset": get_genset_module,
    "grid": get_grid_module,
    "unbalanced_energy": get_unbalanced_energy_module,
}


def get_module(component, nonmodular, raise_errors):
    builder = _BUILDERS.get(component)
    if builder is None:
        raise ValueError(f"Cannot parse component {component}.")
    return builder(nonmodular, raise_errors)
