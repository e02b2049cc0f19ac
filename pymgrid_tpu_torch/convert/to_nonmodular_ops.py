"""Module -> legacy parameter record builders
(behavioral mirror of reference ``convert/to_nonmodular_ops.py``).

Each ``add_*_params`` registers one module's contribution to the legacy
``NonModularMicrogrid`` parameter record.  The *order* of registrations
within each function is load-bearing: it fixes legacy record-frame column
order, which the conversion parity tests compare.
"""
from copy import deepcopy
from warnings import warn

import numpy as np
import pandas as pd

from pymgrid_tpu_torch.modules import (
    BatteryModule,
    GensetModule,
    GridModule,
    LoadModule,
    RenewableModule,
    UnbalancedEnergyModule,
)

_PARAMS_TEMPLATE = dict(
    parameters=dict(),
    df_actions=dict(),
    architecture=dict(PV=0, battery=0, genset=0, grid=0),
    df_status=dict(hour=[0]),
    df_actual_generation=dict(loss_load=[], overgeneration=[]),
    df_cost=dict(loss_load=[], overgeneration=[], total_cost=[]),
    df_co2=dict(co2=[]),
    pv=None,
    load=None,
    grid_ts=None,
    control_dict=[],
    grid_price_import=None,
    grid_price_export=None,
    grid_co2=None,
)


def get_empty_params():
    return deepcopy(_PARAMS_TEMPLATE)


def check_viability(modular):
    known = (
        LoadModule, RenewableModule, BatteryModule, GridModule, GensetModule,
        UnbalancedEnergyModule,
    )
    census = {cls: 0 for cls in known}

    for name, module_list in modular.modules.iterdict():
        if len(module_list) > 1:
            raise ValueError(
                "Cannot convert modular microgrid with multiple modules of same "
                f"type. The following module name has multiple modules: {name}"
            )
        module = module_list[0]
        if not isinstance(module, known):
            listing = "\n".join(str(x) for x in known)
            raise TypeError(
                f"Unable to parse module {name} of type {module.__class__.__name__}."
                f"Must be one of:\n{listing}"
            )
        census[module.__class__] += 1

    conflicts = [(cls, n) for cls, n in census.items() if n > 1]
    if conflicts:
        raise ValueError(
            "Cannot convert modular microgrid with multiple modules of same type. "
            f"The following module types conflict: {conflicts}"
        )
    if census[LoadModule] != 1:
        raise ValueError("Cannot convert modular microgrid that has no LoadModule.")


def finalize_params(params_dict):
    params_dict["parameters"] = pd.DataFrame(params_dict["parameters"])


# ------------------------------------------------------------------ helpers
def _new_list_columns(params_dict, frame_name, *keys):
    params_dict[frame_name].update({k: [] for k in keys})


def _set_parameters(params_dict, **parameters):
    params_dict["parameters"].update(
        {k: v if isinstance(v, list) else [v] for k, v in parameters.items()}
    )


def _set_initial_status(params_dict, **init_status_values):
    params_dict["df_status"].update(
        {k: v if isinstance(v, list) else [v] for k, v in init_status_values.items()}
    )


def _mark_architecture(params_dict, component):
    if component not in params_dict["architecture"]:
        raise NameError(f"Component {component} not viable member of architecture")
    params_dict["architecture"][component] = 1


def _extend_control_dict(params_dict, *keys):
    params_dict["control_dict"].extend(list(keys))


def _merge_cost_co2(params_dict, cost_co2):
    existing = params_dict["parameters"].get("cost_co2")
    if existing is None:
        params_dict["parameters"]["cost_co2"] = cost_co2
    elif cost_co2 != existing:
        warn(
            f"cost_co2 value {cost_co2} being added is different from existing "
            f"cost_co2 value {existing}. Using mean."
        )
        params_dict["parameters"]["cost_co2"] = np.mean([cost_co2, existing])
    _new_list_columns(params_dict, "df_cost", "co2")


def _random_genset_polynom(params_dict):
    np.random.seed(0)
    warn("Getting genset_polynom parameters randomly")
    polynom = [np.random.rand() * 10, np.random.rand(), np.random.rand() / 10]
    entries = dict(genset_polynom_order=len(polynom))
    for i, coefficient in enumerate(polynom):
        entries[f"genset_polynom_{i}"] = coefficient
    _set_parameters(params_dict, **entries)


# --------------------------------------------------------- per-module adders
def add_load_params(load_module, params_dict):
    params_dict["load"] = pd.DataFrame(np.abs(load_module.time_series))
    _set_parameters(params_dict, load=-1 * load_module.min_act)
    _extend_control_dict(params_dict, "load")
    _new_list_columns(params_dict, "df_actual_generation", "loss_load")
    _new_list_columns(params_dict, "df_actions", "load")
    _set_initial_status(params_dict, load=round(load_module.current_load, 1))


def add_pv_params(pv_module, params_dict):
    params_dict["pv"] = pd.DataFrame(pv_module.time_series)
    _mark_architecture(params_dict, "PV")
    _set_parameters(params_dict, PV_rated_power=pv_module.max_act)
    _new_list_columns(params_dict, "df_actions", "pv_consummed", "pv_curtailed", "pv")
    _set_initial_status(params_dict, pv=[pv_module.current_renewable])
    _new_list_columns(params_dict, "df_actual_generation", "pv_consummed", "pv_curtailed")
    _extend_control_dict(params_dict, "pv_consummed", "pv_curtailed", "pv")


def add_battery_params(battery_module, params_dict):
    _mark_architecture(params_dict, "battery")
    _set_parameters(
        params_dict,
        battery_soc_0=battery_module.soc,
        battery_power_charge=battery_module.max_charge,
        battery_power_discharge=battery_module.max_discharge,
        battery_capacity=battery_module.max_capacity,
        battery_efficiency=battery_module.efficiency,
        battery_soc_min=battery_module.min_soc,
        battery_soc_max=battery_module.max_soc,
        battery_cost_cycle=battery_module.battery_cost_cycle,
    )
    _new_list_columns(params_dict, "df_actions", "battery_charge", "battery_discharge")
    headroom = (battery_module.max_soc - battery_module.soc)
    stored = (battery_module.soc - battery_module.min_soc)
    _set_initial_status(
        params_dict,
        battery_soc=battery_module.soc,
        capa_to_charge=round(
            headroom * battery_module.max_capacity / battery_module.efficiency, 1
        ),
        capa_to_discharge=round(
            stored * battery_module.max_capacity / battery_module.efficiency, 1
        ),
    )
    _new_list_columns(
        params_dict, "df_actual_generation", "battery_charge", "battery_discharge"
    )
    _new_list_columns(params_dict, "df_cost", "battery")
    _extend_control_dict(params_dict, "battery_charge", "battery_discharge")


def add_grid_params(grid_module, params_dict):
    columns = ["grid_price_import", "grid_price_export", "grid_co2", "grid_status"]
    grid_frame = pd.DataFrame(grid_module.time_series, columns=columns)
    params_dict["grid_price_import"] = grid_frame["grid_price_import"].to_frame()
    params_dict["grid_price_export"] = grid_frame["grid_price_export"].to_frame()
    params_dict["grid_co2"] = grid_frame["grid_co2"].to_frame()
    params_dict["grid_ts"] = grid_frame["grid_status"].to_frame()
    _mark_architecture(params_dict, "grid")
    _set_parameters(
        params_dict,
        grid_weak=(grid_frame["grid_status"].min() < 1).item(),
        grid_power_import=grid_module.max_import,
        grid_power_export=grid_module.max_export,
    )
    _new_list_columns(params_dict, "df_actions", "grid_import", "grid_export")
    _set_initial_status(
        params_dict,
        grid_status=grid_frame["grid_status"].iloc[0],
        grid_co2=grid_frame["grid_co2"].iloc[0],
        grid_price_import=grid_frame["grid_price_import"].iloc[0],
        grid_price_export=grid_frame["grid_price_export"].iloc[0],
    )
    _new_list_columns(params_dict, "df_actual_generation", "grid_import", "grid_export")
    _new_list_columns(params_dict, "df_cost", "grid_import", "grid_export")
    _extend_control_dict(params_dict, "grid_import", "grid_export")
    _merge_cost_co2(params_dict, grid_module.cost_per_unit_co2)


def add_genset_params(genset_module, params_dict):
    warn(
        "GensetModules does not contain separate rated_power and p_max information."
        "Assuming p_max=0.9."
    )
    p_max = 0.9
    rated_power = genset_module.running_max_production / p_max
    _mark_architecture(params_dict, "genset")
    _random_genset_polynom(params_dict)

    if rated_power == 0:
        raise RuntimeError

    _set_parameters(
        params_dict,
        genset_rated_power=rated_power,
        genset_pmin=genset_module.running_min_production / rated_power,
        genset_pmax=p_max,
        fuel_cost=genset_module.genset_cost,
        genset_co2=genset_module.co2_per_unit,
    )
    _new_list_columns(params_dict, "df_actions", "genset")
    _new_list_columns(params_dict, "df_actual_generation", "genset")
    _new_list_columns(params_dict, "df_cost", "genset")
    _extend_control_dict(params_dict, "genset")
    _merge_cost_co2(params_dict, genset_module.cost_per_unit_co2)


def add_unbalanced_energy_params(unbalanced_energy_module, params_dict):
    _set_parameters(
        params_dict,
        cost_overgeneration=unbalanced_energy_module.overgeneration_cost,
        cost_loss_load=unbalanced_energy_module.loss_load_cost,
    )
    _new_list_columns(params_dict, "df_actual_generation", "overgeneration")
    _new_list_columns(params_dict, "df_cost", "overgeneration")


_ADDERS = {
    LoadModule: add_load_params,
    RenewableModule: add_pv_params,
    BatteryModule: add_battery_params,
    GridModule: add_grid_params,
    GensetModule: add_genset_params,
    UnbalancedEnergyModule: add_unbalanced_energy_params,
}


def add_params_from_module(module, params_dict):
    for cls, adder in _ADDERS.items():
        if isinstance(module, cls):
            adder(module, params_dict)
            return
    raise ValueError(f"Cannot parse module {module}.")
