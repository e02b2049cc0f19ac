"""Legacy non-modular microgrid.

Behavioral mirror of the reference's DataFrame-record monolith
(``src/pymgrid/_deprecated/non_modular_microgrid.py:220``): the substrate the
pymgrid25 suite was generated on, consumed by the legacy MPC/SAA paths, the
sample generators, and the conversion layer.  Simulation is a per-step record
pipeline — record action, clip to constraints, dispatch PV/loss-load/
curtailment, record CO2 and cost, advance state.

Kept semantically faithful (including quirks like the ``p_genset > 1`` guard
in the genset constraint check) since the conversion tests fuzz it against
the generator.
"""
from copy import copy

import numpy as np

__all__ = ["NonModularMicrogrid", "Battery", "Genset", "Grid", "in_ipynb"]

DEFAULT_HORIZON = 24  # hours
DEFAULT_TIMESTEP = 1  # hours
ZERO = 10**-5


def in_ipynb():
    """True when running inside an IPython notebook kernel (reference
    ``non_modular_microgrid.py:31-40``); degrades to False without IPython."""
    try:
        from IPython import get_ipython

        cfg = get_ipython().config
        return cfg["IPKernelApp"]["parent_appname"] == "ipython-notebook"
    except Exception:
        return False


def _scalar(params, key):
    return params[key].values[0]


class Battery:
    """Parameter holder for notebook-style access (reference lines 57-123)."""

    _PARAM_FIELDS = (
        ("soc", "battery_soc_0"),
        ("capacity", "battery_capacity"),
        ("soc_max", "battery_soc_max"),
        ("soc_min", "battery_soc_min"),
        ("p_charge_max", "battery_power_charge"),
        ("p_discharge_max", "battery_power_discharge"),
        ("efficiency", "battery_efficiency"),
        ("cost_cycle", "battery_cost_cycle"),
    )

    def __init__(self, param_battery, capa_to_charge, capa_to_discharge):
        for attr, key in self._PARAM_FIELDS:
            setattr(self, attr, _scalar(param_battery, key))
        self.capa_to_charge = capa_to_charge
        self.capa_to_discharge = capa_to_discharge


class Genset:
    _PARAM_FIELDS = (
        ("rated_power", "genset_rated_power"),
        ("p_min", "genset_pmin"),
        ("p_max", "genset_pmax"),
        ("fuel_cost", "fuel_cost"),
        ("co2", "genset_co2"),
    )

    def __init__(self, param):
        for attr, key in self._PARAM_FIELDS:
            setattr(self, attr, _scalar(param, key))


class Grid:
    def __init__(self, param, status, price_import, price_export, co2):
        self.power_export = _scalar(param, "grid_power_export")
        self.power_import = _scalar(param, "grid_power_import")
        self.price_export = price_export
        self.price_import = price_import
        self.status = status
        self.co2 = co2


class NonModularMicrogrid:
    # attribute name on self -> key in the legacy parameter record
    _RECORD_BINDINGS = (
        ("parameters", "parameters"),
        ("architecture", "architecture"),
        ("_load_ts", "load"),
        ("_pv_ts", "pv"),
        ("_df_record_control_dict", "df_actions"),
        ("_df_record_state", "df_status"),
        ("_df_record_actual_production", "df_actual_generation"),
        ("_df_record_cost", "df_cost"),
        ("_df_record_co2", "df_co2"),
        ("control_dict", "control_dict"),
    )
    _GRID_BINDINGS = (
        ("_grid_status_ts", "grid_ts"),
        ("_grid_price_import", "grid_price_import"),
        ("_grid_price_export", "grid_price_export"),
        ("_grid_co2", "grid_co2"),
    )

    def __init__(self, parameters, horizon=DEFAULT_HORIZON, timestep=DEFAULT_TIMESTEP):
        for attr, record_key in self._RECORD_BINDINGS:
            setattr(self, attr, parameters[record_key])

        self.pv = self._pv_ts.iloc[0, 0]
        self.load = self._load_ts.iloc[0, 0]
        self._next_load = self._load_ts.iloc[1, 0]
        self._next_pv = self._pv_ts.iloc[1, 0]
        if self._has("grid"):
            for attr, record_key in self._GRID_BINDINGS:
                setattr(self, attr, parameters[record_key])
            self._next_grid_status = self._grid_status_ts.iloc[0, 0]
            self._next_grid_price_export = self._grid_price_export.iloc[0, 0]
            self._next_grid_price_import = self._grid_price_import.iloc[0, 0]
            self._next_grid_co2 = self._grid_co2.iloc[0, 0]

        self.__dict__.update(
            _df_cost_per_epochs=[],
            horizon=horizon,
            _tracking_timestep=0,
            _data_length=min(self._load_ts.shape[0], self._pv_ts.shape[0]),
            done=False,
            _has_run_rule_based_baseline=False,
            _has_run_mpc_baseline=False,
            _has_train_test_split=False,
            _epoch=0,
            _zero=ZERO,
            _data_set_to_use_default="all",
            _data_set_to_use="all",
        )

        self._build_component_views()

    def _has(self, component):
        return self.architecture[component] == 1

    def _build_component_views(self):
        if self._has("battery"):
            self.battery = Battery(
                self.parameters,
                self._df_record_state["capa_to_charge"][0],
                self._df_record_state["capa_to_discharge"][0],
            )
        if self._has("genset"):
            self.genset = Genset(self.parameters)
        if self._has("grid"):
            self.grid = Grid(
                self.parameters,
                self._grid_status_ts.iloc[0, 0],
                self._grid_price_import.iloc[0, 0],
                self._grid_price_export.iloc[0, 0],
                self._grid_co2.iloc[0, 0],
            )

    # --------------------------------------------------------------- getters
    def set_horizon(self, horizon):
        self.horizon = horizon

    def set_cost_co2(self, co2_cost):
        self.parameters["cost_co2"] = co2_cost

    def get_data(self):
        return self._load_ts, self._pv_ts

    def get_training_testing_data(self):
        if not self._has_train_test_split:
            print("You have not split the dataset into training and testing sets")
            return None
        return (
            self._limit_index,
            self._load_train,
            self._pv_train,
            self._load_test,
            self._pv_test,
        )

    def get_control_dict(self):
        return self.control_dict

    def get_parameters(self):
        return self.parameters

    def get_cost(self):
        return self._df_record_cost["total_cost"][-1]

    def get_co2(self):
        return self._df_record_co2["co2"][-1]

    def get_updated_values(self):
        return {i: self._df_record_state[i][-1] for i in self._df_record_state}

    # ------------------------------------------------------------- forecasts
    def _active(self, all_ts, train_ts_name, test_ts_name):
        if self._data_set_to_use == "training":
            return getattr(self, train_ts_name)
        if self._data_set_to_use == "testing":
            return getattr(self, test_ts_name)
        return all_ts

    def _window(self, ts):
        t = self._tracking_timestep
        return ts.iloc[t : t + self.horizon].values.flatten()

    def forecast_all(self):
        forecast = {"pv": self.forecast_pv(), "load": self.forecast_load()}
        if self._has("grid"):
            forecast["grid_status"] = self.forecast_grid_status()
            forecast["grid_import"], forecast["grid_export"] = self.forecast_grid_prices()
            forecast["grid_co2"] = self.forecast_grid_co2()
        return forecast

    def forecast_pv(self):
        return self._window(self._active(self._pv_ts, "_pv_train", "_pv_test"))

    def forecast_load(self):
        return self._window(self._active(self._load_ts, "_load_train", "_load_test"))

    def forecast_grid_status(self):
        return self._window(
            self._active(self._grid_status_ts, "_grid_status_train", "_grid_status_test")
        )

    def forecast_grid_co2(self):
        return self._window(
            self._active(self._grid_co2, "_grid_co2_train", "_grid_co2_test")
        )

    def forecast_grid_prices(self):
        buy = self._window(
            self._active(
                self._grid_price_import, "_grid_price_import_train", "_grid_price_import_test"
            )
        )
        sell = self._window(
            self._active(
                self._grid_price_export, "_grid_price_export_train", "_grid_price_export_test"
            )
        )
        return buy, sell

    # ------------------------------------------------------------------- run
    def run(self, control_dict):
        """Advance one step: record the (clipped) control, dispatch PV /
        loss-load / curtailment, record CO2 and costs, update state."""
        control_dict["load"] = self.load
        control_dict["pv"] = self.pv

        self._df_record_control_dict = self._record_action(
            control_dict, self._df_record_control_dict
        )
        self._df_record_actual_production = self._record_production(
            control_dict, self._df_record_actual_production, self._df_record_state
        )

        realized = {
            i: self._df_record_actual_production[i][-1]
            for i in self._df_record_actual_production
        }

        if self._has("grid"):
            self._df_record_co2 = self._record_co2(
                realized, self._df_record_co2, self.grid.co2
            )
            self._df_record_cost = self._record_cost(
                realized,
                self._df_record_cost,
                self._df_record_co2,
                self.grid.price_import,
                self.grid.price_export,
            )
            self._df_record_state = self._update_status(
                realized,
                self._df_record_state,
                self._next_load,
                self._next_pv,
                self._next_grid_status,
                self._next_grid_price_import,
                self._next_grid_price_export,
                self._next_grid_co2,
            )
        else:
            self._df_record_co2 = self._record_co2(realized, self._df_record_co2)
            self._df_record_cost = self._record_cost(
                realized, self._df_record_cost, self._df_record_co2
            )
            self._df_record_state = self._update_status(
                control_dict, self._df_record_state, self._next_load, self._next_pv
            )

        at_horizon_end = self._tracking_timestep == self._data_length - self.horizon
        at_data_end = self._tracking_timestep == self._data_length - 1
        if at_horizon_end or at_data_end:
            self.done = True
            return self.get_updated_values()

        self._tracking_timestep += 1
        self.update_variables()
        return self.get_updated_values()

    def train_test_split(self, train_size=0.67, shuffle=False, cancel=False):
        if not self._has_train_test_split:
            split = int(np.ceil(self._data_length * train_size))
            self._limit_index = split
            self._load_train = self._load_ts.iloc[:split]
            self._pv_train = self._pv_ts.iloc[:split]
            self._load_test = self._load_ts.iloc[split:]
            self._pv_test = self._pv_ts.iloc[split:]

            if self._has("grid"):
                self._grid_status_train = self._grid_status_ts.iloc[:split]
                self._grid_status_test = self._grid_status_ts.iloc[split:]
                self._grid_price_import_train = self._grid_price_import.iloc[:split]
                self._grid_price_import_test = self._grid_price_import.iloc[split:]
                self._grid_price_export_train = self._grid_price_export.iloc[:split]
                self._grid_price_export_test = self._grid_price_export.iloc[split:]
                self._grid_co2_train = self._grid_co2.iloc[:split]
                self._grid_co2_test = self._grid_co2.iloc[split:]

            self._has_train_test_split = True
            self._data_set_to_use_default = "training"
            self._data_set_to_use = "training"
        elif cancel:
            self._has_train_test_split = False
            self._data_set_to_use_default = "all"
            self._data_set_to_use = "all"

        self.reset()

    def update_variables(self):
        t = self._tracking_timestep
        pv_ts = self._active(self._pv_ts, "_pv_train", "_pv_test")
        load_ts = self._active(self._load_ts, "_load_train", "_load_test")
        self.pv = pv_ts.iloc[t, 0]
        self.load = load_ts.iloc[t, 0]

        off_end = self._data_set_to_use == "all" and t >= self._data_length - 1
        if off_end:
            self._next_pv, self._next_load = None, None
        else:
            self._next_pv = pv_ts.iloc[t + 1, 0]
            self._next_load = load_ts.iloc[t + 1, 0]

        if self._has("grid"):
            status_ts = self._active(self._grid_status_ts, "_grid_status_train", "_grid_status_test")
            buy_ts = self._active(self._grid_price_import, "_grid_price_import_train", "_grid_price_import_test")
            sell_ts = self._active(self._grid_price_export, "_grid_price_export_train", "_grid_price_export_test")
            co2_ts = self._active(self._grid_co2, "_grid_co2_train", "_grid_co2_test")

            self.grid.status = status_ts.iloc[t, 0]
            self.grid.price_import = buy_ts.iloc[t, 0]
            self.grid.price_export = sell_ts.iloc[t, 0]
            self.grid.co2 = co2_ts.iloc[t, 0]

            if off_end:
                self._next_grid_status = None
                self._next_grid_price_import = None
                self._next_grid_price_export = None
                self._next_grid_co2 = None
            else:
                self._next_grid_status = status_ts.iloc[t + 1, 0]
                self._next_grid_price_import = buy_ts.iloc[t + 1, 0]
                self._next_grid_price_export = sell_ts.iloc[t + 1, 0]
                self._next_grid_co2 = co2_ts.iloc[t + 1, 0]

        if self._has("battery"):
            self.battery.soc = self._df_record_state["battery_soc"][-1]
            self.battery.capa_to_discharge = self._df_record_state["capa_to_discharge"][-1]
            self.battery.capa_to_charge = self._df_record_state["capa_to_charge"][-1]

    def reset(self, testing=False):
        if self._data_set_to_use == "training":
            epoch_cost = copy(self._df_record_cost)
            epoch_cost["epoch"] = self._epoch
            self._df_cost_per_epochs.append(epoch_cost)

        self._df_record_state = {
            field: [entries[0]] for field, entries in self._df_record_state.items()
        }
        for frame_attr in (
            "_df_record_control_dict",
            "_df_record_actual_production",
            "_df_record_cost",
            "_df_record_co2",
        ):
            setattr(self, frame_attr, {field: [] for field in getattr(self, frame_attr)})

        self._tracking_timestep = 0

        if testing and self._data_set_to_use_default == "training":
            self._data_set_to_use = "testing"
            self._data_length = min(self._load_test.shape[0], self._pv_test.shape[0])
        elif self._data_set_to_use_default == "training":
            self._data_set_to_use = "training"
            self._data_length = min(self._load_train.shape[0], self._pv_train.shape[0])
        else:
            self._data_set_to_use = self._data_set_to_use_default
            self._data_length = min(self._load_ts.shape[0], self._pv_ts.shape[0])

        self.update_variables()
        self.done = False
        self._epoch += 1

    # ------------------------------------------------------------- recording
    def _record_action(self, control_dict, df):
        if not isinstance(df, dict):
            raise TypeError(f"df needs to be dict, is {type(df)}")
        for field in df:
            entry = control_dict[field] if field in control_dict.keys() else {field: 0}
            df[field].append(entry)
        return df

    def _update_status(
        self, production_dict, df, next_load, next_pv, next_grid=0,
        next_price_import=0, next_price_export=0, next_co2=0,
    ):
        if not isinstance(df, dict):
            raise TypeError(f"df needs to be dict, is {type(df)}")

        incoming = {
            "load": next_load,
            "pv": next_pv,
            "hour": self._tracking_timestep % 24,
        }
        if self._has("battery"):
            eff = _scalar(self.parameters, "battery_efficiency")
            cap = _scalar(self.parameters, "battery_capacity")
            new_soc = df["battery_soc"][-1] + (
                production_dict["battery_charge"] * eff
                - production_dict["battery_discharge"] / eff
            ) / cap
            incoming["battery_soc"] = new_soc
            incoming["capa_to_discharge"] = max(
                (new_soc * cap - _scalar(self.parameters, "battery_soc_min") * cap) * eff, 0
            )
            incoming["capa_to_charge"] = max(
                (_scalar(self.parameters, "battery_soc_max") * cap - new_soc * cap) * eff, 0
            )

        if self._has("grid"):
            incoming["grid_status"] = next_grid
            incoming["grid_price_import"] = next_price_import
            incoming["grid_price_export"] = next_price_export
            incoming["grid_co2"] = next_co2

        for field in df:
            df[field].append(incoming[field])
        return df

    def _check_constraints_genset(self, p_genset):
        if p_genset < 0:
            p_genset = 0
            print("error, genset power cannot be lower than 0")
        rated = _scalar(self.parameters, "genset_rated_power")
        floor = rated * _scalar(self.parameters, "genset_pmin")
        ceiling = rated * _scalar(self.parameters, "genset_pmax")
        # the reference only lifts to p_min above 1 (quirk kept for parity)
        if p_genset < floor and p_genset > 1:
            p_genset = floor
        if p_genset > ceiling:
            p_genset = ceiling
        return p_genset

    def _check_constraints_grid(self, p_import, p_export):
        if p_import < 0:
            p_import = 0
        if p_export < 0:
            p_export = 0
        import_limit = _scalar(self.parameters, "grid_power_import")
        export_limit = _scalar(self.parameters, "grid_power_export")
        if p_import > import_limit:
            p_import = import_limit
        if p_export > export_limit:
            p_export = export_limit
        return p_import, p_export

    def _check_constraints_battery(self, p_charge, p_discharge, status):
        if p_charge < 0:
            p_charge = 0
        if p_discharge < 0:
            p_discharge = 0

        cap = _scalar(self.parameters, "battery_capacity")
        eff = _scalar(self.parameters, "battery_efficiency")
        soc = status["battery_soc"][-1]
        capa_to_charge = max(
            (_scalar(self.parameters, "battery_soc_max") * cap - soc * cap) * eff, 0
        )
        capa_to_discharge = max(
            (soc * cap - _scalar(self.parameters, "battery_soc_min") * cap) * eff, 0
        )

        charge_limit = _scalar(self.parameters, "battery_power_charge")
        discharge_limit = _scalar(self.parameters, "battery_power_discharge")
        if p_charge > capa_to_charge or p_charge > charge_limit:
            p_charge = min(capa_to_charge, charge_limit)
        if p_discharge > capa_to_discharge or p_discharge > discharge_limit:
            p_discharge = min(capa_to_discharge, discharge_limit)
        return p_charge, p_discharge

    def _record_production(self, control_dict, production_dict, status):
        assert isinstance(production_dict, dict)
        control_dict.pop("pv_consummed", None)

        sources = 0.0
        sinks = control_dict["load"]

        if self._has("battery"):
            p_charge, p_discharge = self._check_constraints_battery(
                control_dict["battery_charge"], control_dict["battery_discharge"], status
            )
            production_dict["battery_charge"].append(p_charge)
            production_dict["battery_discharge"].append(p_discharge)
            sources += p_discharge
            sinks += p_charge

        if self._has("grid"):
            p_import, p_export = self._check_constraints_grid(
                control_dict["grid_import"], control_dict["grid_export"]
            )
            production_dict["grid_import"].append(p_import)
            production_dict["grid_export"].append(p_export)
            sources += p_import
            sinks += p_export

        if self._has("genset"):
            p_genset = self._check_constraints_genset(control_dict["genset"])
            production_dict["genset"].append(p_genset)
            sources += p_genset

        pv_required = sinks - sources
        pv_available = control_dict["pv"]

        if np.abs(pv_required - pv_available) < 1e-3:  # meeting demand
            pv_consumed, loss_load, pv_curtailed, overgeneration = pv_available, 0, 0, 0
        elif pv_required > pv_available:  # loss load
            pv_consumed = pv_available
            loss_load = pv_required - pv_available
            pv_curtailed = overgeneration = 0
        elif 0 < pv_required < pv_available:  # curtail pv
            pv_consumed = pv_required
            loss_load = 0
            pv_curtailed = pv_available - pv_required
            overgeneration = 0
        else:  # overgeneration; requires no pv at all
            assert pv_required < 0
            pv_consumed = 0
            loss_load = 0
            pv_curtailed = pv_available if pv_available > 0 else 0
            overgeneration = -pv_required

        production_dict["pv_consummed"].append(pv_consumed)
        production_dict["loss_load"].append(loss_load)
        production_dict["pv_curtailed"].append(pv_curtailed)
        production_dict["overgeneration"].append(overgeneration)
        return production_dict

    def _record_co2(self, control_dict, df, grid_co2=0):
        co2 = 0
        if self._has("genset"):
            co2 += control_dict["genset"] * _scalar(self.parameters, "genset_co2")
        if self._has("grid"):
            co2 += grid_co2 * control_dict["grid_import"]
        df["co2"].append(co2)
        return df

    def _record_cost(self, control_dict, df, df_co2, cost_import=0, cost_export=0):
        if not isinstance(df, dict):
            raise TypeError(f"df needs to be dict, is {type(df)}")

        df["loss_load"].append(
            control_dict["loss_load"] * _scalar(self.parameters, "cost_loss_load")
        )
        df["overgeneration"].append(
            control_dict["overgeneration"]
            * _scalar(self.parameters, "cost_overgeneration")
        )
        if self._has("genset"):
            df["genset"].append(
                control_dict["genset"] * _scalar(self.parameters, "fuel_cost")
            )
        if self._has("grid"):
            df["grid_import"].append(cost_import * control_dict["grid_import"])
            df["grid_export"].append(-cost_export * control_dict["grid_export"])
        if self._has("battery"):
            df["battery"].append(
                (control_dict["battery_charge"] + control_dict["battery_discharge"])
                * _scalar(self.parameters, "battery_cost_cycle")
            )
        df["co2"].append(_scalar(self.parameters, "cost_co2") * df_co2["co2"][-1])

        total_cost = np.sum([val[-1] for key, val in df.items() if key != "total_cost"])
        df["total_cost"].append(total_cost)
        return df

    def penalty(self, coef=1):
        total = 0
        for field in self._df_record_control_dict:
            total += abs(
                self._df_record_control_dict[field][-1]
                - self._df_record_actual_production[field][-1]
            )
        return total * coef

    @classmethod
    def from_modular(cls, modular):
        from pymgrid_tpu_torch.convert import to_nonmodular

        return to_nonmodular(modular)

    def to_modular(self):
        from pymgrid_tpu_torch.convert import to_modular

        return to_modular(self)
