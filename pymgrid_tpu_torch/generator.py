"""Randomized microgrid scenario generator.

Behavioral mirror of the reference ``src/pymgrid/MicrogridGenerator.py:61``:
samples an architecture (genset / grid / both at 1/3 each), picks random
load/PV/CO2 profiles from the packaged data, sizes components off the load
(NREL-style PV penetration 30-150% of peak load, battery 3-5h of mean load,
genset peak/0.9), generates TOU tariffs and weak-grid outage profiles, and
builds a :class:`~pymgrid_tpu_torch.nonmodular.NonModularMicrogrid` spec
(optionally converted to modular).

Random draws use the global numpy RNG in the same call order as the
reference, so a fixed ``random_seed`` reproduces the reference's scenario
parameters bit-for-bit (given the same data files).  The per-component
``_register_*`` helpers below therefore run in the reference's section
order and make the same RNG calls.
"""
from pathlib import Path

import numpy as np
import pandas as pd

from pymgrid_tpu_torch.nonmodular import NonModularMicrogrid
from pymgrid_tpu_torch.paths import data_dir

__all__ = ["MicrogridGenerator"]


def _pge_a6_summer_rate(hour):
    if 12 <= hour < 18:
        return 0.59
    if hour < 8 or hour >= 21:
        return 0.22
    return 0.29


def _french_commercial_rate(hour):
    if 0 <= hour < 5 or 14 <= hour < 17:
        return 0.08
    return 0.11


class MicrogridGenerator:
    def __init__(self, nb_microgrid=10, random_seed=42, timestep=1, path=None):
        np.random.seed(random_seed)
        self.microgrids = []
        self.nb_microgrids = nb_microgrid
        self.timestep = 1
        self.path = str(path) if path is not None else None

    # ------------------------------------------------------------- utilities
    def _data_path(self, kind):
        if self.path is not None:
            return Path(self.path) / "data" / kind
        return Path(data_dir()) / kind

    def _get_random_file(self, path):
        candidates = list(Path(path).glob("*.csv"))
        if not len(candidates):
            raise NameError(f"Unable to find csv data files in {path}")
        return pd.read_csv(np.random.choice(candidates))

    def _scale_ts(self, df_ts, size, scaling_method="sum"):
        ratio = 1
        if scaling_method == "sum":
            ratio = size / df_ts.sum()
        if scaling_method == "max":
            ratio = size / df_ts.max()
        return df_ts * ratio

    def _resize_timeseries(self, timeseries, current_time_step, new_time_step):
        index = pd.date_range(
            "1/1/2015 00:00:00",
            freq=str(int(current_time_step * 60)) + "min",
            periods=len(timeseries),
        )
        if hasattr(timeseries, "squeeze"):
            timeseries = timeseries.squeeze()
        if hasattr(timeseries, "values"):
            timeseries = timeseries.values
        resampled = (
            pd.Series(timeseries, index=index)
            .resample(rule=str(int(new_time_step * 60)) + "min")
            .mean()
            .interpolate(method="linear")
        )
        return resampled.values

    def _get_pv_ts(self):
        return self._get_random_file(self._data_path("pv"))

    def _get_load_ts(self):
        return self._get_random_file(self._data_path("load"))

    def _get_co2_ts(self):
        return self._get_random_file(self._data_path("co2"))

    # ------------------------------------------------------------ components
    def _get_genset(self, rated_power=1000, pmax=0.9, pmin=0.05):
        polynom = [np.random.rand() * 10, np.random.rand(), np.random.rand() / 10]
        return {
            "polynom": polynom,
            "rated_power": rated_power,
            "pmax": pmax,
            "pmin": pmin,
            "fuel_cost": 0.4,
            "co2": 2,
        }

    def _get_battery(
        self, capa=1000, duration=4, pcharge=100, pdischarge=100, soc_max=1,
        soc_min=0.2, efficiency=0.9,
    ):
        return {
            "capa": capa,
            "pcharge": int(np.ceil(capa / duration)),
            "pdischarge": int(np.ceil(capa / duration)),
            "soc_max": soc_max,
            "soc_min": soc_min,
            "efficiency": efficiency,
            "soc_0": min(max(np.random.randn(), soc_min), soc_max),
            "cost_cycle": 0.02,
        }

    def _get_electricity_tariff(self, scenario):
        """TOU tariffs: 1 = PG&E A-6 2020 summer; 2 = French commercial
        (Marseille plage 5)."""
        price_export = np.zeros((8760,))

        rate_fn = {1: _pge_a6_summer_rate, 2: _french_commercial_rate}.get(scenario)
        if rate_fn is None:
            return [], price_export
        price_import = [rate_fn(i % 24) for i in range(8760)]
        return price_import, price_export

    def _get_grid(self, rated_power=1000, weak_grid=0, pmin=0.2, price_scenario=0,
                  price_export=0, price_import=0.3):
        if weak_grid == 1:
            outages_per_day = np.random.randn() * 3 / 4 + 0.25
            outage_duration = np.random.randint(low=1, high=8)
            grid_ts = self._generate_weak_grid_profile(
                outages_per_day, outage_duration, 8760 / self.timestep
            )
        else:
            grid_ts = pd.DataFrame(
                np.ones(int(np.floor(8760 / self.timestep))), columns=["grid_status"]
            )

        grid_ts = grid_ts.iloc[:8760]
        price_import, price_export = self._get_electricity_tariff(price_scenario)

        return {
            "grid_power_import": rated_power,
            "grid_power_export": rated_power,
            "grid_ts": grid_ts,
            "grid_price_export": pd.DataFrame(price_export),
            "grid_price_import": pd.DataFrame(price_import),
        }

    def _generate_weak_grid_profile(self, outage_per_day, duration_of_outage,
                                    nb_time_step_per_year):
        draws = np.random.random(int(nb_time_step_per_year + 1))
        profile = [0 if draw < outage_per_day / 24 else 1 for draw in draws]
        # back-fill each outage so it lasts duration_of_outage steps
        timestep = 8760 / nb_time_step_per_year
        span = int(duration_of_outage / timestep)
        for i, up in enumerate(profile):
            if up == 0:
                for j in range(1, span):
                    if i - j > 0:
                        profile[i - j] = 0
        return pd.DataFrame(profile, columns=["grid_status"])

    # ---------------------------------------------------------------- sizing
    def _size_mg(self, load, size_load=1):
        penetration = np.random.randint(low=30, high=151) / 100
        return {
            "pv": load.max().values[0] * penetration,
            "load": size_load,
            "battery": self._size_battery(load),
            "genset": self._size_genset(load),
            "grid": int(max(load.values) * 2),
        }

    def _size_genset(self, load, max_operating_loading=0.9):
        return int(np.ceil(np.max(load) / max_operating_loading))

    def _size_battery(self, load):
        hours = np.random.randint(low=3, high=6)
        return int(np.ceil(hours * np.mean(load).item()))

    def _size_load(self, size_load=None):
        if size_load is None:
            return np.random.randint(low=100, high=100001)
        return size_load

    def _bin_genset_grid(self):
        draw = np.random.rand()
        if draw < 0.33:
            return 1, 0
        if draw < 0.66:
            return 0, 1
        return 1, 1

    # ------------------------------------------------------------ generation
    def generate_microgrid(self, modular=True, verbose=False):
        for _ in range(self.nb_microgrids):
            microgrid = self._create_microgrid()
            self.microgrids.append(microgrid.to_modular() if modular else microgrid)
        if verbose and not modular:
            self.print_mg_parameters()
        return self

    @classmethod
    def load(cls, scenario):
        from pymgrid_tpu_torch.microgrid import Microgrid
        from pymgrid_tpu_torch.paths import scenario_yaml_path

        instance = cls()
        instance.microgrids = [
            Microgrid.load(open(scenario_yaml_path(j))) for j in range(25)
        ]
        return instance

    # per-component spec helpers; each appends its parameter columns, record
    # columns and initial-status entries in the reference's exact order
    def _register_load(self, spec, size_load, load):
        spec["parameters"]["load"] = [size_load]
        spec["parameters"]["cost_loss_load"] = 10
        spec["parameters"]["cost_overgeneration"] = 1
        spec["parameters"]["cost_co2"] = 0.1
        spec["status"]["load"] = [np.around(load.iloc[0, 0], 1)]
        spec["status"]["hour"] = [0]
        spec["production_cols"].extend(["loss_load", "overgeneration"])
        spec["action_cols"].append("load")
        spec["cost_cols"].extend(["loss_load", "overgeneration", "co2"])

    def _register_pv(self, spec, size):
        spec["parameters"]["PV_rated_power"] = np.around(size["pv"], 2)
        spec["production_cols"].extend(["pv_consummed", "pv_curtailed"])
        spec["action_cols"].extend(["pv_consummed", "pv_curtailed", "pv"])
        pv = pd.DataFrame(
            self._scale_ts(self._get_pv_ts(), size["pv"], scaling_method="max")
        )
        spec["status"]["pv"] = [np.around(pv.iloc[0].values[0], 1)]
        spec["pv"] = pv

    def _register_battery(self, spec, size):
        battery = self._get_battery(capa=size["battery"])
        params = spec["parameters"]
        params["battery_soc_0"] = battery["soc_0"]
        params["battery_power_charge"] = battery["pcharge"]
        params["battery_power_discharge"] = battery["pdischarge"]
        params["battery_capacity"] = battery["capa"]
        params["battery_efficiency"] = battery["efficiency"]
        params["battery_soc_min"] = battery["soc_min"]
        params["battery_soc_max"] = battery["soc_max"]
        params["battery_cost_cycle"] = battery["cost_cycle"]
        spec["production_cols"].extend(["battery_charge", "battery_discharge"])
        spec["action_cols"].extend(["battery_charge", "battery_discharge"])
        spec["cost_cols"].append("battery")
        spec["status"]["battery_soc"] = [battery["soc_0"]]

        capacity = params["battery_capacity"].values[0]
        efficiency = params["battery_efficiency"].values[0]
        capa_to_charge = max(
            (
                params["battery_soc_max"].values[0] * capacity
                - params["battery_soc_0"].iloc[-1] * capacity
            )
            / efficiency,
            0,
        )
        capa_to_discharge = max(
            (
                params["battery_soc_0"].iloc[-1] * capacity
                - params["battery_soc_min"].values[0] * capacity
            )
            * efficiency,
            0,
        )
        spec["status"]["capa_to_charge"] = [np.around(capa_to_charge, 1)]
        spec["status"]["capa_to_discharge"] = [np.around(capa_to_discharge, 1)]

    def _register_grid(self, spec, size, architecture):
        rand_weak_grid = np.random.randint(low=0, high=2)
        price_scenario = np.random.randint(low=1, high=3)
        if rand_weak_grid == 1:
            architecture["genset"] = 1
        grid = self._get_grid(
            rated_power=size["grid"], weak_grid=rand_weak_grid,
            price_scenario=price_scenario,
        )
        params = spec["parameters"]
        params["grid_weak"] = rand_weak_grid
        params["grid_power_import"] = grid["grid_power_import"]
        params["grid_power_export"] = grid["grid_power_export"]
        spec["grid_ts"] = grid["grid_ts"]
        spec["production_cols"].extend(["grid_import", "grid_export"])
        spec["action_cols"].extend(["grid_import", "grid_export"])
        spec["cost_cols"].extend(["grid_import", "grid_export"])
        spec["status"]["grid_status"] = [grid["grid_ts"].iloc[0, 0]]
        spec["grid_co2"] = self._get_co2_ts()
        spec["status"]["grid_co2"] = [spec["grid_co2"].iloc[0, 0]]

        spec["grid_price_import"] = grid["grid_price_import"]
        spec["grid_price_export"] = grid["grid_price_export"]
        spec["status"]["grid_price_import"] = [grid["grid_price_import"].iloc[0, 0]]
        spec["status"]["grid_price_export"] = [grid["grid_price_export"].iloc[0, 0]]

    def _register_genset(self, spec, size):
        genset = self._get_genset(rated_power=size["genset"])
        params = spec["parameters"]
        params["genset_polynom_order"] = len(genset["polynom"])
        for i, coefficient in enumerate(genset["polynom"]):
            params["genset_polynom_" + str(i)] = coefficient
        params["genset_rated_power"] = genset["rated_power"]
        params["genset_pmin"] = genset["pmin"]
        params["genset_pmax"] = genset["pmax"]
        params["fuel_cost"] = genset["fuel_cost"]
        params["genset_co2"] = genset["co2"]
        spec["production_cols"].append("genset")
        spec["action_cols"].append("genset")
        spec["cost_cols"].append("genset")

    def _create_microgrid(self):
        bin_genset, bin_grid = self._bin_genset_grid()
        architecture = {"PV": 1, "battery": 1, "genset": bin_genset, "grid": bin_grid}
        size_load = self._size_load()
        load = self._scale_ts(self._get_load_ts(), size_load, scaling_method="max")
        size = self._size_mg(load, size_load)

        spec = {
            "parameters": pd.DataFrame(),
            "status": {},
            "action_cols": [],
            "production_cols": [],
            "cost_cols": [],
            "pv": [],
            "grid_ts": [],
            "grid_price_import": [],
            "grid_price_export": [],
            "grid_co2": [],
        }

        self._register_load(spec, size_load, load)
        if architecture["PV"] == 1:
            self._register_pv(spec, size)
        if architecture["battery"] == 1:
            self._register_battery(spec, size)
        if architecture["grid"] == 1:
            self._register_grid(spec, size, architecture)
        if architecture["genset"] == 1:
            self._register_genset(spec, size)

        spec["cost_cols"].append("total_cost")

        record = {
            "parameters": spec["parameters"],
            "df_actions": {key: [] for key in spec["action_cols"]},
            "architecture": architecture,
            "df_status": spec["status"],
            "df_actual_generation": {key: [] for key in spec["production_cols"]},
            "grid_spec": 0,
            "df_cost": {key: [] for key in spec["cost_cols"]},
            "df_co2": {"co2": []},
            "pv": spec["pv"],
            "load": load,
            "grid_ts": spec["grid_ts"],
            "control_dict": spec["action_cols"],
            "grid_price_import": spec["grid_price_import"],
            "grid_price_export": spec["grid_price_export"],
            "grid_co2": spec["grid_co2"],
        }
        return NonModularMicrogrid(record)

    def print_mg_parameters(self, id="all"):
        if id == "all":
            if self.microgrids:
                parameters = pd.concat(
                    [m.parameters for m in self.microgrids], ignore_index=True
                )
                pd.options.display.max_columns = None
                print(parameters)
        elif isinstance(id, int) and id < self.nb_microgrids:
            print(self.microgrids[id].parameters)
