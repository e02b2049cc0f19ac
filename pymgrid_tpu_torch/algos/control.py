"""Control outputs.

Behavioral mirror of ``src/pymgrid/algos/Control.py``: record-frame
containers with cost-based ordering (:class:`ControlOutput`,
:class:`HorizonOutput`), as the host MPC returns them.
"""
from copy import deepcopy
from functools import total_ordering

import numpy as np
import pandas as pd

__all__ = ["HorizonOutput", "ControlOutput"]

_RECORD_NAMES = ("action", "status", "production", "cost", "co2")


@total_ordering
class HorizonOutput:
    """One MPC horizon's control dicts plus the cost over the horizon."""

    def __init__(self, control_dicts, microgrid, current_step):
        self.df = pd.DataFrame(control_dicts)
        self.microgrid = microgrid
        self.current_step = current_step
        self.cost = self.compute_cost_over_horizon(current_step)
        self.first_dict = control_dicts[0]

    def compute_cost_over_horizon(self, current_step):
        mg = self.microgrid
        window = slice(current_step, current_step + mg.horizon)

        # parts fold left-to-right from 0.0 (same float order as a += chain)
        parts = [
            self.df["loss_load"].sum() * mg.parameters["cost_loss_load"].values[0]
        ]
        if mg.architecture["genset"] == 1:
            parts.append(
                self.df["genset"].sum() * mg.parameters["fuel_cost"].values[0]
            )
        if mg.architecture["grid"] == 1:
            buy_price = mg._grid_price_import.iloc[window].values.reshape(-1)
            sell_price = mg._grid_price_export.iloc[window].values.reshape(-1)
            parts.append(
                (buy_price * self.df["grid_import"]).sum()
                - (sell_price * self.df["grid_export"]).sum()
            )
        return sum(parts)

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self.cost == other.cost

    def __lt__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self.cost < other.cost


@total_ordering
class ControlOutput(dict):
    """Dict of record frames keyed ('action', 'status', 'production', 'cost',
    'co2'), ordered by total cost."""

    def __init__(self, names=None, dfs=None, alg_name=None, empty=False, microgrid=None):
        if empty:
            names = _RECORD_NAMES
            dfs = tuple(
                deepcopy(getattr(microgrid, attr))
                for attr in (
                    "_df_record_control_dict",
                    "_df_record_state",
                    "_df_record_actual_production",
                    "_df_record_cost",
                    "_df_record_co2",
                )
            )
        else:
            for arg_name, arg in (("names", names), ("dfs", dfs), ("alg_name", alg_name)):
                if arg is None:
                    raise TypeError(
                        f"{arg_name} cannot be None unless initializing empty and empty=True"
                    )
            if any(needed not in names for needed in _RECORD_NAMES):
                raise ValueError(
                    f"Names must contain {_RECORD_NAMES}, currently contains {names}"
                )

        super().__init__(zip(names, dfs))
        self.alg_name = alg_name
        self.microgrid = microgrid

    def _total_cost(self):
        return np.sum(self["cost"]["total_cost"])

    def append(self, other_output, actual_load=None, actual_pv=None, actual_grid=None,
               slice_to_use=0):
        if isinstance(other_output, ControlOutput):
            for name in self.keys():
                try:
                    incoming = other_output[name]
                except KeyError:
                    raise KeyError(f"name {name} not founds in other_output keys")
                self[name].append(incoming.iloc[slice_to_use], ignore_index=True)
            return

        if not isinstance(other_output, HorizonOutput):
            return

        mg = self.microgrid
        step = other_output.current_step

        action = mg._record_action(other_output.first_dict, self["action"])
        production = mg._record_production(
            other_output.first_dict, self["production"], self["status"]
        )
        last_prod = {key: production[key][-1] for key in production}

        if mg.architecture["grid"] == 1:
            co2 = mg._record_co2(last_prod, self["co2"], mg._grid_co2.iloc[step].values[0])
            status = mg._update_status(
                last_prod, self["status"], actual_load, actual_pv, actual_grid,
                mg._grid_price_import.iloc[step + 1].values[0],
                mg._grid_price_export.iloc[step + 1].values[0],
                mg._grid_co2.iloc[step + 1].values[0],
            )
            cost = mg._record_cost(
                last_prod, self["cost"], co2,
                mg._grid_price_import.iloc[step, 0], mg._grid_price_export.iloc[step, 0],
            )
        else:
            co2 = mg._record_co2(last_prod, self["co2"])
            status = mg._update_status(last_prod, self["status"], actual_load, actual_pv)
            cost = mg._record_cost(last_prod, self["cost"], co2)

        self["action"] = action
        self["production"] = production
        self["cost"] = cost
        self["status"] = status
        self["co2"] = co2

    def to_frame(self):
        flattened = {
            (record, field): values
            for record, frame in self.items()
            for field, values in frame.items()
        }
        longest = max((len(v) for v in flattened.values()), default=0)
        for values in flattened.values():
            if len(values) < longest:
                values.extend([np.nan] * (longest - len(values)))
        return pd.DataFrame(flattened)

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self._total_cost() == other._total_cost()

    def __lt__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self._total_cost() < other._total_cost()

