"""Legacy rule-based control on the nonmodular microgrid.

Behavioral mirror of the reference's ``algos/rbc/_nonmodular_rbc.py`` (the
pipeline that produced the published ``pymgrid 25 - benchmarks.xlsx``
numbers): a marginal-cost priority dispatch driven through the nonmodular
record-frame pipeline (``_record_action`` / ``_record_production`` /
``_record_co2`` / ``_update_status`` / ``_record_cost``).

Semantics are kept exactly — including the reference's quirks:

* when load exceeds PV + discharge capacity the genset minimum load is
  reserved up front; if even the minimum exceeds the load, every other
  resource is disabled and the genset ends up producing *twice* its minimum
  (reference ``_nonmodular_rbc.py:95-107`` with the later ``temp_load +
  min_load`` at line 168);
* ``loss_load`` in the control dict is a 0/1 flag, not an energy amount
  (line 170) — ``_record_production`` recomputes the actual shortfall;
* the battery's charge capacity divides by efficiency while discharge
  capacity multiplies (lines 123-133), matching ``update_variables``.
"""
import operator
from copy import deepcopy

from pymgrid_tpu_torch.algos.control import ControlOutput

__all__ = ["NonModularRuleBasedControl"]


class NonModularRuleBasedControl:
    """Rule-based benchmark over a :class:`~pymgrid_tpu_torch.NonModularMicrogrid`.

    Reference: ``src/pymgrid/algos/rbc/_nonmodular_rbc.py:8-287``.
    """

    def __init__(self, microgrid):
        self.microgrid = microgrid

    # ------------------------------------------------------------- priority
    def _generate_priority_list(self, architecture, parameters, grid_status=0,
                                price_import=0, price_export=0):
        """Marginal-cost ordering of the available resources.

        PV always first; with a grid, the battery/grid order depends on
        whether round-trip-discounted export beats import price
        (reference lines 15-46).
        """
        if architecture["grid"] != 1:
            return {
                "PV": 1 * architecture["PV"],
                "battery": 2 * architecture["battery"],
                "grid": 0,
                "genset": 4 * architecture["genset"],
            }

        efficiency = parameters["battery_efficiency"].values[0]
        battery_beats_grid = price_export / (efficiency ** 2) < price_import
        battery_rank, grid_rank = (2, 3) if battery_beats_grid else (3, 2)
        return {
            "PV": 1 * architecture["PV"],
            "battery": battery_rank * architecture["battery"],
            "grid": int(grid_rank * architecture["grid"] * grid_status),
            "genset": 4 * architecture["genset"],
        }

    # ------------------------------------------------------------- dispatch
    @staticmethod
    def _battery_headroom(parameters, soc):
        """(capa_to_charge, capa_to_discharge) with the legacy asymmetry:
        charge capacity divides by efficiency, discharge multiplies."""
        capacity = parameters["battery_capacity"].values[0]
        efficiency = parameters["battery_efficiency"].values[0]
        to_charge = max(
            (parameters["battery_soc_max"].values[0] * capacity - soc * capacity)
            / efficiency,
            0,
        )
        to_discharge = max(
            (soc * capacity - parameters["battery_soc_min"].values[0] * capacity)
            * efficiency,
            0,
        )
        return to_charge, to_discharge

    def _reserve_genset_minimum(self, flow, pv, parameters, status, priority_dict):
        """Reserve the genset minimum up front when PV + battery cannot cover
        the load and the grid is not preferred over the genset.  May replace
        the priority dict with a genset-only one (reference quirk)."""
        capa_to_discharge = max(
            min(
                (status["battery_soc"][-1] * parameters["battery_capacity"].values[0]
                 - parameters["battery_soc_min"].values[0]
                 * parameters["battery_capacity"].values[0])
                * parameters["battery_efficiency"].values[0],
                self.microgrid.battery.p_discharge_max,
            ),
            0,
        )
        grid_first = int(
            self.microgrid.architecture["grid"] == 1
            and priority_dict["grid"] < priority_dict["genset"]
            and priority_dict["grid"] > 0
        )
        if flow["unmet"] > pv + capa_to_discharge and grid_first == 0:
            min_load = (
                self.microgrid.parameters["genset_rated_power"].values[0]
                * self.microgrid.parameters["genset_pmin"].values[0]
            )
            if min_load <= flow["unmet"]:
                flow["unmet"] = flow["unmet"] - min_load
                flow["reserved"] = min_load
            else:
                # Genset minimum alone exceeds the load: genset-only dispatch
                # (and, per the reference, p_genset comes out as 2*min_load).
                flow["unmet"] = min_load
                flow["reserved"] = min_load
                return {"PV": 0, "battery": 0, "grid": 0, "genset": 1}
        return priority_dict

    def _deploy_pv(self, flow, pv):
        self_consumed = min(flow["unmet"], pv)
        flow["unmet"] = max(0, flow["unmet"] - self_consumed)
        flow["surplus"] = pv - self_consumed
        flow["pv_used"] = flow["pv_used"] + pv - flow["surplus"]

    def _deploy_battery(self, flow, parameters, status):
        to_charge, to_discharge = self._battery_headroom(
            parameters, status["battery_soc"][-1]
        )
        if flow["unmet"] > 0:
            flow["discharge"] = max(
                0,
                min(to_discharge,
                    parameters["battery_power_discharge"].values[0],
                    flow["unmet"]),
            )
            flow["unmet"] = flow["unmet"] - flow["discharge"]
        elif flow["surplus"] > 0:
            flow["charge"] = max(
                0,
                min(to_charge,
                    parameters["battery_power_charge"].values[0],
                    flow["surplus"]),
            )
            flow["surplus"] = flow["surplus"] - flow["charge"]
            flow["pv_used"] = flow["pv_used"] + flow["charge"]

    def _deploy_grid(self, flow):
        if flow["unmet"] > 0:
            flow["buy"] = flow["unmet"]
            flow["unmet"] = 0
        elif flow["surplus"] > 0:
            flow["sell"] = flow["surplus"]
            flow["surplus"] = 0
            flow["pv_used"] = flow["pv_used"] + flow["sell"]

    def _deploy_genset(self, flow):
        if flow["unmet"] > 0:
            flow["genset"] = flow["unmet"] + flow["reserved"]
            flow["unmet"] = 0
            flow["reserved"] = 0

    def _run_priority_based(self, load, pv, parameters, status, priority_dict):
        """One step of priority dispatch (reference lines 48-178).

        ``status`` is the record-state frame (dict of lists); the battery SOC
        is read from its last row.
        """
        flow = dict(
            unmet=load, surplus=0, reserved=0,
            charge=0, discharge=0, buy=0, sell=0, genset=0, pv_used=0,
        )

        if self.microgrid.architecture["genset"] == 1:
            priority_dict = self._reserve_genset_minimum(
                flow, pv, parameters, status, priority_dict
            )

        for resource, rank in sorted(priority_dict.items(), key=operator.itemgetter(1)):
            if rank <= 0:
                continue
            if resource == "PV":
                self._deploy_pv(flow, pv)
            elif resource == "battery":
                self._deploy_battery(flow, parameters, status)
            elif resource == "grid":
                self._deploy_grid(flow)
            elif resource == "genset":
                self._deploy_genset(flow)

        return {
            "battery_charge": flow["charge"],
            "battery_discharge": flow["discharge"],
            "genset": flow["genset"],
            "grid_import": flow["buy"],
            "grid_export": flow["sell"],
            "loss_load": 1 if flow["unmet"] > 0 else 0,
            "pv_consummed": flow["pv_used"],
            "pv_curtailed": pv - flow["pv_used"],
            "load": load,
            "pv": pv,
        }

    # ------------------------------------------------------------------ run
    def run_rule_based(self, priority_list=0, length=None, verbose=False):
        """Run the rule-based benchmark over the microgrid's data.

        Drives the record-frame pipeline directly on local copies of the
        frames (reference lines 181-287); the microgrid itself is not
        advanced.  Returns a legacy :class:`ControlOutput`.
        """
        mg = self.microgrid

        action = deepcopy(mg._df_record_control_dict)
        status = deepcopy(mg._df_record_state)
        production = deepcopy(mg._df_record_actual_production)
        cost = deepcopy(mg._df_record_cost)
        co2 = deepcopy(mg._df_record_co2)

        if length is None or length >= mg._data_length:
            length = mg._data_length - 1

        n_steps = length - mg.horizon
        has_grid = mg.architecture["grid"] == 1

        for i in range(n_steps):
            if verbose and (i % max(1, n_steps // 100) == 0 or i == n_steps - 1):
                print(f"\rRBC progress {100 * (i + 1) // n_steps}%",
                      end="" if i < n_steps - 1 else "\n", flush=True)

            if has_grid:
                priority_dict = self._generate_priority_list(
                    mg.architecture, mg.parameters,
                    mg._grid_status_ts.iloc[i].values[0],
                    mg._grid_price_import.iloc[i].values[0],
                    mg._grid_price_export.iloc[i].values[0],
                )
            else:
                priority_dict = self._generate_priority_list(
                    mg.architecture, mg.parameters
                )

            control_dict = self._run_priority_based(
                mg._load_ts.iloc[i].values[0], mg._pv_ts.iloc[i].values[0],
                mg.parameters, status, priority_dict,
            )

            action = mg._record_action(control_dict, action)
            production = mg._record_production(control_dict, production, status)
            last_production = {k: production[k][-1] for k in production}

            if has_grid:
                co2 = mg._record_co2(last_production, co2,
                                     mg._grid_co2.iloc[i].values[0])
                status = mg._update_status(
                    last_production, status,
                    mg._load_ts.iloc[i + 1].values[0],
                    mg._pv_ts.iloc[i + 1].values[0],
                    mg._grid_status_ts.iloc[i + 1].values[0],
                    mg._grid_price_import.iloc[i + 1].values[0],
                    mg._grid_price_export.iloc[i + 1].values[0],
                    mg._grid_co2.iloc[i + 1].values[0],
                )
                cost = mg._record_cost(
                    last_production, cost, co2,
                    mg._grid_price_import.iloc[i, 0],
                    mg._grid_price_export.iloc[i, 0],
                )
            else:
                co2 = mg._record_co2(last_production, co2)
                status = mg._update_status(
                    last_production, status,
                    mg._load_ts.iloc[i + 1].values[0],
                    mg._pv_ts.iloc[i + 1].values[0],
                )
                cost = mg._record_cost(last_production, cost, co2)

        names = ("action", "status", "production", "cost", "co2")
        dfs = (action, status, production, cost, co2)
        return ControlOutput(names, dfs, "rbc")
