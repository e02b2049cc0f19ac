"""Control outputs and benchmark orchestration.

Behavioral mirror of ``src/pymgrid/algos/Control.py``: record-frame
containers with cost-based ordering (:class:`ControlOutput`,
:class:`HorizonOutput`), as the host MPC returns them, and the
:class:`Benchmarks` runner that orchestrates RBC/MPC/SAA on a microgrid and
prints cost summaries with optional train/test splits.
"""
from copy import deepcopy
from functools import total_ordering

import numpy as np
import pandas as pd

__all__ = ["HorizonOutput", "ControlOutput", "Benchmarks"]

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


class Benchmarks:
    """Run RBC / MPC / SAA benchmarks on a microgrid and summarize costs.

    Works on both modular microgrids (logs from the modular algorithms) and
    legacy nonmodular microgrids (legacy ControlOutputs); the reference's
    version only supported the legacy path.  The modular rule-based run is
    the engine's :meth:`RuleBasedControl.run_compiled`, which runs on the
    card unless ``run_rule_based_benchmark(device="cpu")`` asks for the CPU.
    """

    def __init__(self, microgrid):
        self.microgrid = microgrid
        self.is_modular = hasattr(microgrid, "modules")
        self.outputs_dict = dict()

        self.mpc_output = self.rule_based_output = self.saa_output = None
        self.has_mpc_benchmark = False
        self.has_rule_based_benchmark = False
        self.has_saa_benchmark = False

    def run_mpc_benchmark(self, verbose=False, **kwargs):
        from pymgrid_tpu_torch.algos.mpc import ModelPredictiveControl

        mpc = ModelPredictiveControl(self.microgrid)
        self.mpc_output = mpc.run(verbose=verbose, **kwargs)
        self.has_mpc_benchmark = True
        self.outputs_dict["mpc"] = self.mpc_output

    def run_rule_based_benchmark(self, **kwargs):
        if self.is_modular:
            from pymgrid_tpu_torch.algos.rbc import RuleBasedControl

            self.rule_based_output = RuleBasedControl(self.microgrid).run_compiled(**kwargs)
        else:
            # Legacy path (the reference's only path, Control.py:284-294):
            # NonModularRuleBasedControl returning a ControlOutput.
            from pymgrid_tpu_torch.algos.nonmodular_rbc import NonModularRuleBasedControl

            rbc = NonModularRuleBasedControl(self.microgrid)
            self.rule_based_output = rbc.run_rule_based(**kwargs)
        self.has_rule_based_benchmark = True
        self.outputs_dict["rbc"] = self.rule_based_output

    def run_saa_benchmark(self, preset_to_use=85, **kwargs):
        from pymgrid_tpu_torch.algos.saa import SampleAverageApproximation

        target = self.microgrid.to_nonmodular() if self.is_modular else self.microgrid
        saa = SampleAverageApproximation(target, preset_to_use=preset_to_use)
        self.saa_output = saa.run(**kwargs)
        self.has_saa_benchmark = True
        self.outputs_dict["saa"] = self.saa_output

    def run_benchmarks(self, algo=None, verbose=False, preset_to_use=85, **kwargs):
        if algo == "mpc":
            self.run_mpc_benchmark(verbose=verbose, **kwargs)
        elif algo == "rbc":
            self.run_rule_based_benchmark(**kwargs)
        elif algo == "saa":
            self.run_saa_benchmark(preset_to_use=preset_to_use, **kwargs)
        else:
            self.run_mpc_benchmark(verbose=verbose, **kwargs)
            self.run_rule_based_benchmark(**kwargs)
            self.run_saa_benchmark(preset_to_use=preset_to_use, **kwargs)

        if verbose:
            self.describe_benchmarks()

    def _total_cost_series(self, output):
        if isinstance(output, ControlOutput):
            return np.asarray(output["cost"]["total_cost"])
        # modular log DataFrame: cost = negative balance reward
        return -output[("balance", 0, "reward")].values

    def describe_benchmarks(self, test_split=False, test_ratio=None, test_index=None,
                            algorithms=None):
        possible = ("saa", "mpc", "rbc")
        if algorithms is None:
            algorithms = possible
        elif any(name not in possible for name in algorithms):
            raise ValueError(
                f"Unable to recognize one or multiple of list_of_benchmarks: "
                f"{algorithms}, can only contain {possible}"
            )

        series = {
            name: self._total_cost_series(out)
            for name, out in self.outputs_dict.items()
        }
        if not series:
            print("No benchmarks run.")
            return

        lengths = {len(s) for s in series.values()}
        if len(lengths) > 1:
            raise ValueError("Outputs are of different lengths")
        T = lengths.pop()

        if test_split:
            if test_ratio is None and test_index is None:
                raise ValueError("If test_split, must have either a test_ratio or test_index")
            if test_ratio is not None and test_index is not None:
                raise ValueError("Cannot have both test_ratio and test_split")
            if test_ratio is not None and not 0 <= test_ratio <= 1:
                raise ValueError(f"test_ratio must be in [0,1], is {test_ratio}")
            if test_index is not None and test_index > T:
                raise ValueError("test_index cannot be larger than length of output")

        names = {"mpc": "MPC", "rbc": "rule-based control", "saa": "sample-average MPC control"}

        if not test_split or test_ratio is not None:
            if not test_split:
                test_ratio = 1
            start = int(np.ceil(T * (1 - test_ratio)))
            steps = T - start
            percent = round(test_ratio * 100, 1)
            for name in possible:
                if name in series and name in algorithms:
                    cost = round(np.sum(series[name][start:]), 2)
                    print(
                        f"Cost of the last {steps} steps ({percent} percent of all "
                        f"steps) using {names[name]}: {cost}"
                    )
        else:
            for name in possible:
                if name in series and name in algorithms:
                    cost_train = round(np.sum(series[name][:test_index]), 2)
                    cost_test = round(np.sum(series[name][test_index:]), 2)
                    print(f"Test set cost using {names[name].upper()}: {cost_test}")
                    print(f"Train set cost using {names[name].upper()}: {cost_train}")
