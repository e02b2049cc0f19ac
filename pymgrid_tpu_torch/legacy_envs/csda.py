"""Continuous-state discrete-action legacy env.

Behavioral mirror of ``src/pymgrid/_deprecated/Environments/pymgrid_csda.py``:
a tuple of per-control ``Discrete`` spaces (integer power levels), mapped
through :meth:`Environment.get_action_discrete`.
"""
from pymgrid_tpu_torch.legacy_envs.environment import Environment
from pymgrid_tpu_torch.utils.gym_spaces import Discrete, Tuple

__all__ = ["MicroGridEnv"]


class MicroGridEnv(Environment):
    """Action limits per control (reference pymgrid_csda.py:20-36):
    [pv_max, charge_max, discharge_max, 2(, genset_max)(, import_max,
    export_max, 2)]."""

    def get_action(self, action):
        return self.get_action_discrete(action)

    def _action_limits(self):
        params = self.mg.parameters
        limits = [
            int(self.mg._pv_ts.max().values[0]),
            int(params["battery_power_charge"].values[0]),
            int(params["battery_power_discharge"].values[0]),
            2,
        ]
        if self.mg.architecture["genset"] == 1:
            limits.append(
                int(
                    params["genset_rated_power"].values[0]
                    * params["genset_pmax"].values[0]
                )
            )
        if self.mg.architecture["grid"] == 1:
            limits.append(int(params["grid_power_import"].values[0]))
            limits.append(int(params["grid_power_export"].values[0]))
            limits.append(2)
        return limits

    def __init__(self, env_config, seed=42):
        super().__init__(env_config, seed)
        self.Na = (
            4
            + self.mg.architecture["grid"] * 3
            + self.mg.architecture["genset"] * 1
        )
        self.action_space = Tuple([Discrete(x) for x in self._action_limits()])
