"""Legacy gym-style environment base over the nonmodular microgrid.

Behavioral mirror of ``src/pymgrid/_deprecated/Environments/Environment.py``:
an MDP over a :class:`~pymgrid_tpu_torch.NonModularMicrogrid` with reward
smoothing, optional SAA resampling on reset, and the three action mappers
(continuous, discrete, priority-list) shared by the concrete envs.

Fixed relative to the reference (which is broken as shipped — it imports the
nonexistent ``pymgrid.Environments`` package and the dead ``np.float``
alias): uses this package's gym-free spaces, and the unused ``get_cost``
helper reads the ``total_cost`` column that actually exists.  The gym API is
the legacy 4-tuple one the reference targets, not gymnasium's 5-tuple.
"""
import numpy as np

from pymgrid_tpu_torch.legacy_envs import preprocessing
from pymgrid_tpu_torch.utils.space import Box

__all__ = ["Environment", "DEFAULT_CONFIG", "generate_sampler"]

DEFAULT_CONFIG = {
    "microgrid": None,  # must be passed by the user
    "training_reward_smoothing": "sqrt",  # or 'peak_load'
    "resampling_on_reset": True,
    "forecast_args": None,  # used to init the SAA for resampling on reset
    "baseline_sampling_args": None,
}


def generate_sampler(microgrid, forecast_args):
    """SAA instance used for resampling on reset (reference lines 35-45)."""
    from pymgrid_tpu_torch.algos.saa import SampleAverageApproximation

    return SampleAverageApproximation(microgrid, **(forecast_args or dict()))


def _control(pv, load, **overrides):
    """A legacy control dict: pv self-consumption plus zeroed channels,
    overridden per action."""
    out = {
        "pv_consummed": min(pv, load),
        "battery_charge": 0,
        "battery_discharge": 0,
        "grid_import": 0,
        "grid_export": 0,
        "genset": 0,
    }
    out.update(overrides)
    return out


class Environment:
    """MDP over a nonmodular microgrid (reference Environment.py:46-240).

    Parameters
    ----------
    env_config : dict
        ``{'microgrid': NonModularMicrogrid, 'training_reward_smoothing':
        'sqrt'|'peak_load', 'resampling_on_reset': bool, 'forecast_args':
        dict, 'baseline_sampling_args': dict, 'testing': bool}``.
    seed : int, default 42
        Seeds the global numpy RNG, as the reference does.
    """

    metadata = {"render.modes": ["human"]}

    def __init__(self, env_config, seed=42):
        np.random.seed(seed)

        self.states_normalization = preprocessing.normalize_environment_states(
            env_config["microgrid"]
        )

        self.TRAIN = True
        self.env_config = env_config
        self.mg = env_config["microgrid"]

        self.mg.train_test_split()
        # +1: transition() replaces 'hour' with (hour_sin, hour_cos)
        self.Ns = len(self.mg._df_record_state.keys()) + 1

        self.training_reward_smoothing = env_config.get(
            "training_reward_smoothing", "sqrt"
        )
        self.resampling_on_reset = env_config.get("resampling_on_reset", False)
        if self.resampling_on_reset:
            self.forecast_args = env_config["forecast_args"]
            self.baseline_sampling_args = env_config["baseline_sampling_args"]
            self.sampling_args = env_config.get("sampling_args")
            self.saa = generate_sampler(self.mg, self.forecast_args)

        self.observation_space = Box(
            low=-1, high=np.inf, shape=(self.Ns,), dtype=np.float64
        )
        self.action_space = None  # set by subclasses

        self.state, self.reward, self.done, self.info = None, None, None, None
        self.round = None

        self.seed()
        self.reset()

        if not self.observation_space.contains(self.state):
            print("ERROR : INVALID STATE", self.state)

    # ------------------------------------------------------------ mdp surface
    def seed(self, seed=None):
        self._np_random = np.random.RandomState(seed)
        return [seed]

    def render(self, mode="human"):
        print(f"state: {self.state} reward: {self.reward} info: {self.info}")

    def states(self):
        return []

    def get_action(self, action):
        """Map an action to a control dict — overridden by subclasses."""
        return []

    def get_reward(self):
        if self.TRAIN:
            if self.training_reward_smoothing == "sqrt":
                return -(self.mg.get_cost() ** 0.5)
            if self.training_reward_smoothing == "peak_load":
                return -self.mg.get_cost() / self.mg.parameters["load"].values[0]
        return -self.mg.get_cost()

    def get_cost(self):
        return sum(self.mg._df_record_cost["total_cost"])

    def transition(self):
        """Normalized state vector with the hour encoded as (sin, cos)."""
        raw = self.mg.get_updated_values()
        scaled = {
            key: float(raw[key]) / self.states_normalization[key]
            for key in self.states_normalization
        }
        # 'hour' was already divided by 24 above
        scaled["hour_sin"] = np.sin(2 * np.pi * scaled["hour"])
        scaled["hour_cos"] = np.cos(2 * np.pi * scaled["hour"])
        scaled.pop("hour", None)
        return np.array(list(scaled.values()))

    def step(self, action):
        if self.done:
            print("WARNING : EPISODE DONE")  # should never reach this point
            return self.state, self.reward, self.done, self.info
        if not self.observation_space.contains(self.state):
            print("ERROR : INVALID STATE", self.state)
        if self.action_space is not None and not self.action_space.contains(action):
            print("ERROR : INVALD ACTION", action)

        self.mg.run(self.get_action(action))

        self.state, self.reward = self.transition(), self.get_reward()
        self.done, self.info = self.mg.done, {}
        self.round += 1

        return self.state, self.reward, self.done, self.info

    def reset(self, testing=False):
        if "testing" in self.env_config:
            testing = self.env_config["testing"]
        self.round = 1
        self.mg.reset(testing=testing)
        if testing:
            self.TRAIN = False
        elif self.resampling_on_reset:
            preprocessing.sample_reset(
                self.mg.architecture["grid"] == 1,
                self.saa,
                self.mg,
                sampling_args=self.sampling_args,
            )

        self.state = self.transition()
        self.reward, self.done, self.info = 0, False, {}
        return self.state

    # ------------------------------------------------- action mappers (shared)
    def get_action_continuous(self, action):
        """6-vector (battery on/off+power, grid on/off+power, genset
        on/off+power) → control dict (reference lines 232-280)."""
        mg = self.mg
        control_dict = {}

        if mg.architecture["battery"] == 1:
            control_dict["battery_charge"] = max(
                0,
                action[0] * min(
                    action[1] * mg.battery.capacity,
                    mg.battery.capa_to_charge,
                    mg.battery.p_charge_max,
                ),
            )
            control_dict["battery_discharge"] = max(
                0,
                (1 - action[0]) * min(
                    action[1] * mg.battery.capacity,
                    mg.battery.capa_to_discharge,
                    mg.battery.p_discharge_max,
                ),
            )

        if mg.architecture["grid"] == 1:
            if mg.grid.status == 1:
                control_dict["grid_import"] = max(
                    0,
                    action[2] * min(action[3] * mg.grid.power_import, mg.grid.power_import),
                )
                control_dict["grid_export"] = max(
                    0,
                    (1 - action[2]) * min(action[3] * mg.grid.power_export, mg.grid.power_export),
                )
            else:
                control_dict["grid_import"] = 0
                control_dict["grid_export"] = 0

        if mg.architecture["genset"] == 1:
            control_dict["genset"] = max(
                0,
                action[4] * min(action[5] * mg.genset.rated_power, mg.genset.rated_power),
            )
        return control_dict

    def get_action_discrete(self, action):
        """Tuple-of-discretes action → control dict (reference lines 282-316)."""
        control_dict = {"pv_consumed": action[0]}
        if self.mg.architecture["battery"] == 1:
            control_dict["battery_charge"] = action[1] * action[3]
            control_dict["battery_discharge"] = action[2] * (1 - action[3])

        if self.mg.architecture["genset"] == 1:
            control_dict["genset"] = action[4]
            if self.mg.architecture["grid"] == 1:
                control_dict["grid_import"] = action[5] * action[7]
                control_dict["grid_export"] = action[6] * (1 - action[7])
        elif self.mg.architecture["grid"] == 1:
            control_dict["grid_import"] = action[4] * action[6]
            control_dict["grid_export"] = action[5] * (1 - action[6])
        return control_dict

    def get_action_priority_list(self, action):
        """Discrete action index → heuristic dispatch (reference lines 318-350)."""
        return self.actions_agent_discret(self.mg, action)

    def actions_agent_discret(self, mg, action):
        if mg.architecture["genset"] == 1 and mg.architecture["grid"] == 1:
            return self.action_grid_genset(mg, action)
        if mg.architecture["genset"] == 1 and mg.architecture["grid"] == 0:
            return self.action_genset(mg, action)
        return self.action_grid(mg, action)

    @staticmethod
    def _battery_dispatch_limits(mg, net_load):
        """(charge-from-pv, charge-from-anywhere, discharge) power limits."""
        charge_pv = max(
            0, min(-net_load, mg.battery.capa_to_charge, mg.battery.p_charge_max)
        )
        charge_any = max(0, min(mg.battery.capa_to_charge, mg.battery.p_charge_max))
        discharge = max(
            0, min(net_load, mg.battery.capa_to_discharge, mg.battery.p_discharge_max)
        )
        return charge_pv, charge_any, discharge

    def action_grid(self, mg, action):
        """Grid-slack dispatch, 5 actions (reference lines 352-420)."""
        pv, load = mg.pv, mg.load
        net_load = load - pv
        charge_pv, charge_any, discharge = self._battery_dispatch_limits(mg, net_load)

        if action == 0:  # charge from pv
            return _control(
                pv, load,
                battery_charge=charge_pv,
                grid_export=max(0, pv - min(pv, load) - charge_pv),
            )
        if action == 4:  # charge from grid
            load = load + charge_any
            return _control(
                pv, load,
                battery_charge=charge_any,
                grid_import=max(0, load - min(pv, load)),
                grid_export=max(0, pv - min(pv, load) - charge_any),
            )
        if action == 1:  # discharge
            return _control(
                pv, load,
                battery_discharge=discharge,
                grid_import=max(0, load - min(pv, load) - discharge),
            )
        if action == 2:  # import
            return _control(pv, load, grid_import=max(0, net_load))
        if action == 3:  # export
            return _control(pv, load, grid_export=abs(min(net_load, 0)))
        raise ValueError(f"invalid action {action}")

    def action_grid_genset(self, mg, action):
        """Grid+genset dispatch, 7 actions (reference lines 422-521)."""
        pv, load = mg.pv, mg.load
        net_load = load - pv
        status = mg.grid.status  # outage indicator
        charge_pv, charge_any, discharge = self._battery_dispatch_limits(mg, net_load)

        if action == 0:  # charge from pv
            return _control(
                pv, load,
                battery_charge=charge_pv,
                grid_export=max(0, pv - min(pv, load) - charge_pv) * status,
            )
        if action == 5:  # charge from grid
            load = load + charge_any
            return _control(
                pv, load,
                battery_charge=charge_any,
                grid_import=max(0, load - min(pv, load)) * status,
                grid_export=max(0, pv - min(pv, load) - charge_any) * status,
            )
        if action == 1:  # discharge
            return _control(
                pv, load,
                battery_discharge=discharge,
                grid_import=max(0, load - min(pv, load) - discharge) * status,
            )
        if action == 2:  # import
            return _control(pv, load, grid_import=max(0, net_load) * status)
        if action == 3:  # export
            return _control(pv, load, grid_export=abs(min(net_load, 0)) * status)
        if action == 4:  # genset covers net load
            return _control(pv, load, genset=max(net_load, 0))
        if action == 6:  # discharge + genset backstop
            return _control(
                pv, load,
                battery_discharge=discharge,
                genset=max(0, load - min(pv, load) - discharge),
            )
        raise ValueError(f"invalid action {action}")

    def action_genset(self, mg, action):
        """Genset-slack dispatch, 3 actions (reference lines 523-583)."""
        pv, load = mg.pv, mg.load
        net_load = load - pv
        charge_pv, _, discharge = self._battery_dispatch_limits(mg, net_load)

        if action == 0:  # charge
            return _control(pv, load, battery_charge=charge_pv)
        if action == 1:  # discharge + genset backstop
            return _control(
                pv, load,
                battery_discharge=discharge,
                genset=max(0, load - min(pv, load) - discharge),
            )
        if action == 2:  # genset only
            return _control(pv, load, genset=max(0, load - min(pv, load)))
        raise ValueError(f"invalid action {action}")
