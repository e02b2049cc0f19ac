"""Base RL environment.

Behavioral mirror of ``src/pymgrid/envs/base/base.py``: an environment is a
:class:`~pymgrid_tpu_torch.microgrid.Microgrid` with gym-style
``reset``/``step``/spaces.  Observation spaces are per-module normalized
boxes, optionally filtered by state-dict key names and flattened.

The constructor accepts a module list, a ``Microgrid`` /
``NonModularMicrogrid`` instance, or a pymgrid25 scenario number (the
reference's ``__new__`` dispatch).
"""
from pymgrid_tpu_torch.microgrid import Microgrid
from pymgrid_tpu_torch.utils.space import Box
from pymgrid_tpu_torch.utils.gym_spaces import Dict, Tuple, flatten, flatten_space

__all__ = ["BaseMicrogridEnv", "skip_init"]


def skip_init(cls, init):
    """One-shot ``__init__`` suppressor for the ``__new__`` dispatch
    (reference ``envs/base/skip_init.py``)."""

    def wrapper(self, *args, **kwargs):
        cls.__init__ = init
        return None

    return wrapper


class BaseMicrogridEnv(Microgrid):
    action_space = None
    observation_space = None

    # ------------------------------------------------------- constructors
    @classmethod
    def from_microgrid(cls, microgrid, **kwargs):
        if not hasattr(microgrid, "modules"):
            from pymgrid_tpu_torch.nonmodular import NonModularMicrogrid

            assert isinstance(microgrid, NonModularMicrogrid)
            return cls.from_nonmodular(microgrid, **kwargs)

        forwarded = kwargs.copy()
        forwarded.setdefault("add_unbalanced_module", False)
        forwarded.setdefault("reward_shaping_func", microgrid.reward_shaping_func)
        forwarded.setdefault("trajectory_func", microgrid.trajectory_func)
        return cls(microgrid.modules.to_tuples(), **forwarded)

    @classmethod
    def from_nonmodular(cls, nonmodular, **kwargs):
        return cls.from_microgrid(super().from_nonmodular(nonmodular), **kwargs)

    @classmethod
    def from_scenario(cls, microgrid_number=0, **kwargs):
        env = super().from_scenario(microgrid_number=microgrid_number)
        if kwargs:
            return cls.from_microgrid(env, **kwargs)
        return env

    @classmethod
    def load(cls, stream):
        return cls(super().load(stream))

    def __new__(cls, modules, *args, **kwargs):
        from pymgrid_tpu_torch.nonmodular import NonModularMicrogrid

        if isinstance(modules, int):
            dispatch = cls.from_scenario
        elif isinstance(modules, (NonModularMicrogrid, Microgrid)):
            dispatch = cls.from_microgrid
        else:
            return super().__new__(cls)

        # an alternate constructor built the instance; suppress the __init__
        # call Python makes next (one-shot, reference envs/base/skip_init.py)
        instance = dispatch(modules, **kwargs)
        cls.__init__ = skip_init(cls, cls.__init__)
        return instance

    def __init__(
        self,
        modules,
        add_unbalanced_module=True,
        loss_load_cost=10,
        overgeneration_cost=2,
        reward_shaping_func=None,
        trajectory_func=None,
        flat_spaces=True,
        observation_keys=(),
    ):
        super().__init__(
            modules,
            add_unbalanced_module=add_unbalanced_module,
            loss_load_cost=loss_load_cost,
            overgeneration_cost=overgeneration_cost,
            reward_shaping_func=reward_shaping_func,
            trajectory_func=trajectory_func,
        )

        self._flat_spaces = flat_spaces
        self.observation_keys = self._validate_observation_keys(observation_keys)

        self.action_space = self._get_action_space()
        self.observation_space, self._nested_observation_space = (
            self._get_observation_space()
        )

    # ------------------------------------------------------------- spaces
    def _validate_observation_keys(self, keys):
        if not keys:
            return keys
        if isinstance(keys, str):
            keys = [keys]

        known = self.state_series().index.get_level_values(-1).unique()
        unknown = [key for key in keys if key not in known]
        if unknown:
            raise NameError(f"Keys {unknown} not found in state.")
        return keys

    def _get_action_space(self, remove_redundant_actions=False):
        raise NotImplementedError

    def _filtered_obs_box(self, normalized_space, per_module_state):
        """Box over the observation keys present in this module's state."""
        index = per_module_state.index
        locs = [
            index.get_loc(key) for key in self.observation_keys if key in index
        ]
        if not locs:
            return None
        return Box(
            normalized_space.low[locs],
            normalized_space.high[locs],
            shape=(len(locs),),
        )

    def _get_observation_space(self):
        per_name = {}
        state_series = self.state_series()

        for name, module_list in self.modules.iterdict():
            boxes = []
            for module_num, module in enumerate(module_list):
                normalized_space = module.observation_space["normalized"]

                if not self.observation_keys:
                    boxes.append(normalized_space)
                    continue
                try:
                    per_module_state = state_series.loc[(name, module_num)]
                except KeyError:
                    continue
                box = self._filtered_obs_box(normalized_space, per_module_state)
                if box is not None:
                    boxes.append(box)
            if boxes:
                per_name[name] = Tuple(boxes)

        nested = Dict(per_name)
        flat_or_nested = flatten_space(nested) if self._flat_spaces else nested
        return flat_or_nested, nested

    # -------------------------------------------------------- gym surface
    def reset(self):
        return self._get_obs(super().reset())

    def step(self, action, normalized=True):
        obs, reward, done, info = self.run(action, normalized=normalized)
        return self._get_obs(obs), reward, done, info

    def _get_obs(self, obs):
        import pandas as pd

        if self.observation_keys:
            key_slice = pd.IndexSlice[:, :, self.observation_keys]
            selected = self.state_series(normalized=True).loc[key_slice]
            if self._flat_spaces:
                return selected.values
            by_module = selected.to_frame().unstack(level=1)
            return by_module.T.droplevel(level=1, axis=1).to_dict(orient="list")
        if self._flat_spaces:
            known_spaces = self._nested_observation_space.spaces
            kept = {k: v for k, v in obs.items() if k in known_spaces}
            return flatten(self._nested_observation_space, kept)
        return obs

    def render(self, mode="human"):
        raise NotImplementedError

    @property
    def unwrapped(self):
        return self

    @property
    def flat_spaces(self):
        return self._flat_spaces
