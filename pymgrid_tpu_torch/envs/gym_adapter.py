"""Gymnasium adapters.

The pymgrid-compatible envs return the classic 4-tuple
``(obs, reward, done, info)``; these wrappers expose them through the modern
gymnasium API (5-tuple, ``reset(seed=...) -> (obs, info)``, real gymnasium
spaces) for use with current RL libraries.
"""
import numpy as np

__all__ = ["GymnasiumWrapper"]


class GymnasiumWrapper:
    """Wrap a pymgrid_tpu_torch env (discrete or continuous) as a gymnasium.Env."""

    metadata = {"render_modes": []}

    def __init__(self, env):
        import gymnasium

        self.env = env
        self.observation_space = self._convert_space(env.observation_space, gymnasium)
        self.action_space = self._convert_space(env.action_space, gymnasium)
        self._gymnasium = gymnasium

    @staticmethod
    def _convert_space(space, gymnasium):
        from pymgrid_tpu_torch.utils.gym_spaces import Discrete as OurDiscrete
        from pymgrid_tpu_torch.utils.space import Box as OurBox

        if isinstance(space, OurDiscrete):
            return gymnasium.spaces.Discrete(space.n)
        if isinstance(space, OurBox):
            return gymnasium.spaces.Box(
                low=space.low.astype(np.float64),
                high=space.high.astype(np.float64),
                dtype=np.float64,
            )
        raise TypeError(f"Cannot convert space {space!r} to gymnasium")

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            np.random.seed(seed)
        obs = self.env.reset()
        return np.asarray(obs, dtype=np.float64), {}

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        # episode end at the data horizon is a termination in this MDP
        return np.asarray(obs, dtype=np.float64), float(reward), bool(done), False, info

    def render(self):
        raise NotImplementedError

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self.env
