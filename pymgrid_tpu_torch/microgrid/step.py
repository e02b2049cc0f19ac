"""Per-step accumulator for :meth:`Microgrid.run`.

Behavioral mirror of ``src/pymgrid/microgrid/utils/step.py``: observations
merge per module name, rewards accumulate sequentially, ``done`` ORs, and the
two energy lists (``provided_energy`` / ``absorbed_energy``) collect in
append order — the order the compiled engine reproduces for bitwise-equal
balance sums (np.sum's pairwise tree over these lists).
"""
import numpy as np

__all__ = ["MicrogridStep"]

_ENERGY_KEYS = ("absorbed_energy", "provided_energy")


class MicrogridStep:
    def __init__(self, reward_shaping_func=None, cost_info=None):
        self._reward_shaping_func = reward_shaping_func
        self.cost_info = cost_info
        self._merged_obs = {}
        self._reward_sum = 0.0
        self._any_done = False
        self._collected = {key: [] for key in _ENERGY_KEYS}

    def _output_info(self):
        return {
            key: value
            for key, value in self._collected.items()
            if key not in _ENERGY_KEYS
        }

    def shaped_reward(self):
        if self._reward_shaping_func is None:
            return self._reward_sum
        assert isinstance(self.cost_info, dict)
        return self._reward_shaping_func(self._output_info(), self.cost_info)

    def output(self):
        return self._merged_obs, self.shaped_reward(), self._any_done, self._output_info()

    def balance(self):
        provided = np.sum(self._collected["provided_energy"])
        absorbed = np.sum(self._collected["absorbed_energy"])
        return provided, absorbed, self._reward_sum, self.shaped_reward()

    def append(self, module_name, obs, reward, done, info):
        self._merged_obs.setdefault(module_name, []).append(obs)
        self._reward_sum += reward
        self._any_done = self._any_done or bool(done)
        self._collected.setdefault(module_name, []).append(info)
        # harvest any info fields we're already collecting (the energy lists,
        # and — matching the reference — any name collisions)
        for key, value in info.items():
            bucket = self._collected.get(key)
            if bucket is not None:
                bucket.append(value)

    obs = property(lambda self: self._merged_obs)
    reward = property(lambda self: self._reward_sum)
    done = property(lambda self: self._any_done)
    info = property(lambda self: self._collected)
