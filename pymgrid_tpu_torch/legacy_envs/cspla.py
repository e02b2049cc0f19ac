"""Continuous-state priority-list-action legacy env.

Behavioral mirror of
``src/pymgrid/_deprecated/Environments/pymgrid_cspla.py``: a ``Discrete(Na)``
action space where each action is one heuristic dispatch (charge / discharge
/ import / export / genset / ...), mapped through
:meth:`Environment.get_action_priority_list`.
"""
from pymgrid_tpu_torch.legacy_envs.environment import Environment
from pymgrid_tpu_torch.utils.gym_spaces import Discrete

__all__ = ["MicroGridEnv"]


class MicroGridEnv(Environment):
    """Action count: 2 + 3·grid + genset (+1 when both grid and genset),
    reference pymgrid_cspla.py:42-48."""

    def get_action(self, action):
        return self.get_action_priority_list(action)

    def __init__(self, env_config, seed=42):
        super().__init__(env_config, seed)
        architecture = self.mg.architecture
        count = 2 + architecture["grid"] * 3 + architecture["genset"] * 1
        if architecture["grid"] == 1 and architecture["genset"] == 1:
            count += 1
        self.Na = count
        self.action_space = Discrete(self.Na)
