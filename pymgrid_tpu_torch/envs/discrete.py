"""Discrete environment: priority lists as actions.

Behavioral mirror of ``src/pymgrid/envs/discrete/discrete.py``: each action
index selects a priority list (a deployment order of the controllable
modules) which is populated into a concrete control each step.
"""
from warnings import warn

from pymgrid_tpu_torch.algos.priority_list import PriorityListAlgo
from pymgrid_tpu_torch.envs.base import BaseMicrogridEnv
from pymgrid_tpu_torch.utils.gym_spaces import Discrete
from pymgrid_tpu_torch.utils.serialize import PymgridDumper, PymgridLoader

__all__ = ["DiscreteMicrogridEnv"]


class DiscreteMicrogridEnv(BaseMicrogridEnv, PriorityListAlgo):
    yaml_tag = "!DiscreteMicrogridEnv"
    yaml_loader = PymgridLoader
    yaml_dumper = PymgridDumper

    def step(self, action):
        self._microgrid_logger.log(action=action)
        return super().step(self._get_action(action), normalized=False)

    def _get_action(self, action_num):
        if action_num not in self.action_space:
            raise ValueError(
                f" Action {action_num} not in action space {self.action_space}"
            )
        return self._populate_action(list(self.actions_list[action_num]))

    def sample_action(self, strict_bound=False, sample_flex_modules=False):
        return self.action_space.sample()

    def remove_action(self, action_number):
        if action_number not in self.action_space:
            raise ValueError("Cannot remove action that is not in the action space!")
        self.actions_list.pop(action_number)
        self.action_space = Discrete(self.action_space.n - 1)

    def _get_action_space(self, remove_redundant_gensets=False):
        priority_lists = self.get_priority_lists(remove_redundant_gensets)
        n_actions = len(priority_lists)
        if n_actions > 1000:
            warn(
                f"Microgrid with {len(priority_lists[0])} fixed source modules "
                f"defines large action space with {n_actions} elements."
            )
        return Discrete(n_actions), priority_lists

    def compiled_env(self, batch_size=1, dtype="float64", device="cuda", **kwargs):
        """A :class:`~pymgrid_tpu_torch.parallel.BatchedDiscreteEnv` over this config."""
        from pymgrid_tpu_torch.parallel.batched_env import BatchedDiscreteEnv

        return BatchedDiscreteEnv(self, batch_size, dtype, device, **kwargs)

    def __init__(
        self,
        modules,
        add_unbalanced_module=True,
        loss_load_cost=10,
        overgeneration_cost=2,
        reward_shaping_func=None,
        trajectory_func=None,
        flat_spaces=True,
        observation_keys=None,
        remove_redundant_gensets=True,
    ):
        super().__init__(
            modules,
            add_unbalanced_module=add_unbalanced_module,
            loss_load_cost=loss_load_cost,
            overgeneration_cost=overgeneration_cost,
            reward_shaping_func=reward_shaping_func,
            trajectory_func=trajectory_func,
            flat_spaces=flat_spaces,
            observation_keys=observation_keys,
        )
        self.action_space, self.actions_list = self._get_action_space(
            remove_redundant_gensets
        )

    def __repr__(self):
        return f"DiscreteMicrogridEnv({super().__repr__()}"

    def __str__(self):
        return self.__repr__()
