"""Continuous environment.

The reference's continuous env (``src/pymgrid/envs/continuous/continuous.py``)
builds its action space from *fixed source* modules — a vestige of pre-1.0
module types.  With v1.2.2 types (battery/genset/grid are ``controllable``)
that space is empty and its ``step`` crashes before reaching the dispatch, so
it cannot run on any standard microgrid.

This implementation realizes what the reference docstring describes: the
action space is the dict of the *controllable* modules' normalized action
boxes (flattened to a single Box when ``flat_spaces``), and ``step`` passes
the normalized action to :meth:`Microgrid.run`.  Documented deviation from
the broken reference behavior.
"""
import numpy as np

from pymgrid_tpu_torch.envs.base import BaseMicrogridEnv
from pymgrid_tpu_torch.utils.gym_spaces import Dict, Tuple, flatten_space

__all__ = ["ContinuousMicrogridEnv"]


class ContinuousMicrogridEnv(BaseMicrogridEnv):
    _nested_action_space = None

    def _get_nested_action_space(self):
        return Dict(
            {
                name: Tuple(
                    [module.action_space["normalized"] for module in modules_list]
                )
                for name, modules_list in self.controllable.iterdict()
                if modules_list[0].action_space.shape[0]
            }
        )

    def _get_action_space(self, remove_redundant_actions=False):
        self._nested_action_space = self._get_nested_action_space()
        return (
            flatten_space(self._nested_action_space)
            if self._flat_spaces
            else self._nested_action_space
        )

    def _get_action(self, action):
        """Accept a flat array (``flat_spaces``) or a nested dict action."""
        if self._flat_spaces and not isinstance(action, dict):
            flat = np.asarray(action, dtype=np.float64).reshape(-1)
            out, i = {}, 0
            for name, tup in self._nested_action_space.items():
                entries = []
                for box in tup:
                    width = box.shape[0]
                    entry = flat[i : i + width]
                    entries.append(entry if width > 1 else float(entry[0]))
                    i += width
                out[name] = entries
            if i != flat.size:
                raise ValueError(
                    f"Flat action of length {flat.size} does not match action "
                    f"space of size {i}."
                )
            return out
        action = dict(action)
        for name, tup in self._nested_action_space.items():
            if name not in action:
                raise ValueError(f"Missing action for module {name}.")
        return action

    def step(self, action):
        action = self._get_action(action)
        return super().step(action, normalized=True)

    def sample_action(self, *args, **kwargs):
        if self._flat_spaces:
            return self.action_space.sample()
        return self._nested_action_space.sample()

    def run(self, action, normalized=True):
        from warnings import warn

        warn("run() should not be called directly in environments.")
        return super().run(action, normalized=normalized)
