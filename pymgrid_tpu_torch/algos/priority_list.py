"""Priority-list machinery shared by RBC and the discrete env.

Behavioral mirror of ``src/pymgrid/algos/priority_list/``: a priority list is
an ordering of the controllable source elements (gensets contribute one
element per goal status); populating an action walks the list, deploying each
module against the remaining net load.
"""
from dataclasses import dataclass
from functools import total_ordering
from itertools import chain, permutations
from typing import Optional, Tuple

import numpy as np

__all__ = ["PriorityListElement", "PriorityListAlgo"]


@total_ordering
@dataclass(frozen=True)
class PriorityListElement:
    """A module's position in a deployment order.

    Ordering is by marginal cost, ties broken by larger ``action``
    (status=on first); see reference ``priority_list_element.py:62-80``.
    """

    module: Tuple[str, int]
    module_actions: int
    action: int
    marginal_cost: Optional[float] = None

    def _key(self):
        return (self.module, self.module_actions, self.action, self.marginal_cost)

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return self._key() == other._key()

    def __lt__(self, other):
        if type(self) != type(other) or self.marginal_cost is None or other.marginal_cost is None:
            return NotImplemented
        # cheaper first; on a cost tie, the larger action (status=on) first
        return (self.marginal_cost, -self.action) < (other.marginal_cost, -other.action)


class PriorityListAlgo:
    """Mixin implementing priority-list enumeration and action population."""

    # ----------------------------------------------------------- enumeration
    def _source_elements(self):
        deployable = chain(
            self.modules.controllable.sources.iterlist(),
            self.modules.controllable.source_and_sinks.iterlist(),
        )
        for module in deployable:
            n_module_actions = module.action_space.shape[0]
            for action in range(n_module_actions):
                yield PriorityListElement(
                    module.name, n_module_actions, action, module.marginal_cost
                )

    def get_priority_lists(self, remove_redundant_gensets):
        return self._remove_redundant_actions(
            permutations(self._source_elements()), gensets=remove_redundant_gensets
        )

    def _remove_redundant_actions(self, priority_lists, gensets=False):
        deduped_lists = []
        for candidate in priority_lists:
            seen_modules, kept = set(), []
            for element in candidate:
                if element.module not in seen_modules:
                    seen_modules.add(element.module)
                    kept.append(element)
            deduped_lists.append(tuple(kept))

        unique = list(dict.fromkeys(deduped_lists))
        if gensets:
            unique = self._remove_redundant_gensets(unique)
        return unique

    def _remove_redundant_gensets(self, priority_lists):
        """Drop lists containing a genset-off element when the genset's
        minimum production is zero (the off action is then redundant)."""
        from pymgrid_tpu_torch.modules import GensetModule

        off_elements = [
            PriorityListElement(
                module=(name, position),
                module_actions=2,
                action=0,
                marginal_cost=module.marginal_cost,
            )
            for name, module_list in self.modules.iterdict()
            for position, module in enumerate(module_list)
            if isinstance(module, GensetModule) and module.running_min_production == 0
        ]
        return [
            pl for pl in priority_lists if not any(el in pl for el in off_elements)
        ]

    # ------------------------------------------------------------ population
    def _get_load(self):
        per_sink, total = dict(), 0.0
        for fixed_sink in self.fixed.sinks.iterlist():
            per_sink[fixed_sink.name] = fixed_sink.max_consumption
            total += fixed_sink.max_consumption
        return per_sink, total

    def _get_renewable(self):
        return np.sum(
            [flex_source.max_production for flex_source in self.flex.sources.iterlist()]
        )

    def _produce_from_module(self, module_action_number, module_to_deploy, remaining_load):
        try:
            hi = module_to_deploy.next_max_production(module_action_number)
            lo = module_to_deploy.next_min_production(module_action_number)
        except AttributeError:
            hi = module_to_deploy.max_production
            lo = module_to_deploy.min_production

        if lo <= remaining_load <= hi:
            production = remaining_load
        elif remaining_load < lo:
            production = lo
        else:
            production = hi
        assert production >= 0
        return production

    def _consume_in_module(self, module_to_deploy, remaining_load):
        assert remaining_load <= 0.0
        if not module_to_deploy.is_sink:
            return 0.0
        capacity = module_to_deploy.max_consumption
        assert capacity >= 0
        if -1 * remaining_load > capacity:
            consumption = -1.0 * capacity
        else:
            consumption = remaining_load
        assert consumption <= 0
        return consumption

    def _populate_action(self, priority_list):
        action = self.get_empty_action()
        _, total_load = self._get_load()
        renewable = self._get_renewable()
        assert total_load >= 0 and renewable >= 0

        residual = (total_load - renewable).item()

        for element in priority_list:
            name, position = element.module
            module_to_deploy = self.modules[name][position]
            multi_action = element.module_actions > 1

            if multi_action:
                if action[name][position] is not None:
                    continue  # this module was already deployed by another element
                action[name][position] = [element.action]

            if np.isclose(residual, 0.0, atol=1e-4):
                energy = 0.0
            elif residual > 0:
                energy = self._produce_from_module(
                    element.action, module_to_deploy, residual
                )
            else:
                energy = self._consume_in_module(module_to_deploy, residual)

            slot = action[name][position]
            if hasattr(slot, "append"):
                slot.append(energy)
            else:
                action[name][position] = energy

            residual -= energy

            if multi_action:
                action[name][position] = np.array(action[name][position])

        unfilled = [k for k, v in action.items() if v is None]
        if unfilled:
            raise RuntimeError(
                f"None values found in action, corresponding to keys\n\t{unfilled}"
            )
        return action

    # implemented by hosts (env / RBC)
    @property
    def modules(self):
        raise NotImplementedError

    @property
    def fixed(self):
        raise NotImplementedError

    @property
    def flex(self):
        raise NotImplementedError

    def get_empty_action(self):
        raise NotImplementedError
