"""Rule-based control.

Behavioral mirror of ``src/pymgrid/algos/rbc/rbc.py``: deploy modules every
step in a fixed priority order (lowest marginal cost first by default).

``run`` executes on the host layer; ``run_compiled`` executes the identical
policy in the port's engine (:mod:`pymgrid_tpu_torch.core.rollout`),
returning the same log DataFrame.
"""
from copy import deepcopy

from pymgrid_tpu_torch.algos.priority_list import PriorityListAlgo

__all__ = ["RuleBasedControl"]


class RuleBasedControl(PriorityListAlgo):
    # host plumbing for the PriorityListAlgo mixin
    microgrid = property(lambda self: self._microgrid)
    modules = property(lambda self: self._microgrid.modules)
    fixed = property(lambda self: self._microgrid.fixed)
    flex = property(lambda self: self._microgrid.flex)
    priority_list = property(lambda self: self._priority_list)

    def __init__(self, microgrid, priority_list=None, remove_redundant_gensets=True):
        super().__init__()
        self._microgrid = deepcopy(microgrid)
        self._priority_list = self._resolve_priority_list(
            priority_list, remove_redundant_gensets
        )

    def _resolve_priority_list(self, priority_list, remove_redundant_gensets):
        candidates = self.get_priority_lists(
            remove_redundant_gensets=remove_redundant_gensets
        )
        if priority_list is None:
            # cheapest-first deployment order
            return sorted(candidates[0])
        if priority_list not in candidates:
            raise ValueError(
                "Invalid priority list. Use RuleBasedControl.get_priority_lists to "
                "view all valid priority lists."
            )
        return priority_list

    def get_empty_action(self):
        return self._microgrid.get_empty_action()

    def _get_action(self):
        return self._populate_action(self._priority_list)

    def reset(self):
        return self._microgrid.reset()

    def run(self, max_steps=None, verbose=False):
        """Host-layer RBC rollout; returns the microgrid log DataFrame."""
        if max_steps is None:
            max_steps = len(self.microgrid)

        self.reset()

        steps = range(max_steps)
        if verbose:
            try:
                from tqdm import tqdm

                steps = tqdm(steps, desc="RBC Progress")
            except ImportError:
                pass

        for _ in steps:
            _, _, done, _ = self._microgrid.run(self._get_action(), normalized=False)
            if done:
                break

        return self._microgrid.get_log(as_frame=True)

    def run_compiled(self, max_steps=None, dtype="float64", device="cuda",
                     numpy_rng_noise=False):
        """Engine RBC rollout; returns the log DataFrame.

        Bitwise-equal to :meth:`run` in float64 on the CPU and on the card
        (``tests/test_torch_rollout.py``, ``chip_smoke.py``).
        """
        from pymgrid_tpu_torch.core.compiled import CompiledMicrogrid
        from pymgrid_tpu_torch.core.rollout import make_priority_policy, make_rollout_fn

        microgrid = self._microgrid
        if max_steps is None:
            max_steps = len(microgrid)
        max_steps = min(
            max_steps, int(microgrid.final_step) - int(microgrid.initial_step)
        )
        compiled = CompiledMicrogrid(
            microgrid, dtype=dtype, device=device, numpy_rng_noise=numpy_rng_noise
        )
        policy = make_priority_policy(compiled.spec, self._priority_list)
        rollout = make_rollout_fn(compiled.spec, policy, max_steps)
        _, outputs = rollout(compiled.params, compiled.reset())
        return compiled.log_frame(outputs.log_row)
