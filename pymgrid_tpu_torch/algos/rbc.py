"""Rule-based control on the torch engine.

:class:`RuleBasedControl` is the host :class:`pymgrid_tpu.algos.RuleBasedControl`
(same priority list, same host ``run``) with ``run_compiled`` running the
identical policy in the port's engine.  It returns the same log DataFrame.
"""
from pymgrid_tpu.algos.rbc import RuleBasedControl as _HostRuleBasedControl

__all__ = ["RuleBasedControl"]


class RuleBasedControl(_HostRuleBasedControl):
    def run_compiled(self, max_steps=None, dtype="float64", *, device,
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
