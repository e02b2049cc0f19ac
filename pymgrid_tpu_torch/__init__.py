"""pymgrid_tpu_torch: the PyTorch + CUDA port of the pymgrid_tpu engine.

It runs the rule-based-control main path — scenario -> spec -> step tables ->
engine ``reset``/``step`` -> marginal-cost and priority-list policies -> time
loops -> 25-config suite rollout — on PyTorch tensors, plus a hand-written CUDA
kernel for the fused-horizon RBC sweep (:mod:`pymgrid_tpu_torch.ops`), and
the batched RL envs over the same engine (:mod:`pymgrid_tpu_torch.parallel`)
with state checkpoints (:mod:`pymgrid_tpu_torch.utils.checkpoint`).

The numpy host layer of :mod:`pymgrid_tpu` (``Microgrid``, ``extract_spec``,
``physics``, ``numpy_sum_compat``, the table layouts, ``normalize_to_superset``
and the host ``RuleBasedControl``) is imported, not copied.  Nothing here
imports ``jax``.

Device and dtype are explicit on every public entry
(:mod:`pymgrid_tpu_torch._device`): float64 is the parity mode, float32 the
throughput mode.
"""
from pymgrid_tpu_torch._device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
