"""pymgrid_tpu_torch: the PyTorch + CUDA port of the pymgrid_tpu engine.

A user starts at :meth:`Microgrid.from_scenario` (the numpy host layer:
modules, microgrid, forecasters, host envs and controllers, the spec
extraction and the legacy converters, each a copy of its counterpart in
:mod:`pymgrid_tpu` with the same relative path) and hands the microgrid to
the device side: the rule-based-control main path — spec -> step tables ->
engine ``reset``/``step`` -> marginal-cost and priority-list policies -> time
loops -> 25-config suite rollout — on PyTorch tensors, plus a hand-written CUDA
kernel for the fused-horizon RBC sweep (:mod:`pymgrid_tpu_torch.ops`), and
the batched RL envs over the same engine (:mod:`pymgrid_tpu_torch.parallel`)
with state checkpoints (:mod:`pymgrid_tpu_torch.utils.checkpoint`), and the
on-device planners: batched LP solvers (:mod:`pymgrid_tpu_torch.core.lp`)
under ``BatchedMPC``, ``SuiteMPC`` and ``BatchedSAA``
(:mod:`pymgrid_tpu_torch.algos`).

Nothing here imports ``jax`` or any module of :mod:`pymgrid_tpu`; the
scenario data is read from the repository's ``pymgrid_tpu/data`` as files
(:mod:`pymgrid_tpu_torch.paths`).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise if there is no card; the dtype is explicit
(:mod:`pymgrid_tpu_torch._device`): float64 is the parity mode, float32 the
throughput mode.
"""
from pymgrid_tpu_torch._device import resolve_device, torch_dtype
from pymgrid_tpu_torch.microgrid import DEFAULT_HORIZON, Microgrid
from pymgrid_tpu_torch.paths import PROJECT_PATH

__all__ = ["Microgrid", "DEFAULT_HORIZON", "PROJECT_PATH", "resolve_device", "torch_dtype"]
