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

The host layer also carries the legacy surface of the JAX package: the
nonmodular microgrid and its rule-based control, the host SAA, the
``Benchmarks`` runner, ``MicrogridGenerator``, the legacy gym-style
environments (:mod:`pymgrid_tpu_torch.legacy_envs`) and the gymnasium
adapter; ``envs``, ``MicrogridGenerator``, ``NonModularMicrogrid`` and
``add_pymgrid_yaml_representers`` import lazily from the package, as in
:mod:`pymgrid_tpu`.

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
from pymgrid_tpu_torch.version import __version__

__all__ = ["Microgrid", "DEFAULT_HORIZON", "PROJECT_PATH", "__version__",
           "resolve_device", "torch_dtype"]


def __getattr__(name):
    # Lazy imports keep `import pymgrid_tpu_torch` light and avoid cycles.
    # NOTE: use importlib, not `from pymgrid_tpu_torch import X` — the latter
    # re-enters this __getattr__ before the submodule import starts and
    # recurses forever.
    import importlib

    if name == "envs":
        return importlib.import_module("pymgrid_tpu_torch.envs")
    if name == "MicrogridGenerator":
        return importlib.import_module("pymgrid_tpu_torch.generator").MicrogridGenerator
    if name == "NonModularMicrogrid":
        return importlib.import_module("pymgrid_tpu_torch.nonmodular").NonModularMicrogrid
    if name == "add_pymgrid_yaml_representers":
        return importlib.import_module(
            "pymgrid_tpu_torch.utils.serialize"
        ).add_pymgrid_yaml_representers
    raise AttributeError(f"module 'pymgrid_tpu_torch' has no attribute {name!r}")
